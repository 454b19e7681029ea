"""PyTorch port, CUDA kernels on the card: each kernel against its plain
PyTorch version on the same CUDA tensors, the launch counters, and the
argument checks that refuse what the kernels do not take.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels are CUDA C++ with no
CPU mode) and skip elsewhere. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: |kernel - plain| <= 1.6e-2 * (1 + |plain|), a few bf16 ulps: both
round at the same points, but sum in other orders, and the attention
kernel's online softmax rounds the unnormalised P to bf16.
"""

import pytest
import torch

from eraxvif5tts_tpu_torch.ops import fused_matmul as fm
from eraxvif5tts_tpu_torch.ops import serving_attention as sa
from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs

pytestmark = pytest.mark.cuda
TOL = 1.6e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _assert_close(got, want):
    err = (got.float() - want.float()).abs()
    assert torch.all(err <= TOL * (1 + want.float().abs())), float(err.max())


@pytest.mark.parametrize("n", [64, 320, 1088])
def test_serving_attention_kernel_matches_plain(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    q, k, v = (torch.randn((2, n, 4, 64), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    lens = torch.tensor([0, n - 21], device=cuda)
    rope = rotary_freqs(n, 64, device=cuda)
    before = sa.serving_attention.launches
    got = sa.serving_attention(q, k, v, lens, rope)
    torch.cuda.synchronize()
    assert sa.serving_attention.launches == before + 1
    assert torch.isfinite(got).all()
    _assert_close(got, sa.serving_attention_reference(q, k, v, lens, rope))
    _assert_close(sa.serving_attention(q, k, v), sa.serving_attention_reference(q, k, v))


@pytest.mark.parametrize("m", [72, 256])
@pytest.mark.parametrize("activation", [None, "gelu_tanh"])
def test_ln_mod_matmul_kernel_matches_plain(cuda, m, activation):
    g = torch.Generator(device=cuda).manual_seed(m)
    x = (torch.randn((2, m, 256), generator=g, device=cuda) + 0.5).bfloat16()
    scale, shift = (0.1 * torch.randn((2, 256), generator=g, device=cuda)).bfloat16(), \
        (0.1 * torch.randn((2, 256), generator=g, device=cuda)).bfloat16()
    w = (torch.randn((512, 256), generator=g, device=cuda) / 16).bfloat16()
    bias = (0.1 * torch.randn((512,), generator=g, device=cuda)).bfloat16()
    before = fm.ln_mod_matmul.launches
    got = fm.ln_mod_matmul(x, scale, shift, w, bias, activation=activation)
    torch.cuda.synchronize()
    assert fm.ln_mod_matmul.launches == before + 1
    _assert_close(got, fm.ln_mod_matmul_reference(x, scale, shift, w, bias, activation))


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 128, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        sa.serving_attention(q, q, q)
    qb = torch.zeros((1, 100, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        sa.serving_attention(qb, qb, qb)
    x = torch.zeros((1, 8, 64), device=cuda, dtype=torch.bfloat16)
    s = torch.zeros((1, 64), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((96, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fm.ln_mod_matmul(x, s, s, w, torch.zeros(96, device=cuda, dtype=torch.bfloat16))
