"""PyTorch port, CUDA kernels on the card: each kernel against its plain
PyTorch version on the same CUDA tensors, the launch counters, and the
argument checks that refuse what the kernels do not take.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels are CUDA C++ with no
CPU mode) and skip elsewhere. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: |kernel - plain| <= 1.6e-2 * (1 + |plain|), a few bf16 ulps: both
round at the same points, but sum in other orders, and the attention
kernels' online softmax rounds the unnormalised P to bf16. The training
attention's gradients are held to the same bound: the kernels round dS to
bf16 before the dq / dk products, which the plain version does not.
"""

import pytest
import torch

from eraxvif5tts_tpu_torch.ops import fused_matmul as fm
from eraxvif5tts_tpu_torch.ops import serving_attention as sa
from eraxvif5tts_tpu_torch.ops import train_attention as ta
from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask
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


@pytest.mark.parametrize("n", [64, 320, 1024])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_train_attention_kernels_match_plain(cuda, n, dropout):
    g = torch.Generator(device=cuda).manual_seed(n)
    q, k, v, dout = (torch.randn((2, n, 4, 64), generator=g, device=cuda).bfloat16()
                     for _ in range(4))
    mask = lens_to_mask(torch.tensor([0, n - 21], device=cuda), n)
    counters = (ta.flash_forward, ta.flash_dq, ta.flash_dkv)
    before = [fn.launches for fn in counters]
    results = []
    for fn in (ta.train_attention, None):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        if fn is None:
            out = ta.train_attention_reference(*args, mask.sum(-1), dropout, seed=0xC0FFEE)
        else:
            out = fn(*args, key_valid=mask, dropout_rate=dropout, seed=0xC0FFEE)
        results.append([out, *torch.autograd.grad(out, args, dout)])
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1, 1, 1]
    for got, want in zip(*results):
        assert torch.isfinite(got).all()
        _assert_close(got, want)
    # the mask depends only on (seed, positions): a second call repeats the first
    again = ta.train_attention(q, k, v, key_valid=mask, dropout_rate=dropout, seed=0xC0FFEE)
    assert torch.equal(again, results[0][0].detach())


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
    with pytest.raises(TypeError):
        ta.train_attention(q, q, q)
    with pytest.raises(ValueError):
        ta.train_attention(qb, qb, qb)
