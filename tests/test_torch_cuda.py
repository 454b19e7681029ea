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
bf16 before the dq / dk products, which the plain version does not. The int8
feed-forward sums exactly (int32) and rounds at the plain version's points
in IEEE fp32, so it is held tighter, in units of its output's scale
(INT8_FF_TOL), and at most 1e-5 of its hidden codes may differ, each by one
(measured on an H100: none; a scale computed as a product with the
reciprocal instead of a true division flipped 6e-4).
"""

import pytest
import torch

from eraxvif5tts_tpu_torch.models.modules import FeedForward
from eraxvif5tts_tpu_torch.ops import fused_matmul as fm
from eraxvif5tts_tpu_torch.ops import quant, quant_ff
from eraxvif5tts_tpu_torch.ops import serving_attention as sa
from eraxvif5tts_tpu_torch.ops import train_attention as ta
from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask
from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs

pytestmark = pytest.mark.cuda
TOL = 1.6e-2
INT8_FF_TOL = 1e-2


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


def test_quantize_rows_on_the_card_is_bit_identical_to_the_cpu(cuda):
    """Per-row int8 scales and codes on the card as on the CPU (and in JAX):
    ``max(amax, 1e-8) / 127`` is a true division, not a product with the
    reciprocal, and bf16 rows hit exact ties of ``x / scale``."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((4096, 1024), generator=g, device=cuda).bfloat16().float()
    codes, scale = quant.quantize_rows(x)
    want_codes, want_scale = quant.quantize_rows(x.cpu())
    assert torch.equal(scale.cpu(), want_scale)
    assert torch.equal(codes.cpu(), want_codes)


def _int8_ff_operands(g, dev, b, m, k, n, k2):
    x = torch.randn((b, m, k), generator=g, device=dev).bfloat16()
    w1_q, s1 = quant.quantize_weight(torch.randn((n, k), generator=g, device=dev) / 32)
    w2_q, s2 = quant.quantize_weight(torch.randn((k2, n), generator=g, device=dev) / 32)
    b1, b2 = (0.1 * torch.randn((d,), generator=g, device=dev) for d in (n, k2))
    return x, w1_q, s1, b1, w2_q, s2, b2


@pytest.mark.parametrize("m", [72, 256])
def test_int8_ff_kernel_matches_plain(cuda, m):
    g = torch.Generator(device=cuda).manual_seed(m)
    args = _int8_ff_operands(g, cuda, 2, m, 512, 1024, 512)
    codes = torch.empty((2, m, 1024), dtype=torch.int8, device=cuda)
    before = quant_ff.int8_ff.launches
    got = quant_ff.int8_ff(*args, h_codes=codes)
    torch.cuda.synchronize()
    assert quant_ff.int8_ff.launches == before + 1
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    want = quant_ff.int8_ff_reference(*args)
    assert float((got.float() - want.float()).abs().max()) <= INT8_FF_TOL * float(
        want.float().abs().max())
    diff = (codes.int() - quant_ff.hidden_codes(*args[:4])[0].int()).abs()
    assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= codes.numel() // 100_000


@pytest.mark.parametrize("m", [72, 256])
@pytest.mark.parametrize("mask_rows", [False, True])
def test_matmul_gate_res_kernel_matches_plain(cuda, m, mask_rows):
    g = torch.Generator(device=cuda).manual_seed(m)
    h = torch.randn((2, m, 512), generator=g, device=cuda).bfloat16()
    w = (torch.randn((256, 512), generator=g, device=cuda) / 16).bfloat16()
    bias = (0.1 * torch.randn((256,), generator=g, device=cuda)).bfloat16()
    gate = torch.randn((2, 256), generator=g, device=cuda).bfloat16()
    res = torch.randn((2, m, 256), generator=g, device=cuda).bfloat16()
    lens = torch.tensor([m, m - 37], dtype=torch.int32, device=cuda)
    before = fm.matmul_gate_res.launches
    got = fm.matmul_gate_res(h, w, bias, gate, res, lens, mask_rows=mask_rows)
    torch.cuda.synchronize()
    assert fm.matmul_gate_res.launches == before + 1
    _assert_close(got, fm.matmul_gate_res_reference(h, w, bias, gate, res, lens, mask_rows))
    if mask_rows:
        assert torch.equal(got[1, m - 37:], res[1, m - 37:])


def test_int8_ff_env_launches_the_kernel_in_the_quantized_block(cuda, monkeypatch):
    """A quantized FeedForward on the card takes kernel 5 with ERAX_INT8_FF=1
    and the QuantLinear chain without it: never a silent plain path."""
    ff = quant.cast_for_serving(FeedForward(512, mult=2, quantized=True)).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        for layer in (ff.ff[0][0], ff.ff[2]):
            layer.weight_q.copy_(torch.randint(-127, 128, layer.weight_q.shape, generator=g,
                                               device=cuda))
            layer.weight_scale.fill_(1e-3)
    x = torch.randn((2, 64, 512), generator=g, device=cuda).bfloat16()
    scale, shift = (0.1 * torch.randn((2, 2, 512), generator=g, device=cuda)).bfloat16()
    outs = []
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("ERAX_INT8_FF", raising=False)
        else:
            monkeypatch.setenv("ERAX_INT8_FF", env)
        before = quant_ff.int8_ff.launches
        with torch.no_grad():
            outs.append(ff(x, scale, shift))
        torch.cuda.synchronize()
        assert quant_ff.int8_ff.launches == before + (env == "1")
    # the chain rounds the hidden state to bf16 before the GELU, which flips
    # some hidden codes: 2e-2 of the output's scale
    err = (outs[1].float() - outs[0].float()).abs().max()
    assert float(err) <= 2e-2 * float(outs[0].float().abs().max())


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
    g = torch.Generator(device=cuda).manual_seed(1)
    ff_args = _int8_ff_operands(g, cuda, 1, 32, 512, 1024, 512)
    with pytest.raises(TypeError):  # x must be bf16
        quant_ff.int8_ff(ff_args[0].float(), *ff_args[1:])
    with pytest.raises(ValueError):  # K % 64
        quant_ff.int8_ff(ff_args[0][..., :96].contiguous(), ff_args[1][:, :96].contiguous(),
                         *ff_args[2:])
    with pytest.raises(ValueError):  # N % 512
        quant_ff.int8_ff(ff_args[0], ff_args[1][:640].contiguous(), ff_args[2][:640],
                         ff_args[3][:640], ff_args[4][:, :640].contiguous(), *ff_args[5:])
    h = torch.zeros((2, 64, 256), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((256, 256), device=cuda, dtype=torch.bfloat16)
    vec, gate = torch.zeros(256, device=cuda, dtype=torch.bfloat16), h[:, 0]
    with pytest.raises(ValueError):  # gate not contiguous
        fm.matmul_gate_res(h, w, vec, gate, h)
    gate = gate.contiguous()
    with pytest.raises(ValueError):  # N % 128
        fm.matmul_gate_res(h, w[:96].contiguous(), vec[:96], gate[:, :96].contiguous(),
                           h[..., :96].contiguous())
    with pytest.raises(ValueError):  # lens must be int32
        fm.matmul_gate_res(h, w, vec, gate, h, torch.tensor([64, 3], device=cuda),
                           mask_rows=True)


@pytest.mark.parametrize("m", [256, 1088])
def test_ln_mod_matmul_rms_kernel_matches_plain(cuda, m):
    """The RMS mode at the UNetT's shapes (K 1024 -> N 4096, eps 1e-12,
    scale = g - 1, shift = 0) with an all-zero row, which must be gelu(bias)
    exactly; its launches are counted apart from the layernorm mode's."""
    g = torch.Generator(device=cuda).manual_seed(m)
    x = (torch.randn((2, m, 1024), generator=g, device=cuda) + 0.5).bfloat16()
    x[1, m // 2] = 0.0
    gain = 1.0 + 0.1 * torch.randn((1024,), generator=g, device=cuda)
    scale = (gain - 1.0).bfloat16().expand(2, -1).contiguous()
    shift = torch.zeros_like(scale)
    w = (torch.randn((4096, 1024), generator=g, device=cuda) / 32).bfloat16()
    bias = (0.1 * torch.randn((4096,), generator=g, device=cuda)).bfloat16()
    before = dict(fm.ln_mod_matmul.launches_by_norm)
    got = fm.ln_mod_matmul(x, scale, shift, w, bias, norm="rms", eps=1e-12)
    torch.cuda.synchronize()
    assert fm.ln_mod_matmul.launches_by_norm == {"ln": before["ln"], "rms": before["rms"] + 1}
    assert torch.isfinite(got).all()
    _assert_close(got, fm.ln_mod_matmul_reference(x, scale, shift, w, bias, norm="rms",
                                                  eps=1e-12))
    want_zero_row = torch.nn.functional.gelu(bias.float(), approximate="tanh").bfloat16()
    assert torch.equal(got[1, m // 2], want_zero_row)
    # the layernorm mode on the same inputs is another function, and unchanged
    ln = fm.ln_mod_matmul(x, scale, shift, w, bias)
    _assert_close(ln, fm.ln_mod_matmul_reference(x, scale, shift, w, bias))
    assert not torch.allclose(ln.float(), got.float(), atol=0.1)


@pytest.mark.parametrize("n", [256, 1088, 4096])
def test_serving_attention_without_rope_matches_plain(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(n + 1)
    q, k, v = (torch.randn((2, n, 16, 64), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    lens = torch.tensor([n - 37, 0], device=cuda)
    before = dict(sa.serving_attention.launches_by_rope)
    got = sa.serving_attention(q, k, v, lens, rope=None)
    torch.cuda.synchronize()
    assert sa.serving_attention.launches_by_rope == {True: before[True],
                                                     False: before[False] + 1}
    assert torch.isfinite(got).all()
    _assert_close(got, sa.serving_attention_reference(q, k, v, lens, None))


def test_ln_mod_matmul_on_the_card_refuses_unknown_norm_and_fp32(cuda):
    x = torch.zeros((2, 64, 128), dtype=torch.bfloat16, device=cuda)
    s = torch.zeros((2, 128), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((128, 128), dtype=torch.bfloat16, device=cuda)
    bias = torch.zeros((128,), dtype=torch.bfloat16, device=cuda)
    before = fm.ln_mod_matmul.launches
    with pytest.raises(ValueError, match="unknown norm 'bogus'"):
        fm.ln_mod_matmul(x, s, s, w, bias, norm="bogus")
    with pytest.raises(TypeError, match="bfloat16"):
        fm.ln_mod_matmul(x.float(), s.float(), s.float(), w.float(), bias.float(), norm="rms")
    with pytest.raises(ValueError, match="eps must be positive"):
        fm.ln_mod_matmul(x, s, s, w, bias, norm="rms", eps=0.0)
    assert fm.ln_mod_matmul.launches == before


def test_unett_with_kernels_matches_plain_versions(cuda, monkeypatch):
    """A UNetT (dim 256, 4 layers, ff_mult 4, rotary on head 0 only) at b = 2,
    n = 255 frames with its kernels against the same UNetT with the plain
    versions: 5e-2 of the output's scale, as `chip_smoke.py` holds the full
    width; 4 launches each of the attention kernel without rotary and of the
    projection kernel in RMS mode."""
    from eraxvif5tts_tpu_torch.configs import ArchConfig
    from eraxvif5tts_tpu_torch.models import modules
    from eraxvif5tts_tpu_torch.models.unett import UNetT

    arch = ArchConfig(dim=256, depth=4, heads=4, dim_head=64, ff_mult=4, text_dim=None,
                      text_mask_padding=False, pe_attn_head=1, conv_layers=0, dropout=0.0)
    torch.manual_seed(0)
    net = UNetT(arch, 40, 100)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.normal_(0.0, 0.02)
            if name.endswith(".g"):
                p.add_(1.0)
    net.to(device=cuda, dtype=torch.bfloat16).eval()
    g = torch.Generator(device=cuda).manual_seed(1)
    n = 255
    x, cond = (torch.randn((2, n, 100), generator=g, device=cuda) for _ in range(2))
    text = torch.randint(0, 40, (2, 60), generator=g, device=cuda)
    drop = torch.tensor([False, True], device=cuda)
    mask = lens_to_mask(torch.tensor([n, n - 56], device=cuda), n)
    time = torch.full((2,), 0.3, device=cuda)

    def run():
        with torch.inference_mode():
            return net.run(x, cond, net.embed_text(text, n, drop), time, drop, mask)

    before = (sa.serving_attention.launches_by_rope[False], fm.ln_mod_matmul.launches_by_norm["rms"])
    got = run()
    torch.cuda.synchronize()
    assert (sa.serving_attention.launches_by_rope[False] - before[0],
            fm.ln_mod_matmul.launches_by_norm["rms"] - before[1]) == (4, 4)
    monkeypatch.setattr(modules, "dot_product_attention",
                        lambda q, k, v, key_valid=None, rope=None:
                        sa.serving_attention_reference(q, k, v, key_valid.sum(-1), rope))
    monkeypatch.setattr(modules, "ln_mod_matmul", fm.ln_mod_matmul_reference)
    want = run()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max() / want.abs().max()) <= 5e-2
