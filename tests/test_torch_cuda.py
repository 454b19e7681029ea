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
(INT8_FF_TOL), and its hidden codes must equal the plain version's bit for
bit (a scale computed as a product with the reciprocal instead of a true
division flipped 6e-4 of them on an H100).
"""

import dataclasses
import math

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


@pytest.mark.parametrize("n", [64, 192, 320, 1024, 4032])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_train_attention_kernels_match_plain(cuda, n, dropout):
    """n = 64, 192, 320 and 4032 leave the backward's last 128-row block with
    one warpgroup; the first sample has no valid key, the second a masked tail."""
    g = torch.Generator(device=cuda).manual_seed(n)
    q, k, v, dout = (torch.randn((2, n, 4, 64), generator=g, device=cuda).bfloat16()
                     for _ in range(4))
    mask = lens_to_mask(torch.tensor([0, n - 21], device=cuda), n)
    counters = (ta.flash_forward, ta.flash_dq, ta.flash_dkv)
    before = [fn.launches for fn in counters]
    results = []
    for fn in (ta.train_attention, None, ta.train_attention):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        if fn is None:
            out = ta.train_attention_reference(*args, mask.sum(-1), dropout, seed=0xC0FFEE)
        else:
            out = fn(*args, key_valid=mask, dropout_rate=dropout, seed=0xC0FFEE)
        results.append([out, *torch.autograd.grad(out, args, dout)])
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [2, 2, 2]
    for got, want, again in zip(*results):
        assert torch.isfinite(got).all()
        _assert_close(got, want)
        # the mask depends only on (seed, positions) and the backward is two
        # kernels without atomics: a second forward and backward repeat the first
        assert torch.equal(again, got)


@pytest.mark.parametrize("n", [64, 192, 320, 1088, 4032, 4096, 4160, 6144])
@pytest.mark.parametrize("with_rope", [False, True])
def test_serving_attention_forward_core_matches_plain(cuda, n, with_rope):
    """The forward core as the serving attention, with and without fused
    rotary: n = 64 is one warpgroup, 320 and 4096 leave the last 192-row block
    two warpgroups, 1088 one; 4160 and 6144 (the MMDiT's joint sequence) lie
    past the DiT's longest bucket; lengths that end inside a tile,
    on a tile's edge, at 0 and at n, and no lengths; a second call repeats
    the first bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(7 * n + with_rope)
    q, k, v = (torch.randn((4, n, 4, 64), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    rope = rotary_freqs(n, 64, device=cuda) if with_rope else None
    for lens in (torch.tensor([n - 21, 0, 64 * max(n // 128, 1), n], device=cuda), None):
        before = dict(sa.serving_attention.launches_by_rope)
        got = sa.serving_attention(q, k, v, lens, rope)
        torch.cuda.synchronize()
        assert sa.serving_attention.launches_by_rope[with_rope] == before[with_rope] + 1
        assert sa.serving_attention.launches_by_rope[not with_rope] == before[not with_rope]
        assert torch.isfinite(got).all()
        _assert_close(got, sa.serving_attention_reference(q, k, v, lens, rope))
        assert torch.equal(sa.serving_attention(q, k, v, lens, rope), got)


@pytest.mark.parametrize("n", [64, 192, 320, 1088, 4032, 4096])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_train_attention_forward_matches_plain(cuda, n, dropout):
    """The forward core as the training forward: O against the plain version,
    the LSE against the log sum exp of the masked, scaled logits (log n for a
    sample with no valid key), and a second forward bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(11 * n)
    b, h = 3, 2
    q, k, v = (torch.randn((b, n, h, 64), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    lens = torch.tensor([n - 21, 0, n], dtype=torch.int32, device=cuda)
    before = ta.flash_forward.launches
    out, lse = ta.flash_forward(q, k, v, lens, dropout, 0xC0FFEE)
    torch.cuda.synchronize()
    assert ta.flash_forward.launches == before + 1
    assert out.shape == q.shape and lse.shape == (b, h, n) and lse.dtype == torch.float32
    _assert_close(out, ta.train_attention_reference(q, k, v, lens, dropout, 0xC0FFEE))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / 8.0
    valid = torch.arange(n, device=cuda)[None, :] < lens[:, None]
    want = torch.logsumexp(s.masked_fill(~valid[:, None, None, :], -1e30), dim=-1)
    want[1] = torch.log(torch.tensor(float(n)))
    assert float((lse - want).abs().max()) <= 1e-4
    again = ta.flash_forward(q, k, v, lens, dropout, 0xC0FFEE)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.parametrize("d", ta.HEAD_DIMS)
def test_forward_geometry_is_the_kernels(cuda, d):
    built = ta.kernel_forward_geometry(d)
    stated = ta.forward_geometry(2, 4096, 16, d)
    assert built == {name: stated[name] for name in built}
    if d == 64:
        assert (built["rows"], built["stages"], built["threads"]) == (
            ta.FWD_ROWS, ta.FWD_STAGES, ta.FWD_THREADS)


def test_serving_attention_reuses_its_tables(cuda):
    """One cos / sin pair per angle table and one ``lens=None`` vector per
    shape across calls: the Euler loop makes neither again."""
    sa._TABLES.clear()
    sa._FULL_LENS.clear()
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((2, 128, 4, 64), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    rope = rotary_freqs(128, 64, device=cuda)
    first = sa.serving_attention(q, k, v, None, rope)
    tables = sa._TABLES[id(rope)]
    for _ in range(3):
        assert torch.equal(sa.serving_attention(q, k, v, None, rope), first)
    assert len(sa._TABLES) == 1 and sa._TABLES[id(rope)] is tables
    assert len(sa._FULL_LENS) == 1


@pytest.mark.parametrize("d", ta.HEAD_DIMS)
def test_train_attention_backward_geometry_is_the_kernels(cuda, d):
    built = ta.kernel_backward_geometry(d)
    stated = ta.backward_geometry(2, 4096, 16, d)
    assert built == {name: stated[name] for name in built}
    assert (built["rows"], built["stages"], built["threads"]) == (
        ta.BWD_ROWS, ta.BWD_STAGES, ta.BWD_THREADS)


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


def _check_int8_ff(args, b, m, n):
    """Kernel 5 against its plain version: one launch, the output within
    INT8_FF_TOL of its scale, the hidden codes bit for bit, a second call
    bit-identical."""
    codes = torch.empty((b, m, n), dtype=torch.int8, device=args[0].device)
    before = quant_ff.int8_ff.launches
    got = quant_ff.int8_ff(*args, h_codes=codes)
    torch.cuda.synchronize()
    assert quant_ff.int8_ff.launches == before + 1
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    want = quant_ff.int8_ff_reference(*args)
    assert float((got.float() - want.float()).abs().max()) <= INT8_FF_TOL * float(
        want.float().abs().max())
    assert torch.equal(codes, quant_ff.hidden_codes(*args[:4])[0])
    assert torch.equal(got, quant_ff.int8_ff(*args))


@pytest.mark.parametrize("m", [72, 256])
def test_int8_ff_kernel_matches_plain(cuda, m):
    g = torch.Generator(device=cuda).manual_seed(m)
    _check_int8_ff(_int8_ff_operands(g, cuda, 2, m, 512, 1024, 512), 2, m, 1024)


@pytest.mark.parametrize("m", [1, 63, 64, 65, 129, 767])
@pytest.mark.parametrize("k,n", [(1024, 2048), (1024, 4096), (768, 1536), (768, 3072)])
def test_int8_ff_kernel_edges_match_plain(cuda, k, n, m):
    """Every preset's FF (ff_mult 2 and 4 at dim 1024 and 768: clusters of 4,
    8, 3 and 6 CTAs) where the 64-row tiles end unevenly."""
    g = torch.Generator(device=cuda).manual_seed(m + n)
    _check_int8_ff(_int8_ff_operands(g, cuda, 1, m, k, n, k), 1, m, n)


@pytest.mark.parametrize("k,n,k2", [(512, 1024, 512), (1024, 2048, 1024), (1024, 4096, 1024),
                                    (768, 1536, 768), (768, 3072, 768), (128, 512, 256)])
def test_int8_ff_geometry_is_the_kernels(cuda, k, n, k2):
    want = quant_ff.int8_ff_geometry(k, n, k2)
    got = quant_ff.kernel_int8_ff_geometry(k, n, k2)
    assert got == dict(tile_rows=want["tile_rows"], slab=want["slab"],
                       wg_columns=want["wg_columns"], k_tile=want["k_tile"],
                       stages=want["stages"], threads=want["threads"],
                       shared_bytes=want["shared_bytes"], max_k=quant_ff.MAX_K,
                       cluster=want["cluster"], gemm2_columns=want["gemm2_columns"],
                       gemm2_stages=want["gemm2_stages"])
    assert got["shared_bytes"] <= quant_ff.SMEM_LIMIT


def test_int8_ff_refuses_outside_its_domain(cuda):
    """fp32 x, N = 5120 (a cluster of 10), K outside the domain, K2 that no
    warpgroup split gives: each raises on the card, and the built kernel
    reports no cluster for the shape."""
    g = torch.Generator(device=cuda).manual_seed(3)
    args = _int8_ff_operands(g, cuda, 1, 64, 1024, 2048, 1024)
    with pytest.raises(TypeError):
        quant_ff.int8_ff(args[0].float(), *args[1:])
    for k, n, k2 in ((1024, 5120, 1024), (1088, 2048, 1024), (2048, 4096, 1024),
                     (1024, 2048, 768)):
        with pytest.raises(ValueError, match="the kernel takes"):
            quant_ff.int8_ff(*_int8_ff_operands(g, cuda, 1, 64, k, n, k2))
        assert quant_ff.kernel_int8_ff_geometry(k, n, k2)["cluster"] == 0


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
    with pytest.raises(TypeError):  # bf16 or fp32 only
        sa.serving_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):  # one dtype for q, k and v
        sa.serving_attention(q, q.bfloat16(), q)
    qb = torch.zeros((1, 100, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        sa.serving_attention(qb, qb, qb)
    x = torch.zeros((1, 8, 64), device=cuda, dtype=torch.bfloat16)
    s = torch.zeros((1, 64), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((96, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fm.ln_mod_matmul(x, s, s, w, torch.zeros(96, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(TypeError):  # bf16 or fp32 only
        ta.train_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):  # one dtype for q, k and v
        ta.train_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        ta.train_attention(qb, qb, qb)
    qd = torch.zeros((1, 128, 2, 32), device=cuda, dtype=torch.bfloat16)  # no kernel at d = 32
    with pytest.raises(ValueError, match="head dims"):
        sa.serving_attention(qd, qd, qd)
    with pytest.raises(ValueError, match="head dims"):
        ta.train_attention(qd, qd, qd)
    with pytest.raises(ValueError, match="no kernel built"):
        ta.kernel_forward_geometry(32)
    # d = 256 (kernel 6's): every mode but fused rotary; 512 none
    q256 = torch.zeros((1, 128, 2, 256), device=cuda)
    with pytest.raises(ValueError, match="fused rotary"):
        sa.serving_attention(q256, q256, q256, None, torch.zeros((128, 256), device=cuda))
    q512 = torch.zeros((1, 128, 2, 512), device=cuda)
    for t in (q512, q512.bfloat16()):
        with pytest.raises(ValueError, match="head dims"):
            ta.train_attention(t, t, t)
    with pytest.raises(ValueError, match="no kernel built"):
        ta.kernel_geometry_fp32(512)
    g = torch.Generator(device=cuda).manual_seed(1)
    ff_args = _int8_ff_operands(g, cuda, 1, 32, 512, 1024, 512)
    with pytest.raises(TypeError):  # x must be bf16
        quant_ff.int8_ff(ff_args[0].float(), *ff_args[1:])
    with pytest.raises(ValueError):  # K % 128
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


def test_int8_ff_env_launches_the_kernel_in_the_quantized_unett(cuda, monkeypatch):
    """A quantized UNetT (dim 512, 2 layers, ff_mult 4: kernel 5 in clusters
    of 4) at b = 2, n = 127 frames: with ERAX_INT8_FF=1 one kernel 5 launch a
    layer, without it none, never kernel 2; with the flag its output against
    the same UNetT with kernel 5's plain version, 5e-2 of the output's scale
    as `chip_smoke.py` holds the full width."""
    import dataclasses

    from eraxvif5tts_tpu_torch.configs import ArchConfig
    from eraxvif5tts_tpu_torch.models import modules
    from eraxvif5tts_tpu_torch.models.unett import UNetT

    arch = ArchConfig(dim=512, depth=2, heads=8, dim_head=64, ff_mult=4, text_dim=None,
                      text_mask_padding=False, pe_attn_head=1, conv_layers=0, dropout=0.0)
    torch.manual_seed(0)
    fp = UNetT(arch, 40, 100)
    with torch.no_grad():
        for name, p in fp.named_parameters():
            p.normal_(0.0, 0.02)
            if name.endswith(".g"):
                p.add_(1.0)
    net = UNetT(dataclasses.replace(arch, quantized=True), 40, 100)
    net.load_state_dict(quant.quantize_state_dict(fp.state_dict(), arch.depth, "UNetT"))
    quant.cast_for_serving(net).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(2)
    n = 127
    x, cond = (torch.randn((2, n, 100), generator=g, device=cuda) for _ in range(2))
    text = torch.randint(0, 40, (2, 60), generator=g, device=cuda)
    drop = torch.tensor([False, True], device=cuda)
    mask = lens_to_mask(torch.tensor([n, n - 56], device=cuda), n)
    time = torch.full((2,), 0.3, device=cuda)

    def run():
        with torch.inference_mode():
            return net.run(x, cond, net.embed_text(text, n, drop), time, drop, mask)

    outs = {}
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("ERAX_INT8_FF", raising=False)
        else:
            monkeypatch.setenv("ERAX_INT8_FF", env)
        before = (quant_ff.int8_ff.launches, fm.ln_mod_matmul.launches)
        outs[env] = run()
        torch.cuda.synchronize()
        assert (quant_ff.int8_ff.launches - before[0],
                fm.ln_mod_matmul.launches - before[1]) == (arch.depth if env else 0, 0)
        assert torch.isfinite(outs[env]).all()
    monkeypatch.setattr(modules, "int8_ff", quant_ff.int8_ff_reference)
    want = run()
    got = outs["1"]
    assert float((got - want).abs().max() / want.abs().max()) <= 5e-2


@pytest.mark.parametrize("m", [1, 63, 64, 65, 129, 767])
@pytest.mark.parametrize("k,n", [(1024, 2048), (768, 1536), (768, 3072)])
@pytest.mark.parametrize("norm,activation", [("ln", "gelu_tanh"), ("rms", None)])
def test_ln_mod_matmul_gemm_core_edges_match_plain(cuda, m, k, n, norm, activation):
    """Kernel 2 where the GEMM core's tiles end unevenly, at every preset's
    widths, a second call bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = (torch.randn((3, m, k), generator=g, device=cuda) + 0.5).bfloat16()
    scale, shift = ((0.1 * torch.randn((3, k), generator=g, device=cuda)).bfloat16()
                    for _ in range(2))
    w = (torch.randn((n, k), generator=g, device=cuda) / 32).bfloat16()
    bias = (0.1 * torch.randn((n,), generator=g, device=cuda)).bfloat16()
    got = fm.ln_mod_matmul(x, scale, shift, w, bias, activation=activation, norm=norm)
    torch.cuda.synchronize()
    _assert_close(got, fm.ln_mod_matmul_reference(x, scale, shift, w, bias, activation, norm))
    assert torch.equal(got, fm.ln_mod_matmul(x, scale, shift, w, bias, activation=activation,
                                             norm=norm))


@pytest.mark.parametrize("m", [1, 63, 64, 65, 129, 767])
@pytest.mark.parametrize("k,n", [(2048, 1024), (1536, 768), (3072, 768), (4096, 1024)])
@pytest.mark.parametrize("mask_rows", [False, True])
def test_matmul_gate_res_gemm_core_edges_match_plain(cuda, m, k, n, mask_rows):
    """Kernel 3 at the same edges, with lengths of 0, of M and inside a tile:
    masked rows are the residual bit for bit, a second call bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    h = torch.randn((3, m, k), generator=g, device=cuda).bfloat16()
    w = (torch.randn((n, k), generator=g, device=cuda) / 45).bfloat16()
    bias = (0.1 * torch.randn((n,), generator=g, device=cuda)).bfloat16()
    gate = torch.randn((3, n), generator=g, device=cuda).bfloat16()
    res = torch.randn((3, m, n), generator=g, device=cuda).bfloat16()
    lens_list = [0, m, max(m - 37, m // 2)]
    lens = torch.tensor(lens_list, dtype=torch.int32, device=cuda)
    got = fm.matmul_gate_res(h, w, bias, gate, res, lens, mask_rows=mask_rows)
    torch.cuda.synchronize()
    _assert_close(got, fm.matmul_gate_res_reference(h, w, bias, gate, res, lens, mask_rows))
    assert torch.equal(got, fm.matmul_gate_res(h, w, bias, gate, res, lens, mask_rows=mask_rows))
    if mask_rows:
        for i, valid in enumerate(lens_list):
            assert torch.equal(got[i, valid:], res[i, valid:])


@pytest.mark.parametrize("b,m,n", [(2, 768, 2048), (2, 1088, 2048), (16, 768, 4096),
                                   (2, 768, 4096), (3, 1, 1536), (1, 5, 384)])
def test_gemm_geometry_is_the_kernels(cuda, b, m, n):
    """The constants of the built GEMM core and its choice of tile width and
    grid for a shape equal what `gemm_geometry` states in Python."""
    built = fm.kernel_gemm_geometry(b, m, n)
    geo = fm.gemm_geometry(b, m, 1024, n, sms=built["sms"])
    assert built["sms"] == torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (built["tile_rows"], built["acc_columns"] * built["nacc"]) == geo["tile"]
    assert (built["k_tile"], built["stages"], built["threads"], built["shared_bytes"]) == (
        geo["k_tile"], geo["stages"], geo["threads"], geo["shared_bytes"])
    assert (built["nacc"], built["grid"]) == (geo["nacc"], geo["grid"])
    assert built["max_norm_k"] == fm.GEMM_MAX_NORM_K


def test_fused_projections_refuse_what_the_gemm_core_does_not_take(cuda):
    x = torch.zeros((1, 8, 96), device=cuda, dtype=torch.bfloat16)  # K % 64
    s = torch.zeros((1, 96), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((128, 96), device=cuda, dtype=torch.bfloat16)
    bias = torch.zeros(128, device=cuda, dtype=torch.bfloat16)
    before = (fm.ln_mod_matmul.launches, fm.matmul_gate_res.launches)
    with pytest.raises(ValueError):
        fm.ln_mod_matmul(x, s, s, w, bias)
    big = torch.zeros((1, 8, 4096), device=cuda, dtype=torch.bfloat16)  # K beyond the buffers
    with pytest.raises(ValueError):
        fm.ln_mod_matmul(big, big[:, 0].contiguous(), big[:, 0].contiguous(),
                         torch.zeros((128, 4096), device=cuda, dtype=torch.bfloat16), bias)
    with pytest.raises(ValueError):
        fm.matmul_gate_res(x, w, bias, torch.zeros((1, 128), device=cuda, dtype=torch.bfloat16),
                           torch.zeros((1, 8, 128), device=cuda, dtype=torch.bfloat16))
    assert (fm.ln_mod_matmul.launches, fm.matmul_gate_res.launches) == before


def test_distill_step_with_kernels_matches_the_plain_path(cuda, monkeypatch):
    """One distillation loss and its gradients on the card, held in two
    parts. The teacher (bf16, eval) through kernels 1 and 2 against the plain
    serving ops: within 2e-2 of its scale. The student (fp32
    parameters, bf16 compute, dropout 0.1) through kernels 4a / 4b / 4c
    against `train_attention.plain` on the same draws and dropout keys: the
    flattened gradient and the q / k / v projections' gradient, relative L2,
    within limits set between this test's readings on an H100 and those of a
    control (the plain path with every block's attention-dropout keys
    changed), which must move each beyond its limit."""
    import dataclasses

    from eraxvif5tts_tpu_torch.configs import ArchConfig
    from eraxvif5tts_tpu_torch.models import modules
    from eraxvif5tts_tpu_torch.models.cfm import CFM, LossDraws
    from eraxvif5tts_tpu_torch.models.dit import DiT
    from eraxvif5tts_tpu_torch.training.distill import DistillConfig, distillation_losses

    # on an H100: gradient 1.64e-3 against the control's 3.74e-3, q / k / v
    # 2.18e-3 against 7.31e-2; each limit near the two readings' geometric mean
    teacher_tol, grad_tol, qkv_grad_tol = 2e-2, 2.5e-3, 1.2e-2
    arch = ArchConfig(dim=128, depth=3, heads=2, dim_head=64, ff_mult=2, text_dim=64,
                      conv_layers=1, dropout=0.1)
    torch.manual_seed(0)
    teacher = DiT(arch, 20, 100).to(cuda, torch.bfloat16).eval()
    student = DiT(dataclasses.replace(arch, depth=2), 20, 100,
                  compute_dtype=torch.bfloat16).to(cuda).train()
    for p in (*teacher.parameters(), *student.parameters()):
        torch.nn.init.normal_(p, 0.0, 0.05)
    g = torch.Generator(device=cuda).manual_seed(1)
    b, n = 2, 256
    mel = torch.randn((b, n, 100), generator=g, device=cuda)
    text = torch.randint(0, 20, (b, 40), generator=g, device=cuda)
    lens = torch.tensor([n, n - 30], device=cuda)
    draws = LossDraws.sample(g, b, n, 100, 2)
    wrong = dataclasses.replace(draws, dropout_keys=[
        [[(attn[0] + 1) & 0xFFFFFFFF, attn[1]], out, ff] for attn, out, ff in draws.dropout_keys])
    cfm = CFM(student)

    xt = (1 - draws.time[:, None, None]) * draws.x0 + draws.time[:, None, None] * mel
    no_drop = torch.zeros(b, dtype=torch.bool, device=cuda)
    with torch.no_grad():
        teacher_got = teacher(xt, mel, text, draws.time, no_drop, no_drop).float()
        with monkeypatch.context() as m:
            m.setattr(modules, "dot_product_attention",
                      lambda q, k, v, key_valid=None, rope=None:
                      sa.serving_attention_reference(q, k, v, None, rope))
            m.setattr(modules, "ln_mod_matmul", fm.ln_mod_matmul_reference)
            teacher_want = teacher(xt, mel, text, draws.time, no_drop, no_drop).float()
    teacher_err = float((teacher_got - teacher_want).abs().max() / teacher_want.abs().max())

    def loss_and_grads(draws):
        student.zero_grad(set_to_none=True)
        loss, _ = distillation_losses(cfm, teacher, mel, text, lens, draws, DistillConfig())
        loss.backward()
        qkv = [p.grad.flatten() for name, p in student.named_parameters()
               if name.split(".")[-2] in ("to_q", "to_k", "to_v")]
        return (loss.item(), torch.cat([p.grad.flatten() for p in student.parameters()]),
                torch.cat(qkv))

    def distance(x, want):
        return [float((x[i] - want[i]).norm() / want[i].norm()) for i in (1, 2)]

    before = (sa.serving_attention.launches, fm.ln_mod_matmul.launches,
              ta.flash_forward.launches, ta.flash_dq.launches, ta.flash_dkv.launches)
    got = loss_and_grads(draws)
    after = (sa.serving_attention.launches, fm.ln_mod_matmul.launches,
             ta.flash_forward.launches, ta.flash_dq.launches, ta.flash_dkv.launches)
    assert [a - c for a, c in zip(after, before)] == [3, 3, 2, 2, 2]
    monkeypatch.setattr(ta.train_attention, "plain", True)
    want = loss_and_grads(draws)
    control = loss_and_grads(wrong)
    err, ctl = distance(got, want), distance(control, want)
    print(f"teacher error {teacher_err:.3g}; loss {got[0]:.6f} vs {want[0]:.6f}; gradient / "
          f"q/k/v gradient relative L2 {err[0]:.3g} / {err[1]:.3g}, control {ctl[0]:.3g} / "
          f"{ctl[1]:.3g}")
    assert torch.isfinite(teacher_got).all() and teacher_err <= teacher_tol
    assert math.isfinite(got[0]) and torch.isfinite(got[1]).all()
    assert err[0] <= grad_tol < ctl[0] and err[1] <= qkv_grad_tol < ctl[1], (err, ctl)


def test_predict_duration_frames_on_the_card_equals_the_cpu(cuda):
    """The predictor's frame counts on the card equal the CPU's (TF32 off in
    its convolutions), and an id outside its table raises on the host
    before any lookup."""
    from eraxvif5tts_tpu_torch.models.duration import (
        DurationPredictor,
        predict_duration_frames,
    )

    torch.manual_seed(3)
    cpu = DurationPredictor(97).eval()
    with torch.no_grad():
        cpu.proj.bias.fill_(2.0)
    card = DurationPredictor(97).to(cuda).eval()
    card.load_state_dict(cpu.state_dict())
    phoneme_map = {c: i + 1 for i, c in enumerate("abcdefghijklmnopqrstuvwxyz.,!?")}
    texts = ("tonight the sea was calm, and the lamp turned.", "a", "xyz? no.",
             "the keeper wrote one more line in the logbook " * 4)
    for text in texts:
        frames = predict_duration_frames(cpu, phoneme_map, text)
        assert frames > 0 and predict_duration_frames(card, phoneme_map, text) == frames
    with pytest.raises(ValueError, match="outside the duration predictor's table"):
        predict_duration_frames(card, {"a": 1, "b": 200}, "ab")


# ---- fp32 serving: kernel 1's fp32 mode and the paths that run it ------------

FP32_TOL = 2e-5  # fp32 sums over <= 6144 keys in another order


@pytest.fixture
def no_tf32():
    """The plain version's einsum in full fp32 (TF32 off) for the test."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("n", [64, 192, 1088, 4096, 6144])
@pytest.mark.parametrize("with_rope", [False, True])
def test_serving_attention_fp32_matches_plain(cuda, no_tf32, n, with_rope):
    """The fp32 kernel at the edges of its domain (one tile, three, the DiT's
    bucket, the DiT's longest, the MMDiT's joint sequence), with lengths
    inside a tile, at 0, on a tile's edge and past n, and without lengths:
    within FP32_TOL of the plain version, counted apart from the bf16
    kernel's launches, a second call bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(11 * n + with_rope)
    q, k, v = (torch.randn((3, n, 2, 64), generator=g, device=cuda) for _ in range(3))
    rope = rotary_freqs(n, 64, device=cuda) if with_rope else None
    for lens in (torch.tensor([n - 21, 0, 64 * max(n // 128, 1)], device=cuda),
                 torch.tensor([n + 5, 1, n], device=cuda), None):
        bf16 = (sa.serving_attention.launches, dict(sa.serving_attention.launches_by_rope))
        before = dict(sa.serving_attention.launches_fp32_by_rope)
        got = sa.serving_attention(q, k, v, lens, rope)
        torch.cuda.synchronize()
        assert sa.serving_attention.launches_fp32_by_rope == {
            with_rope: before[with_rope] + 1, not with_rope: before[not with_rope]}
        assert (sa.serving_attention.launches,
                dict(sa.serving_attention.launches_by_rope)) == bf16
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        want = sa.serving_attention_reference(q, k, v, lens, rope)
        err = (got - want).abs()
        assert torch.all(err <= FP32_TOL * (1 + want.abs())), float(err.max())
        assert torch.equal(sa.serving_attention(q, k, v, lens, rope), got)


def test_fp32_feedforward_launches_no_kernel_2(cuda, no_tf32):
    """An fp32 block's feed-forward on the card takes the unfused layernorm +
    modulate + project branch (the JAX package's gate): no launch of kernel
    2, the CPU's result within fp32 rounding; a bf16 one launches it."""
    torch.manual_seed(5)
    ff = FeedForward(256, mult=2).eval()
    x, scale, shift = torch.randn(2, 72, 256), 0.1 * torch.randn(2, 256), torch.randn(2, 256)
    with torch.no_grad():
        want = ff(x, scale, shift)
        card = ff.to(cuda)
        before = fm.ln_mod_matmul.launches
        got = card(x.to(cuda), scale.to(cuda), shift.to(cuda))
        torch.cuda.synchronize()
        assert fm.ln_mod_matmul.launches == before
        assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())
        card.bfloat16()(x.to(cuda).bfloat16(), scale.to(cuda).bfloat16(),
                        shift.to(cuda).bfloat16())
        torch.cuda.synchronize()
        assert fm.ln_mod_matmul.launches == before + 1


@pytest.mark.parametrize("backbone", ["DiT", "UNetT", "MMDiT"])
def test_fp32_wrapper_generates_on_the_card(cuda, backbone):
    """A default-built (fp32) tiny wrapper on the card, for each backbone:
    kernel 1 fp32 depth x NFE launches a chunk (with rotary for the DiT,
    without for the UNetT and the MMDiT), no kernel 2, no bf16 attention, and
    PCM within 4 LSB of the same wrapper on the CPU given the same noise."""
    import numpy as np

    from eraxvif5tts_tpu_torch.configs import ArchConfig, ModelConfig
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper

    arch = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, dropout=0.0)
    cfg = {"DiT": ModelConfig(name="tiny", arch=ArchConfig(text_dim=32, conv_layers=1, **arch)),
           "UNetT": ModelConfig(name="tiny-e2", backbone="UNetT", arch=ArchConfig(
               text_dim=None, text_mask_padding=False, pe_attn_head=1, conv_layers=0, **arch)),
           "MMDiT": ModelConfig(name="tiny-mm", backbone="MMDiT", arch=ArchConfig(**arch))
           }[backbone]
    buckets = (127, 255) if backbone == "UNetT" else (128, 256)  # + the time token: 64k
    vocab = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,")}
    kwargs = dict(model_cfg=cfg, vocab_char_map=vocab, nfe_step=4,
                  duration_buckets=buckets, text_buckets=(128,))
    torch.manual_seed(0)
    cpu = F5TTSWrapper(device="cpu", **kwargs)
    card = F5TTSWrapper(device=cuda, **kwargs)
    assert card.compute_dtype == "float32"
    card.transformer.load_state_dict(cpu.transformer.state_dict())
    card.vocoder.load_state_dict(cpu.vocoder.state_dict())
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.standard_normal((256, 100)).astype(np.float32))
    for w in (cpu, card):
        w._draw_noise = lambda generator, frames, w=w: noise[:frames].to(w.device)
    wav = (0.2 * np.sin(2 * np.pi * 150 * np.arange(12000) / 24000)).astype(np.float32)
    roped = backbone == "DiT"
    waves = []
    for w in (cpu, card):
        ref = w.preprocess_reference(ref_audio=wav, ref_sample_rate=24000,
                                     ref_text="the sea was calm.")
        before = (dict(sa.serving_attention.launches_fp32_by_rope), sa.serving_attention.launches,
                  fm.ln_mod_matmul.launches)
        waves.append(w.generate("the lamp turned steadily.", ref=ref, seed=1,
                                use_pinyin=False))
        if w is card:
            torch.cuda.synchronize()
            fp32, bf16, kernel2 = before
            # depth a backbone step: NFE in a chunk's replay, one in each
            # key's eager run before its capture
            steps = 4 * card.graph_replays + len(card._graphs)
            assert card.graph_replays >= 1
            assert sa.serving_attention.launches_fp32_by_rope == {
                roped: fp32[roped] + 2 * steps, not roped: fp32[not roped]}
            assert (sa.serving_attention.launches, fm.ln_mod_matmul.launches) == (bf16, kernel2)
    assert waves[0].shape == waves[1].shape and np.isfinite(waves[1]).all()
    assert np.abs(waves[1] - waves[0]).max() <= 4 / 32767.0


# ---- fp32 training: kernels 4a / 4b / 4c in fp32 and the step that runs them --

FP32_GRAD_TOL = 5e-5  # fp32 gradients vs plain, max |err| in units of max |plain|


def _fp32_counts():
    return [fn.launches for fn in (ta.flash_forward_fp32, ta.flash_dq_fp32, ta.flash_dkv_fp32,
                                   ta.flash_forward, ta.flash_dq, ta.flash_dkv)]


@pytest.mark.parametrize("n", [64, 192, 1024, 4096])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_train_attention_fp32_kernels_match_plain(cuda, no_tf32, n, dropout):
    """fp32 q, k, v through `train_attention`: the fp32 kernels (counted apart
    from the bf16 ones) against the plain version with TF32 off, the first
    sample with no valid key, the second with a masked tail: O within
    FP32_TOL * (1 + |plain|), dq / dk / dv within FP32_GRAD_TOL of their
    scale, the LSE within 1e-6 relative L2 of the plain log sum exp (log n
    where no key is valid), keys past lens with zero dk and dv, and a second
    forward and backward bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(7 * n + int(10 * dropout))
    q, k, v, dout = (torch.randn((2, n, 2, 64), generator=g, device=cuda) for _ in range(4))
    lens = torch.tensor([0, n - 21], dtype=torch.int32, device=cuda)
    mask = lens_to_mask(lens, n)
    before = _fp32_counts()
    results = []
    for plain in (False, True, False):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        if plain:
            out = ta.train_attention_reference(*args, lens, dropout, seed=0xC0FFEE)
        else:
            out = ta.train_attention(*args, key_valid=mask, dropout_rate=dropout, seed=0xC0FFEE)
        results.append([out, *torch.autograd.grad(out, args, dout)])
    torch.cuda.synchronize()
    assert [c - b for c, b in zip(_fp32_counts(), before)] == [2, 2, 2, 0, 0, 0]
    got, want, again = results
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all() for t in got)
    err = (got[0] - want[0]).abs()
    assert torch.all(err <= FP32_TOL * (1 + want[0].abs())), float(err.max())
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max() / b.abs().max()) <= FP32_GRAD_TOL
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert not got[2][1, n - 21:].any() and not got[3][1, n - 21:].any()
    _, lse = ta.flash_forward_fp32(q, k, v, lens, dropout, 0xC0FFEE)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 8.0
    s[1, :, :, n - 21:] = -1e30
    want_lse = torch.logsumexp(s, dim=-1)
    want_lse[0] = math.log(n)
    assert float((lse - want_lse).norm() / want_lse.norm()) <= 1e-6


@pytest.mark.parametrize("d", ta.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_fp32_backward_kernels_ignore_the_tf32_flags(cuda, dropout, d):
    """The 3xTF32 dq and dk/dv kernels at every head dim (the four-warp
    kernels at d = 64, the pairs of warps at 128 and 256) give the same bits
    with both of torch's TF32 flags on as with them off: their precision is
    their own."""
    g = torch.Generator(device=cuda).manual_seed(31)
    q, k, v, dout = (torch.randn((2, 256, 2, d), generator=g, device=cuda) for _ in range(4))
    lens = torch.tensor([256, 201], dtype=torch.int32, device=cuda)
    out, lse = ta.flash_forward_fp32(q, k, v, lens, dropout, 9)
    dd = ta.row_dot(dout, out)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    results = []
    try:
        for on in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
            results.append([ta.flash_dq_fp32(q, k, v, lens, lse, dd, dout, dropout, 9),
                            *ta.flash_dkv_fp32(q, k, v, lens, lse, dd, dout, dropout, 9)])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert all(torch.equal(a, b) for a, b in zip(*results))


@pytest.mark.parametrize("d", ta.KERNEL_HEAD_DIMS)
def test_train_attention_fp32_geometry_is_the_kernels(cuda, d):
    built = ta.kernel_geometry_fp32(d)
    fwd, bwd = ta.forward_geometry_fp32(2, 4096, 16, d), ta.backward_geometry_fp32(2, 4096, 16, d)
    assert built == {"rows": fwd["rows"], "threads": fwd["threads"], "stages": fwd["stages"],
                     "shared_bytes": fwd["shared_bytes"], "sets": fwd["sets"],
                     "key_tile": fwd["key_tile"], "bwd_rows": bwd["rows"],
                     "dq_threads": bwd["dq_threads"], "dkv_threads": bwd["dkv_threads"],
                     "bwd_stages": bwd["bwd_stages"], "dq_tile": bwd["dq_tile"],
                     "dkv_tile": bwd["dkv_tile"],
                     "dq_shared_bytes": bwd["dq_shared_bytes"],
                     "dkv_shared_bytes": bwd["dkv_shared_bytes"]}


@pytest.mark.parametrize("d", ta.HEAD_DIMS)
def test_serving_attention_fp32_geometry_is_the_kernels(cuda, d):
    """Kernel 1 fp32 reports the forward core's constants, which kernel 4a's
    fp32 mode reports too, as `forward_geometry_fp32` states them."""
    geo = sa.forward_geometry_fp32(2, sa.MAX_N, 16, d)
    assert sa.kernel_geometry_fp32(d) == {key: geo[key] for key in ta.FP32_FORWARD_BUILT}
    assert sa.kernel_geometry_fp32(d) == {key: ta.kernel_geometry_fp32(d)[key]
                                          for key in ta.FP32_FORWARD_BUILT}


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_fp32_forwards_ignore_the_tf32_flags(cuda, dropout):
    """Both 3xTF32 forwards (kernel 4a's fp32 mode at the dropout, kernel 1's
    with and without rotary) give the same bits with both of torch's TF32
    flags on as with them off."""
    g = torch.Generator(device=cuda).manual_seed(37)
    q, k, v = (torch.randn((2, 320, 2, 64), generator=g, device=cuda) for _ in range(3))
    lens = torch.tensor([320, 201], dtype=torch.int32, device=cuda)
    rope = rotary_freqs(320, 64, device=cuda)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    results = []
    try:
        for on in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
            results.append([*ta.flash_forward_fp32(q, k, v, lens, dropout, 9),
                            sa.serving_attention(q, k, v, lens, rope),
                            sa.serving_attention(q, k, v, lens, None)])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert all(torch.equal(a, b) for a, b in zip(*results))


def test_fp32_train_step_with_kernels_matches_plain(cuda):
    """One `Trainer.train_step` of a 2-block fp32 DiT (dropout 0.1, blocks
    checkpointed) with both TF32 flags on outside the step: the fp32 kernels
    launched 4 / 2 / 2 times and no bf16 kernel, the loss and the gradient
    the step would apply within fp32 rounding of the same step with
    `train_attention.plain` set, on the same draws."""
    from eraxvif5tts_tpu_torch.configs import ArchConfig
    from eraxvif5tts_tpu_torch.models.cfm import CFM, LossDraws
    from eraxvif5tts_tpu_torch.models.dit import DiT
    from eraxvif5tts_tpu_torch.training.trainer import Trainer, make_optimizer

    arch = ArchConfig(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=64,
                      conv_layers=1, dropout=0.1, checkpoint_activations=True,
                      remat_policy="full")
    torch.manual_seed(0)
    dit = DiT(arch, 20, 100).to(cuda)
    for p in dit.parameters():
        torch.nn.init.normal_(p, 0.0, 0.05)
    trainer = Trainer(cfm=CFM(dit.train()), optimizer=make_optimizer(num_warmup_updates=1,
                                                                      total_updates=10))
    state = trainer.init_state()
    g = torch.Generator(device=cuda).manual_seed(1)
    b, n = 2, 256
    batch = {"mel": torch.randn((b, n, 100), generator=g, device=cuda),
             "text": torch.randint(0, 20, (b, 40), generator=g, device=cuda),
             "lens": torch.tensor([n, n - 30], device=cuda)}
    draws = LossDraws.sample(g, b, n, 100, arch.depth)
    seen = []
    trainer._apply = lambda state, grads, norm: seen.append(
        torch.cat([x.flatten() for x in grads]))
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        before = _fp32_counts()
        _, got = trainer.train_step(state, batch, draws)
        torch.cuda.synchronize()
        assert [c - c0 for c, c0 in zip(_fp32_counts(), before)] == [4, 2, 2, 0, 0, 0]
        ta.train_attention.plain = True
        try:
            _, want = trainer.train_step(state, batch, draws)
        finally:
            ta.train_attention.plain = False
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert got["applied"] == want["applied"] == 1.0
    assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    assert float((seen[0] - seen[1]).norm() / seen[1].norm()) <= 1e-5


# ---- kernel 4 on the MMDiT's joint sequence; MMDiT training; the int8 MMDiT --


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [4160, 5120, 6144])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_train_attention_kernels_take_the_joint_sequence(cuda, no_tf32, dtype, n, dropout):
    """Kernels 4a / 4b / 4c past n = 4096, up to the MMDiT's joint 6144, in
    both dtypes: a sample with no valid key beside one with a masked tail,
    against the plain version (bf16 within TOL * (1 + |plain|); fp32 O within
    FP32_TOL * (1 + |plain|), the gradients within FP32_GRAD_TOL of their
    scale), a second forward and backward bit-identical; n = 6208 and a
    length not a multiple of 64 refused."""
    g = torch.Generator(device=cuda).manual_seed(n + int(10 * dropout))
    q, k, v, dout = (torch.randn((2, n, 2, 64), generator=g, device=cuda).to(dtype)
                     for _ in range(4))
    lens = torch.tensor([0, n - 37], dtype=torch.int32, device=cuda)
    mask = lens_to_mask(lens, n)
    results = []
    for plain in (False, True, False):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        if plain:
            out = ta.train_attention_reference(*args, lens, dropout, seed=0xBEEF)
        else:
            out = ta.train_attention(*args, key_valid=mask, dropout_rate=dropout, seed=0xBEEF)
        results.append([out, *torch.autograd.grad(out, args, dout)])
    torch.cuda.synchronize()
    got, want, again = results
    assert all(torch.isfinite(t).all() for t in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if dtype == torch.bfloat16:
        for a, b in zip(got, want):
            _assert_close(a, b)
    else:
        err = (got[0] - want[0]).abs()
        assert torch.all(err <= FP32_TOL * (1 + want[0].abs())), float(err.max())
        for a, b in zip(got[1:], want[1:]):
            assert float((a - b).abs().max() / b.abs().max()) <= FP32_GRAD_TOL
    for bad in (ta.MAX_N + 64, n - 32):
        x = torch.zeros((1, bad, 2, 64), device=cuda, dtype=dtype)
        with pytest.raises(ValueError, match="n must be a multiple of 64"):
            ta.train_attention(x, x, x)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mmdit_train_step_with_kernels_matches_plain(cuda, dtype):
    """A 2-block MMDiT's `CFM.loss` and its gradient on the card at a joint
    64 + 256 (fp32 parameters, ``dtype`` compute, dropout 0): kernel 4 of
    that dtype launched 2 / 2 / 2 times (one a block, no recompute) and the
    other dtype's at 0, the loss and the gradient within the dtype's
    rounding of the same with `train_attention.plain` set."""
    from eraxvif5tts_tpu_torch.configs import ArchConfig
    from eraxvif5tts_tpu_torch.models.cfm import CFM, LossDraws
    from eraxvif5tts_tpu_torch.models.mmdit import MMDiT

    arch = ArchConfig(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, dropout=0.0)
    torch.manual_seed(0)
    net = MMDiT(arch, 20, 100, compute_dtype=dtype).to(cuda)
    for p in net.parameters():
        torch.nn.init.normal_(p, 0.0, 0.05)
    cfm = CFM(net.train())
    g = torch.Generator(device=cuda).manual_seed(2)
    b, n = 2, 256
    mel = torch.randn((b, n, 100), generator=g, device=cuda)
    text = torch.randint(0, 20, (b, 64), generator=g, device=cuda)
    text[1, 30:] = -1
    lens = torch.tensor([n, n - 30], device=cuda)
    draws = LossDraws.sample(g, b, n, 100, arch.depth)
    readings = []
    for plain in (False, True):
        net.zero_grad(set_to_none=True)
        before = _fp32_counts()
        ta.train_attention.plain = plain
        try:
            loss = cfm.loss(mel, text, lens, draws)[0]
            loss.backward()
        finally:
            ta.train_attention.plain = False
        torch.cuda.synchronize()
        counts = [c - c0 for c, c0 in zip(_fp32_counts(), before)]
        if not plain:
            want = [2, 2, 2, 0, 0, 0] if dtype == torch.float32 else [0, 0, 0, 2, 2, 2]
            assert counts == want
        readings.append((loss.item(), torch.cat([p.grad.flatten() for p in net.parameters()])))
    (got_loss, got), (want_loss, want) = readings
    tol = 1e-5 if dtype == torch.float32 else 3e-3
    assert abs(got_loss - want_loss) <= tol * abs(want_loss)
    assert float((got - want).norm() / want.norm()) <= 10 * tol


def test_int8_mmdit_launches_kernel_5_on_both_streams(cuda, monkeypatch):
    """A quantized 3-block MMDiT on the card with ERAX_INT8_FF=1: kernel 5 on
    every block's ``ff_x`` and every ``ff_c`` but the last block's (5 a
    call), at the text stream's rows too; unset, none; the two within 2e-2
    of the output's scale."""
    from eraxvif5tts_tpu_torch.configs import ArchConfig
    from eraxvif5tts_tpu_torch.models.mmdit import MMDiT

    arch = ArchConfig(dim=512, depth=3, heads=8, dim_head=64, ff_mult=2, dropout=0.0,
                      quantized=True)
    torch.manual_seed(0)
    fp = MMDiT(dataclasses.replace(arch, quantized=False), 20, 100)
    for p in fp.parameters():
        torch.nn.init.normal_(p, 0.0, 0.02)
    net = MMDiT(arch, 20, 100)
    net.load_state_dict(quant.quantize_state_dict(fp.state_dict(), arch.depth, "MMDiT"))
    net = quant.cast_for_serving(net).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(3)
    b, n, nt = 2, 256, 64
    x = torch.randn((b, n, 100), generator=g, device=cuda).bfloat16()
    text = torch.randint(0, 20, (b, nt), generator=g, device=cuda)
    no = torch.zeros(b, dtype=torch.bool, device=cuda)
    mask = lens_to_mask(torch.tensor([n, n - 70], device=cuda), n)
    outs = []
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("ERAX_INT8_FF", raising=False)
        else:
            monkeypatch.setenv("ERAX_INT8_FF", env)
        before = quant_ff.int8_ff.launches
        with torch.no_grad():
            outs.append(net(x, x, text, torch.full((b,), 0.5, device=cuda), no, no, mask))
        torch.cuda.synchronize()
        assert quant_ff.int8_ff.launches - before == (2 * arch.depth - 1 if env else 0)
    assert all(torch.isfinite(o).all() for o in outs)
    err = (outs[1] - outs[0]).abs().max()
    assert float(err) <= 2e-2 * float(outs[0].abs().max())


# ---- the wrapper's dispatch: one CUDA graph replay a chunk ------------------


def test_graph_replay_equals_the_eager_step(cuda):
    """A tiny bf16 wrapper: the fused step's replay equals the eager step bit
    for bit, at the key's first call and after, for two references of one
    length but different mel and RMS under one key; a replay adds depth x NFE
    to the counters of kernels 1 and 2 (the first call's one-step eager run
    depth more); a `generate` of four chunks or more replays one graph a chunk
    and equals the same request through the eager step."""
    import numpy as np

    from eraxvif5tts_tpu_torch.configs import ArchConfig, ModelConfig
    from eraxvif5tts_tpu_torch.infer import wrapper as twrapper
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper

    sr, mel_dim = 24000, 100
    vocab = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,!?'-0123456")}
    t = np.arange(int(sr * 0.8)) / sr
    clip = (0.2 * np.sin(2 * np.pi * 190 * t) + 0.05 * np.sin(2 * np.pi * 900 * t)
            ).astype(np.float32)

    arch = ArchConfig(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32,
                      conv_layers=1, dropout=0.0)
    torch.manual_seed(0)
    w = F5TTSWrapper(model_cfg=ModelConfig(name="tiny", arch=arch), vocab_char_map=vocab,
                     nfe_step=4, compute_dtype="bfloat16", device="cuda",
                     duration_buckets=(128, 256, 384), text_buckets=(64,))
    refs = [w.preprocess_reference(ref_audio=level * clip, ref_sample_rate=sr,
                                   ref_text="hello there, this is the reference voice")
            for level in (1.0, 0.25)]
    n_ref, bucket = refs[0].n_frames, 256
    vstart = n_ref - twrapper.VOCODE_MARGIN_FRAMES
    static = dict(steps=4, cfg_strength=2.0, sway=-1.0, max_duration=bucket,
                  vocode_start=vstart, gen_start=n_ref - vstart)
    g = torch.Generator(device="cuda").manual_seed(1)
    text = torch.randint(0, len(vocab), (1, 64), generator=g, device="cuda")
    noise = torch.randn((bucket, mel_dim), generator=g, device="cuda")
    for ref in (*refs, refs[0]):
        args = (ref.mel, text, torch.tensor([200], device="cuda"),
                torch.tensor([n_ref], device="cuda"), noise, w._rms_scale(ref))
        want = w._sample_vocode(*args, **static)
        before = (sa.serving_attention.launches, fm.ln_mod_matmul.launches)
        replays = w.graph_replays
        got = w._dispatch_sample_vocode(*args, **static)
        torch.cuda.synchronize()
        rose = [sa.serving_attention.launches - before[0], fm.ln_mod_matmul.launches - before[1]]
        fresh = len(w._graphs) == 1 and replays == 0  # one-step eager run + replay
        assert rose == [arch.depth * (4 + fresh)] * 2
        assert w.graph_replays == replays + 1
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert len(w._graphs) == 1 and len(w.dispatch_keys) == 1
    # a generate of four chunks or more: one replay a chunk, the eager PCM
    w.warmup(refs[0], nfe_step=4)
    replays = w.graph_replays
    text = ("the lamp turned. the sea was calm. no ship passed the point. the boat comes "
            "soon. the keeper wrote a line. then the dawn came.")
    got = w.generate(text, ref=refs[0], seed=3, nfe_step=4, use_pinyin=False)
    chunks = w.graph_replays - replays
    w._dispatch_sample_vocode = w._sample_vocode
    want = w.generate(text, ref=refs[0], seed=3, nfe_step=4, use_pinyin=False)
    assert chunks >= 4 and np.array_equal(got, want)


# ---- the training CLI's path: MAS and the duration-focus update ------------


def test_mas_on_the_card_matches_the_cpu(cuda):
    """The three MAS algorithms on a padded batch of 1/8-grid similarities
    (every prefix sum exact in fp32, so no tie is broken by rounding): the
    card's durations equal the CPU's."""
    from eraxvif5tts_tpu_torch.training import alignment as al

    g = torch.Generator().manual_seed(0)
    b, nt, frames = 4, 40, 300
    sim = torch.randint(-24, 25, (b, nt, frames), generator=g).float() / 8
    plens = torch.tensor([nt, 31, 12, 0])
    mlens = torch.tensor([frames, 250, 9, 0])
    for algorithm in ("window", "progressive", "viterbi"):
        want = al.monotonic_alignment_durations(sim, plens, mlens, algorithm)
        got = al.monotonic_alignment_durations(sim.to(cuda), plens.to(cuda), mlens.to(cuda),
                                               algorithm)
        assert torch.equal(got.cpu(), want), algorithm


def test_duration_focus_update_freezes_the_backbone_on_the_card(cuda):
    """A 2-block bf16 DiT with a duration predictor: the first (focus) update
    runs kernel 4a only (forward, no dq / dk-dv), leaves every backbone
    parameter and its EMA bit for bit and moves the predictor; the next (full)
    update launches all three kernels and moves the backbone."""
    from eraxvif5tts_tpu_torch.configs import ArchConfig
    from eraxvif5tts_tpu_torch.models.cfm import CFM, LossDraws
    from eraxvif5tts_tpu_torch.models.dit import DiT
    from eraxvif5tts_tpu_torch.models.duration import DurationPredictor
    from eraxvif5tts_tpu_torch.training.trainer import Trainer, make_optimizer

    arch = ArchConfig(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=64,
                      conv_layers=1, dropout=0.1)
    torch.manual_seed(0)
    dit = DiT(arch, 20, 100, compute_dtype=torch.bfloat16).to(cuda)
    for p in dit.parameters():
        torch.nn.init.normal_(p, 0.0, 0.05)
    trainer = Trainer(cfm=CFM(dit), optimizer=make_optimizer(num_warmup_updates=1,
                                                             total_updates=10),
                      duration_predictor=DurationPredictor(22, 64, 16),
                      duration_focus_updates=1)
    state = trainer.init_state()
    g = torch.Generator(device=cuda).manual_seed(1)
    b, n = 2, 256
    batch = {"mel": torch.randn((b, n, 100), generator=g, device=cuda),
             "text": torch.randint(0, 20, (b, 40), generator=g, device=cuda),
             "lens": torch.tensor([n, n - 30], device=cuda),
             "phoneme": torch.randint(1, 21, (b, 64), generator=g, device=cuda)}
    kernels = (ta.flash_forward, ta.flash_dq, ta.flash_dkv)
    for focus in (True, False):
        params = [p.detach().clone() for p in dit.parameters()]
        ema = [e.clone() for e in state.ema_params.values()]
        dur = [p.detach().clone() for p in state.dur_predictor.parameters()]
        before = [fn.launches for fn in kernels]
        state, metrics = trainer.train_step(state, batch, LossDraws.sample(g, b, n, 100, 2))
        torch.cuda.synchronize()
        counts = [fn.launches - c for fn, c in zip(kernels, before)]
        same = [torch.equal(p, p0) for p, p0 in zip(dit.parameters(), params)]
        same_ema = [torch.equal(e, e0) for e, e0 in zip(state.ema_params.values(), ema)]
        assert not any(torch.equal(p, p0) for p, p0 in zip(state.dur_predictor.parameters(), dur))
        assert metrics["applied"] == 1.0 and math.isfinite(metrics["loss"])
        if focus:
            assert counts == [2, 0, 0] and all(same) and all(same_ema)
            assert metrics["grad_norm"] == 0.0
        else:
            assert counts == [2, 2, 2] and not any(same) and not any(same_ema)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_train_attention_kernels_at_offsets_equal_the_whole_batch(cuda, dtype):
    """Kernels 4a / 4b / 4c on a rank's slice (rows 1-2 of 3, heads 2-3 of
    4) with its batch and head offsets: O, dq, dk and dv bit for bit the
    same elements of the whole batch's launch at dropout 0.1."""
    g = torch.Generator(device=cuda).manual_seed(19)
    whole = [torch.randn((3, 128, 4, 64), generator=g, device=cuda).to(dtype)
             for _ in range(4)]
    lens = torch.tensor([128, 70, 128], dtype=torch.int32, device=cuda)

    def grads(t, lens_t, b0, h0):
        args = [x.clone().requires_grad_() for x in t[:3]]
        out = ta.train_attention(*args, key_valid=lens_to_mask(lens_t, 128),
                                 dropout_rate=0.1, seed=5, batch_offset=b0, head_offset=h0)
        return [out.detach(), *torch.autograd.grad(out, args, t[3])]

    full = grads(whole, lens, 0, 0)
    part = grads([t[1:3, :, 2:4].contiguous() for t in whole], lens[1:3].contiguous(), 1, 2)
    for w, p in zip(full, part):
        assert torch.equal(w[1:3, :, 2:4], p)


# ---- head dim 128 ---------------------------------------------------------------


@pytest.mark.parametrize("with_rope", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [64, 1088, 6144])
def test_serving_attention_d128_matches_plain(cuda, no_tf32, n, dtype, with_rope):
    """Kernel 1's d = 128 instantiation (8 heads of 128, a sample whose keys
    end inside a tile beside one with none) against its plain version: bf16
    within TOL, fp32 within 2e-5 * (1 + |plain|) (the fp32 kernel's bound in
    `chip_smoke.py`), counted by head dim, a second call bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(n + 128)
    q, k, v = (torch.randn((2, n, 8, 128), generator=g, device=cuda).to(dtype)
               for _ in range(3))
    lens = torch.tensor([n - 37, 0], device=cuda)
    rope = rotary_freqs(n, 128, device=cuda) if with_rope else None
    counts = (sa.serving_attention.launches_fp32_by_head_dim if dtype == torch.float32
              else sa.serving_attention.launches_by_head_dim)
    before = dict(counts)
    got = sa.serving_attention(q, k, v, lens, rope)
    assert counts == {**before, 128: before[128] + 1}
    want = sa.serving_attention_reference(q, k, v, lens, rope)
    tol = TOL if dtype == torch.bfloat16 else 2e-5
    err = (got.float() - want.float()).abs()
    assert torch.all(err <= tol * (1 + want.float().abs())), float(err.max())
    assert torch.equal(got, sa.serving_attention(q, k, v, lens, rope))


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [192, 4096])
def test_train_attention_d128_kernels_match_plain(cuda, no_tf32, n, dtype, dropout):
    """Kernels 4a-4c's d = 128 instantiations against the plain version's
    autograd: output and q / k / v gradients, bf16 within 3e-2 relative L2
    (`chip_smoke.ATTN_REL_TOL`), fp32 within 5e-5 of each gradient's scale
    (`chip_smoke.FP32_GRAD_TOL`), each launch counted at d = 128."""
    g = torch.Generator(device=cuda).manual_seed(n + 129)
    q, k, v, dout = (torch.randn((2, n, 8, 128), generator=g, device=cuda).to(dtype)
                     for _ in range(4))
    lens = torch.tensor([n, n - 37], dtype=torch.int32, device=cuda)
    fwd, dq, dkv = ta._LAUNCHERS[dtype]
    before = [fn.launches_by_head_dim[128] for fn in (fwd, dq, dkv)]
    results = []
    for attend in (lambda *a: ta.train_attention(*a, key_valid=lens_to_mask(lens, n),
                                                 dropout_rate=dropout, seed=17),
                   lambda *a: ta.train_attention_reference(*a, lens, dropout, 17)):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attend(*args)
        results.append([out.detach(), *torch.autograd.grad(out, args, dout)])
    assert [fn.launches_by_head_dim[128] for fn in (fwd, dq, dkv)] == [b + 1 for b in before]
    for got, want in zip(*results):
        if dtype == torch.bfloat16:
            assert float((got.float() - want.float()).norm() / want.float().norm()) < 3e-2
        else:
            assert float((got - want).abs().max() / want.abs().max()) < 5e-5


@pytest.mark.parametrize("d, mode", [(128, "4a"), (128, "4a dropout"), (128, "1"),
                                     (128, "1 rotary"), (256, "4a"), (256, "4a dropout"),
                                     (256, "1")])
@pytest.mark.parametrize("n", [1088, 4160])
def test_forward_core_wide_key_tiles_match_plain(cuda, n, d, mode):
    """The forward core at d = 128 (128-key tiles: at n = 1088 and 4160, odd
    multiples of 64, the last hangs 64 keys over n and TMA fills them with
    zeros, which must count as no key) and d = 256, beside a sample with no
    valid key (every key below n averaged, the LSE log n): kernel 4a (O and
    LSE, keep = 1 and dropout 0.1) and kernel 1 (with fused rotary at d =
    128 and without) against their plain versions within TOL (the LSE within
    1e-4; kernel 1's sample with no valid key within 1e-2 relative L2 of the
    mean of V over the n keys), a second call bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(n + d)
    h = 1024 // d
    q, k, v = (torch.randn((2, n, h, d), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    lens = torch.tensor([n - 37, 0], dtype=torch.int32, device=cuda)
    if mode.startswith("4a"):
        rate = 0.1 if "dropout" in mode else 0.0
        out, lse = ta.flash_forward(q, k, v, lens, rate, 0xC0FFEE)
        _assert_close(out, ta.train_attention_reference(q, k, v, lens, rate, 0xC0FFEE))
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
        valid = torch.arange(n, device=cuda)[None, :] < lens[:, None]
        want = torch.logsumexp(s.masked_fill(~valid[:, None, None, :], -1e30), dim=-1)
        want[1] = math.log(n)
        assert float((lse - want).abs().max()) <= 1e-4
        again = ta.flash_forward(q, k, v, lens, rate, 0xC0FFEE)
        assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    else:
        rope = rotary_freqs(n, d, device=cuda) if "rotary" in mode else None
        got = sa.serving_attention(q, k, v, lens, rope)
        _assert_close(got, sa.serving_attention_reference(q, k, v, lens, rope))
        # the sample with no valid key is the mean of V over the n keys: one
        # over n + 64 (the zero rows counted) is 64 / (n + 64) off, 5.6 % at
        # n = 1088 and 1.5 % at 4160, beyond this limit (bf16 rounding: ~0.2 %)
        mean = v[1].float().mean(dim=0).expand(n, h, d)
        assert float((got[1].float() - mean).norm() / mean.norm()) < 1e-2
        assert torch.equal(got, sa.serving_attention(q, k, v, lens, rope))


# ---- head dim 256: kernel 6's roles ------------------------------------------------


def test_d256_geometry_is_the_kernels(cuda):
    """The d = 256 instantiations report the constants `ops/train_attention.py`
    states: the bf16 forward (128 rows, two stages), the backward (64 rows,
    the columns split between the warpgroups), the fp32 forward core (Q in
    shared memory, two sets of four warps, 16-key tiles) and the fp32 dq and
    dk/dv (eight warps in pairs, one split stage of 16 rows and a raw room
    for the next, filling the block's 232,448 bytes)."""
    fwd, bwd = ta.forward_geometry(2, 4096, 4, 256), ta.backward_geometry(2, 4096, 4, 256)
    built = ta.kernel_forward_geometry(256)
    assert built == {name: fwd[name] for name in built} and built["stages"] == 2
    built = ta.kernel_backward_geometry(256)
    assert built == {name: bwd[name] for name in built} and built["rows"] == 64
    geo = sa.forward_geometry_fp32(2, 4096, 4, 256)
    assert sa.kernel_geometry_fp32(256) == {key: geo[key] for key in ta.FP32_FORWARD_BUILT}
    built = ta.kernel_geometry_fp32(256)
    bwd = ta.backward_geometry_fp32(2, 4096, 4, 256)
    assert {key: built[key] for key in ta.FP32_FORWARD_BUILT} == sa.kernel_geometry_fp32(256)
    assert (built["threads"], built["sets"], built["key_tile"]) == (256, 2, 16)
    names = ("dq_threads", "dkv_threads", "bwd_stages", "dq_tile", "dkv_tile")
    assert [built[x] for x in names] == [bwd[x] for x in names] == [256, 256, 1, 16, 16]
    assert (built["dq_shared_bytes"], built["dkv_shared_bytes"]) == \
        (bwd["dq_shared_bytes"], bwd["dkv_shared_bytes"]) == (232448, 232448)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [64, 1088, 6144])
def test_serving_attention_d256_matches_plain(cuda, no_tf32, n, dtype):
    """Kernel 1's d = 256 instantiations without rotary (kernel 6's serving
    role: 4 heads of 256, a sample whose keys end inside a tile beside one
    with none) against the plain version: bf16 within TOL, fp32 within 2e-5
    * (1 + |plain|), counted by head dim, a second call bit-identical; fused
    rotary refused before any launch."""
    g = torch.Generator(device=cuda).manual_seed(n + 256)
    q, k, v = (torch.randn((2, n, 4, 256), generator=g, device=cuda).to(dtype)
               for _ in range(3))
    lens = torch.tensor([n - 37, 0], device=cuda)
    counts = (sa.serving_attention.launches_fp32_by_head_dim if dtype == torch.float32
              else sa.serving_attention.launches_by_head_dim)
    before = dict(counts)
    got = sa.serving_attention(q, k, v, lens)
    assert counts == {**before, 256: before[256] + 1}
    want = sa.serving_attention_reference(q, k, v, lens)
    tol = TOL if dtype == torch.bfloat16 else 2e-5
    err = (got.float() - want.float()).abs()
    assert torch.all(err <= tol * (1 + want.float().abs())), float(err.max())
    assert torch.equal(got, sa.serving_attention(q, k, v, lens))
    before = dict(counts)
    with pytest.raises(ValueError, match="fused rotary"):
        sa.serving_attention(q, k, v, lens, rotary_freqs(n, 256, device=cuda))
    assert counts == before


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("n", [192, 4096])
def test_train_attention_d256_kernels_match_plain(cuda, no_tf32, n, dropout):
    """Kernels 4a-4c's bf16 d = 256 instantiations (kernel 6's training
    role at keep = 1; the position-hash dropout beside it) against the plain
    version's autograd within 3e-2 relative L2, each launch counted at d =
    256."""
    g = torch.Generator(device=cuda).manual_seed(n + 257)
    q, k, v, dout = (torch.randn((2, n, 4, 256), generator=g, device=cuda).bfloat16()
                     for _ in range(4))
    lens = torch.tensor([n, n - 37], dtype=torch.int32, device=cuda)
    kernels = ta._LAUNCHERS[torch.bfloat16]
    before = [fn.launches_by_head_dim[256] for fn in kernels]
    results = []
    for attend in (lambda *a: ta.train_attention(*a, key_valid=lens_to_mask(lens, n),
                                                 dropout_rate=dropout, seed=19),
                   lambda *a: ta.train_attention_reference(*a, lens, dropout, 19)):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attend(*args)
        results.append([out.detach(), *torch.autograd.grad(out, args, dout)])
    assert [fn.launches_by_head_dim[256] for fn in kernels] == [b + 1 for b in before]
    for got, want in zip(*results):
        assert float((got.float() - want.float()).norm() / want.float().norm()) < 3e-2


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("n, lens_list", [(192, (192, 0)), (4096, (4096, 4059)),
                                          (6144, (6144, 6107)), (64, (64, 64)), (64, (9, 0)),
                                          (192, (9, 100))])
def test_train_attention_fp32_d256_kernels_match_plain(cuda, no_tf32, n, lens_list, dropout):
    """Kernels 4a-4c's fp32 d = 256 instantiations (kernel 6's fp32
    training role: `forward_sets` with the LSE, dq and dk/dv on pairs of
    warps and 16-row tiles) against the plain version's autograd: O within
    FP32_TOL * (1 + |plain|), dq / dk / dv within FP32_GRAD_TOL of their
    scale, each launch counted at d = 256, a second forward and backward
    bit-identical, and a third with both TF32 flags on bit-identical too.
    The cases: one block a head (n = 64); a sample with no valid key; 9
    valid keys, fewer than a tile (dq sees one tile, dk/dv's later blocks
    no valid key); the training shapes."""
    g = torch.Generator(device=cuda).manual_seed(n + 258)
    q, k, v, dout = (torch.randn((2, n, 4, 256), generator=g, device=cuda) for _ in range(4))
    lens = torch.tensor(lens_list, dtype=torch.int32, device=cuda)
    kernels = ta._LAUNCHERS[torch.float32]
    before = [fn.launches_by_head_dim[256] for fn in kernels]
    results = []

    def kernels_on(*a):
        return ta.train_attention(*a, key_valid=lens_to_mask(lens, n), dropout_rate=dropout,
                                  seed=23)

    def tf32_on(*a):
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            out = kernels_on(*a)
            return out, torch.autograd.grad(out, a, dout)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    for attend in (kernels_on, kernels_on, tf32_on,
                   lambda *a: ta.train_attention_reference(*a, lens, dropout, 23)):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attend(*args)
        if isinstance(out, tuple):  # the TF32 call took its gradients inside the flags
            results.append([out[0].detach(), *out[1]])
            continue
        results.append([out.detach(), *torch.autograd.grad(out, args, dout)])
    assert [fn.launches_by_head_dim[256] for fn in kernels] == [b + 3 for b in before]
    got, again, flagged, want = results
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, flagged))
    assert torch.all((got[0] - want[0]).abs() <= FP32_TOL * (1 + want[0].abs()))
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max() / b.abs().max()) <= FP32_GRAD_TOL


# ---- the fp32 forward at d = 128 and 256: two warp sets -----------------------


SET_ROLES = [(d, role) for d in (128, 256)
             for role in ("serve", "serve, rotary", "train, dropout 0", "train, dropout 0.1")
             if d == 128 or role != "serve, rotary"]  # no fused rotary at d = 256


@pytest.mark.parametrize("n", [64, 192, 1088, 4096, 6144])
@pytest.mark.parametrize("d, role", SET_ROLES)
def test_fp32_set_forward_matches_plain(cuda, no_tf32, d, role, n):
    """The two-set fp32 forward (`csrc/fp32_forward.cuh` ``forward_sets``) at
    d = 128 and 256 (h = 1024 / d) through kernel 1's fp32 mode (with and
    without rotary at 128) and kernel 4a's (the LSE, dropout 0 and 0.1), over
    its domain's edges: three samples, one with its keys ending inside a
    tile, one with none valid (every key averaged), one with 9 valid keys
    (fewer than a set's tile: set 1 sees no valid key, or none at all).
    O within FP32_TOL * (1 + |plain|), the LSE within 1e-6 relative L2 of
    the plain log sum exp (log n where no key is valid); a second call
    bit-identical, and a call with both TF32 flags on bit-identical too."""
    h = 1024 // d
    g = torch.Generator(device=cuda).manual_seed(n + d + len(role))
    q, k, v = (torch.randn((3, n, h, d), generator=g, device=cuda) for _ in range(3))
    lens = torch.tensor([n - 37, 0, 9], dtype=torch.int32, device=cuda)
    if role.startswith("serve"):
        rope = rotary_freqs(n, d, device=cuda) if role.endswith("rotary") else None
        counts = sa.serving_attention.launches_fp32_by_head_dim
        before = counts[d]

        def run():
            return [sa.serving_attention(q, k, v, lens, rope)]

        want = [sa.serving_attention_reference(q, k, v, lens, rope)]
    else:
        rate = 0.1 if role.endswith("0.1") else 0.0
        counts = ta.flash_forward_fp32.launches_by_head_dim
        before = counts[d]

        def run():
            return list(ta.flash_forward_fp32(q, k, v, lens, rate, 0xD1CE))

        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
        s[0, :, :, n - 37:] = -1e30
        s[2, :, :, 9:] = -1e30
        want_lse = torch.logsumexp(s, dim=-1)
        want_lse[1] = math.log(n)
        want = [ta.train_attention_reference(q, k, v, lens, rate, 0xD1CE), want_lse]
        del s
    got, again = run(), run()
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        flagged = run()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    torch.cuda.synchronize()
    assert counts[d] == before + 3
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all() for t in got)
    err = (got[0] - want[0]).abs()
    assert torch.all(err <= FP32_TOL * (1 + want[0].abs())), float(err.max())
    if len(want) > 1:
        assert float((got[1] - want[1]).norm() / want[1].norm()) <= 1e-6
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, flagged))
