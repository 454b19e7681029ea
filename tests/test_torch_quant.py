"""PyTorch port, int8 W8A8 serving: `ops/quant.py`, kernel 5's plain version
(`ops/quant_ff.py`), kernel 3's plain version (`ops/fused_matmul.py`
`matmul_gate_res`), the quantized DiT, the checkpoint routes and the
quality gate, each against the JAX package on the same numpy inputs (CPU;
the JAX Pallas kernels in interpret mode).

Tolerances: quantization codes and scales bit for bit (both sides divide in
fp32 and round half to even); the int8 GEMM exactly (int32 sums) and its
dequantization to fp32 rounding (1e-6 of scale); the fp32 fused FF and the
gated residual 2e-5 (fp32 sums in other orders: those of the JAX tests);
the quantized bf16 DiT and the int8 PCM a bound stated per test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.infer.wrapper import F5TTSWrapper as JWrapper
from eraxvif5tts_tpu.models.dit import DiT as JDiT
from eraxvif5tts_tpu.models.vocos import Vocos as JVocos
from eraxvif5tts_tpu.ops import fused_matmul as jfm
from eraxvif5tts_tpu.ops import quant as jquant
from eraxvif5tts_tpu.ops import quant_ff as jquant_ff
from eraxvif5tts_tpu_torch.compression.convert import state_dict_from_jax
from eraxvif5tts_tpu_torch.infer import wrapper as twrapper
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
from eraxvif5tts_tpu_torch.models.dit import DiT
from eraxvif5tts_tpu_torch.ops import fused_matmul as tfm
from eraxvif5tts_tpu_torch.ops import quant, quant_ff
from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask
from test_torch_models import ARCH, CFG, MEL, VOCAB, close, redraw, tiny_params

QARCH = dataclasses.replace(ARCH, quantized=True)
QCFG = dataclasses.replace(CFG, arch=QARCH)


def _jax_int8_tree(params):
    """The JAX int8 wrapper's tree: `quantize_params`, then bf16 for the fp
    matrices (`wrapper.py:280-285`)."""
    return jax.tree.map(lambda p: p.astype(jnp.bfloat16)
                        if p.dtype == jnp.float32 and p.ndim > 1 else p,
                        jquant.quantize_params(params))


def _port_int8_dit(qparams):
    dit = DiT(QARCH, VOCAB, MEL)
    dit.load_state_dict(state_dict_from_jax(qparams, None, QCFG)[0], strict=True)
    return quant.cast_for_serving(dit).eval()


@pytest.fixture(scope="module")
def params():
    return tiny_params(seed=30)


def test_quantize_weight_bit_identical_to_jax():
    rng = np.random.default_rng(0)
    w = (0.05 * rng.standard_normal((192, 96))).astype(np.float32)  # [in, out]
    w[:, 3] = 0.0  # an all-zero channel: the 1e-8 floor of the scale
    w[:, 5] *= 1e4
    want_q, want_s = jquant.quantize_weight(jnp.asarray(w))
    got_q, got_s = quant.quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy().T, np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_quantize_state_dict_touches_exactly_the_jax_keys_bit_for_bit(params):
    """`quantize_state_dict` on the fp weights and the JAX `quantize_params`
    tree carried through the port's converter give the same state dict:
    the same keys, the same int8 codes and scales, the rest untouched."""
    qtree = jquant.quantize_params(params)
    quantized_paths = []

    def walk(tree, path):
        for name, node in tree.items():
            if isinstance(node, dict):
                if "kernel_q" in node:
                    quantized_paths.append(path + (name,))
                walk(node, path + (name,))

    walk(qtree, ())
    assert len(quantized_paths) == 6 * ARCH.depth
    fp_sd = state_dict_from_jax(params, None, CFG)[0]
    via_port = quant.quantize_state_dict(fp_sd, ARCH.depth)
    via_jax = state_dict_from_jax(qtree, None, QCFG)[0]
    assert via_port.keys() == via_jax.keys()
    q_keys = {k for k in via_port if k.endswith((".weight_q", ".weight_scale"))}
    assert len(q_keys) == 2 * len(quantized_paths)
    assert set(fp_sd) - set(via_port) == {k[:-len("_q")] for k in q_keys if k.endswith("_q")}
    assert {k.rsplit(".", 1)[0].split(".", 2)[2] for k in q_keys} == {
        "attn.to_q", "attn.to_k", "attn.to_v", "attn.to_out.0", "ff.ff.0.0", "ff.ff.2"}
    for key, value in via_port.items():
        assert value.dtype == via_jax[key].dtype, key
        torch.testing.assert_close(value, via_jax[key], rtol=0, atol=0, msg=key)


def test_quantized_jax_tree_loads_strict(params):
    dit = _port_int8_dit(_jax_int8_tree(params))
    sd = dit.state_dict()
    assert sd["transformer_blocks.1.ff.ff.2.weight_q"].dtype == torch.int8
    assert sd["transformer_blocks.1.ff.ff.2.weight_q"].shape == (ARCH.dim, 2 * ARCH.dim)
    assert sd["transformer_blocks.1.ff.ff.2.weight_scale"].dtype == torch.float32
    assert sd["transformer_blocks.1.ff.ff.2.bias"].dtype == torch.float32
    assert sd["transformer_blocks.1.attn_norm.linear.weight"].dtype == torch.bfloat16
    assert sd["proj_out.weight"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 128)).astype(np.float32)
    w = (0.05 * rng.standard_normal((128, 96))).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    w_q, s = jquant.quantize_weight(jnp.asarray(w))
    want = jquant.int8_matmul(jnp.asarray(x, jdt), w_q, s, out_dtype=jnp.float32)
    got = quant.int8_matmul(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(np.ascontiguousarray(np.asarray(w_q).T)),
                            torch.from_numpy(np.array(s)), out_dtype=torch.float32)
    close(got.numpy(), want, 1e-6, "int8_matmul")
    # the int32 products and their codes agree exactly
    x_q, _ = quant.quantize_rows(torch.from_numpy(x).to(tdt).float())
    acc = quant.int_mm(x_q, torch.from_numpy(np.ascontiguousarray(np.asarray(w_q).T)))
    np.testing.assert_array_equal(
        acc.numpy(), x_q.numpy().astype(np.int64) @ np.asarray(w_q).astype(np.int64))


def _ff_operands(seed, b, m, k, n, k2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, m, k)).astype(np.float32)
    w1, s1 = jquant.quantize_weight(jnp.asarray(rng.standard_normal((k, n)) * 0.05, jnp.float32))
    w2, s2 = jquant.quantize_weight(jnp.asarray(rng.standard_normal((n, k2)) * 0.05, jnp.float32))
    b1 = (0.1 * rng.standard_normal((n,))).astype(np.float32)
    b2 = (0.1 * rng.standard_normal((k2,))).astype(np.float32)
    jax_args = (w1, s1, jnp.asarray(b1), w2, s2, jnp.asarray(b2))
    torch_args = tuple(torch.from_numpy(np.array(a)) for a in (
        np.asarray(w1).T, np.asarray(s1), b1, np.asarray(w2).T, np.asarray(s2), b2))
    return x, jax_args, torch_args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_ff_reference_matches_pallas_interpret(dtype):
    b, m, k, n, k2 = 2, 128, 256, 512, 256  # the JAX test's shapes
    x, jargs, targs = _ff_operands(7, b, m, k, n, k2)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want = jquant_ff.int8_ff_fused(jnp.asarray(x, jdt), *jargs, interpret=True)
    got = quant_ff.int8_ff(torch.from_numpy(x).to(tdt), *targs)
    assert got.dtype == tdt and got.shape == (b, m, k2)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    else:  # at most one bf16 ulp of the output (2^-7 of its scale) apart
        close(got.float().numpy(), want, 2 ** -7, "int8_ff bf16")


@pytest.mark.parametrize("mask_rows", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_gate_res_matches_pallas_interpret(mask_rows, dtype):
    rng = np.random.default_rng(1)
    b, m, k, n = 2, 64, 128, 256  # the JAX test's shapes
    h = rng.standard_normal((b, m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    bias = (0.1 * rng.standard_normal((n,))).astype(np.float32)
    gate = rng.standard_normal((b, n)).astype(np.float32)
    res = rng.standard_normal((b, m, n)).astype(np.float32)
    lens = np.array([64, 40], np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want = jfm.matmul_gate_res(*(jnp.asarray(a, jdt) for a in (h, w, bias, gate, res)),
                               lens=jnp.asarray(lens), mask_rows=mask_rows, interpret=True)
    got = tfm.matmul_gate_res(*(torch.from_numpy(a).to(tdt) for a in (h,)),
                              torch.from_numpy(np.ascontiguousarray(w.T)).to(tdt),
                              *(torch.from_numpy(a).to(tdt) for a in (bias, gate, res)),
                              lens=torch.from_numpy(lens), mask_rows=mask_rows)
    assert got.dtype == tdt and got.shape == (b, m, n)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    else:
        close(got.float().numpy(), want, 2 ** -7, "matmul_gate_res bf16")
    if mask_rows:  # masked rows are the residual, bit for bit
        np.testing.assert_array_equal(got[1, 40:].float().numpy(),
                                      torch.from_numpy(res[1, 40:]).to(tdt).float().numpy())


@pytest.mark.parametrize("int8_ff", [False, True])
def test_quantized_dit_matches_jax(params, monkeypatch, int8_ff):
    """The quantized DiT (bf16 compute) against the JAX quantized DiT on the
    same tree: the QuantLinear chain with ``ERAX_INT8_FF`` unset, the one-kernel
    FF with it set (JAX side: the Pallas kernel in interpret mode, admitted
    on the CPU by its test hook). Tolerance 2e-2 of the output's scale, the
    bf16 DiT test's (measured 5.8e-3 and 5.2e-3: bf16 rounded at other
    points flips a few int8 activation codes, each 1/127 of a row's amax)."""
    from test_torch_models import _inputs

    monkeypatch.delenv("ERAX_INT8_FF", raising=False)
    if int8_ff:
        monkeypatch.setenv("ERAX_INT8_FF", "1")
        monkeypatch.setattr(jfm, "_FORCE_FOR_TESTS", True)
    assert quant_ff.use_int8_ff() == int8_ff
    x, cond, text, time, drop, lens = _inputs()
    mask = np.arange(128)[None] < lens[:, None]
    qtree = _jax_int8_tree(params)
    jd = JDiT(arch=QARCH, text_num_embeds=VOCAB, mel_dim=MEL, compute_dtype=jnp.bfloat16)

    def jax_run(p, x, cond, text, time, drop, mask):
        te = jd.apply({"params": p}, text, 128, drop, method="embed_text")
        return jd.apply({"params": p}, x, cond, te, time, drop, mask, method="run")

    want = jax.jit(jax_run)(qtree, x, cond, text, time, drop, mask)
    dit = _port_int8_dit(qtree)
    launches = quant_ff.int8_ff.launches
    with torch.no_grad():
        te = dit.embed_text(torch.from_numpy(text).long(), 128, torch.from_numpy(drop))
        got = dit.run(torch.from_numpy(x), torch.from_numpy(cond), te, torch.from_numpy(time),
                      torch.from_numpy(drop), lens_to_mask(torch.from_numpy(lens), 128))
    assert quant_ff.int8_ff.launches == launches  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    close(got.numpy(), want, 2e-2, f"quantized DiT.run int8_ff={int8_ff}")


def test_quantized_dit_refuses_training(params):
    dit = _port_int8_dit(_jax_int8_tree(params)).train()
    x = torch.zeros(1, 64, MEL)
    with pytest.raises(ValueError, match="serves only"):
        dit(x, x, torch.zeros(1, 8, dtype=torch.long), torch.zeros(1),
            torch.zeros(1, dtype=torch.bool), torch.zeros(1, dtype=torch.bool))


VOCAB_MAP = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,!?'-0123456")}
BUCKETS = dict(duration_buckets=(64, 128, 192, 256), text_buckets=(64,))
SR = 24000


def _ref_audio():
    t = np.arange(int(SR * 0.8)) / SR
    return (0.2 * np.sin(2 * np.pi * 190 * t) + 0.05 * np.sin(2 * np.pi * 900 * t)
            ).astype(np.float32)


def test_int8_quality_gate_refuses_and_serves(params, monkeypatch):
    """``int8_validate=True`` runs `quant_divergence` against a bf16 twin of
    the same weights and refuses past the threshold (as `test_quant.py`'s
    gate test)."""
    monkeypatch.setattr(quant, "INT8_REL_MSE_THRESHOLD", -1.0)
    kwargs = dict(model_cfg=CFG, vocab_char_map=VOCAB_MAP, compute_dtype="int8",
                  int8_validate=True, device="cpu")
    with pytest.raises(ValueError, match="quality gate failed"):
        F5TTSWrapper(**kwargs)
    monkeypatch.setattr(quant, "INT8_REL_MSE_THRESHOLD", float("inf"))
    w = F5TTSWrapper(**kwargs)
    report = w.int8_report
    assert report["passes_gate"] and np.isfinite(report["lsd_db"])
    assert 0.0 < report["rel_mse"] < 1e-2 and 0.0 < report["forward_rel_mse"] < 1e-2
    assert w.transformer.transformer_blocks[0].attn.to_q.weight_q.dtype == torch.int8


def test_quant_divergence_matches_jax_on_the_jax_fixture(params):
    """The port's gate statistic on the JAX gate's own draws (fixture, noise
    key 3, forward input key 11), bf16 against int8 of the same weights:
    the same magnitudes (the two DiTs round bf16 at other points, so the
    statistics agree to a factor, not to digits)."""
    from eraxvif5tts_tpu.models.cfm import CFM as JCFM

    from eraxvif5tts_tpu_torch.models.cfm import CFM
    from test_torch_models import port_dit, tiny_jax_dit

    steps, max_duration = 2, 256
    fp_cfm = JCFM(transformer=tiny_jax_dit(jnp.bfloat16))
    q_cfm = JCFM(transformer=JDiT(arch=QARCH, text_num_embeds=VOCAB, mel_dim=MEL,
                                  compute_dtype=jnp.bfloat16))
    want = jquant.quant_divergence(fp_cfm, params, q_cfm, _jax_int8_tree(params),
                                   steps=steps, max_duration=max_duration)
    cond, text, duration, lens = jquant._fixed_inputs(fp_cfm, max_duration)
    inputs = {"cond": cond, "text": text, "duration": duration, "lens": lens,
              "noise": jax.random.normal(jax.random.key(3), (max_duration, MEL)),
              "x_in": 0.5 * jax.random.normal(jax.random.key(11), (1, max_duration, MEL))}
    inputs = {k: np.asarray(v) for k, v in inputs.items()}
    got = quant.quant_divergence(CFM(port_dit(params, torch.bfloat16)),
                                 CFM(_port_int8_dit(_jax_int8_tree(params))),
                                 steps=steps, max_duration=max_duration, inputs=inputs)
    assert got["passes_gate"] and want["passes_gate"]
    for key in ("rel_mse", "lsd_db", "forward_rel_mse"):
        assert want[key] / 4 < got[key] < 4 * want[key], (key, got[key], want[key])


@pytest.fixture(scope="module")
def int8_wrappers(params):
    vparams = redraw(jax.jit(JVocos().init)(jax.random.key(1), jnp.zeros((1, MEL, 8)))["params"],
                     seed=31, std=0.05)
    vparams["head_out"]["bias"] += 2.0
    qtree = jquant.quantize_params(params)
    common = dict(model_cfg=CFG, vocab_char_map=VOCAB_MAP, nfe_step=4, params=qtree,
                  vocoder_params=vparams, compute_dtype="int8", **BUCKETS)
    jw = JWrapper(**common)
    tw = F5TTSWrapper(device="cpu", **common)
    jref = jw.preprocess_reference(ref_audio=_ref_audio(), ref_sample_rate=SR,
                                   ref_text="hello there, this is the reference voice")
    return jw, jref, tw


def test_int8_sample_vocode_pcm_matches_jax(int8_wrappers):
    """The int8 fused sample-and-vocode step against the JAX int8 wrapper's,
    same quantized tree, the JAX noise handed in. Tolerance 160 LSB, 0.5 %
    of full scale (measured 78 LSB on a 3581 LSB peak: the bf16 DiT's
    rounding, and the int8 activation codes it flips, through four steps
    and the vocoder)."""
    jw, jref, tw = int8_wrappers
    rng = np.random.default_rng(32)
    text = np.full((1, 64), -1, np.int32)
    text[0, :55] = rng.integers(0, len(VOCAB_MAP), 55)
    n_ref, bucket, duration = jref.n_frames, 128, 120
    vstart = n_ref - twrapper.VOCODE_MARGIN_FRAMES
    key = jax.random.key(33)
    static = dict(steps=4, cfg_strength=2.0, sway=-1.0, max_duration=bucket,
                  vocode_start=vstart, gen_start=n_ref - vstart)
    want, _ = jw._sample_vocode_jit(
        jw.params, jw.vocoder_params, jref.mel, jnp.asarray(text), jnp.asarray([duration]),
        jnp.asarray([n_ref]), key, jnp.asarray(1.0, jnp.float32), **static)
    noise = np.array(jax.random.normal(key, (bucket, MEL), jnp.float32))
    got, _ = tw._sample_vocode(
        torch.from_numpy(np.array(jref.mel)), torch.from_numpy(text).long(),
        torch.tensor([duration]), torch.tensor([n_ref]), torch.from_numpy(noise), 1.0, **static)
    want = np.asarray(want).astype(np.int32)
    assert got.dtype == torch.int16 and got.shape == want.shape
    assert np.abs(want).max() > 1000
    diff = np.abs(got.numpy().astype(np.int32) - want)
    assert diff.max() <= 160, f"PCM differs by {diff.max()} LSB"


def test_int8_checkpoint_routes_agree(params, tmp_path):
    """A reference checkpoint quantized at load by the JAX wrapper
    (`quantize_params`) and by the port wrapper (`quantize_state_dict`):
    the same int8 codes and scales, bit for bit, and the same bf16 / fp32
    weights beside them."""
    from eraxvif5tts_tpu.compression.convert import backbone_params_to_torch

    sd = backbone_params_to_torch(params, "DiT", ARCH.depth, ARCH.conv_layers)
    torch.save({f"ema_model.{k}": torch.from_numpy(np.array(v)) for k, v in sd.items()},
               tmp_path / "model.pt")
    common = dict(model_cfg=CFG, vocab_char_map=VOCAB_MAP, compute_dtype="int8",
                  ckpt_path=str(tmp_path / "model.pt"))
    jw = JWrapper(**common)
    tw = F5TTSWrapper(device="cpu", **common)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jw.params), None, QCFG)[0]
    got = tw.transformer.state_dict()
    assert got.keys() == want.keys()
    for key, value in got.items():
        ref = want[key].to(value.dtype)
        torch.testing.assert_close(value, ref, rtol=0, atol=0, msg=key)
