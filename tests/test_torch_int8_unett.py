"""PyTorch port, int8 E2-TTS serving: kernel 5's plain version at ``ff_mult``
4, its geometry over the card's domain, the quantized UNetT (keys, codes,
checkpoint route, forward with ``ERAX_INT8_FF`` unset and set), the int8
E2-TTS wrapper's PCM and its quality gate, each against the JAX package on the
same numpy inputs (CPU; the JAX Pallas kernel in interpret mode).

Tolerances: quantization codes and scales bit for bit; kernel 5's plain
version 2e-5 in fp32 and one bf16 ulp of the output in bf16 (those of the DiT
int8 tests); the quantized bf16 UNetT 2e-2 of the output's scale and the int8
PCM 160 LSB, the DiT int8 tests' bounds (measured values in each test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.infer.wrapper import F5TTSWrapper as JWrapper
from eraxvif5tts_tpu.models.cfm import CFM as JCFM
from eraxvif5tts_tpu.models.unett import UNetT as JUNetT
from eraxvif5tts_tpu.models.vocos import Vocos as JVocos
from eraxvif5tts_tpu.ops import fused_matmul as jfm
from eraxvif5tts_tpu.ops import quant as jquant
from eraxvif5tts_tpu.ops import quant_ff as jquant_ff
from eraxvif5tts_tpu_torch.compression.convert import state_dict_from_jax
from eraxvif5tts_tpu_torch.infer import wrapper as twrapper
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
from eraxvif5tts_tpu_torch.models import build_backbone, modules
from eraxvif5tts_tpu_torch.models.unett import UNetT
from eraxvif5tts_tpu_torch.ops import quant, quant_ff
from test_torch_models import close, redraw
from test_torch_quant import _ff_operands
from test_torch_unett import (BUCKETS, CHARS, E2_ARCH, E2_CFG, MEL, N, REF_TEXT, SR, VOCAB,
                              _inputs, _port_unett_run, _ref_audio, _t)

QE2_ARCH = dataclasses.replace(E2_ARCH, quantized=True)
QE2_CFG = dataclasses.replace(E2_CFG, arch=QE2_ARCH)
PCM_LSB = 160


def _jax_int8_tree(params):
    """The JAX int8 wrapper's tree: `quantize_params`, then bf16 for the fp
    matrices (`wrapper.py:280-285`)."""
    return jax.tree.map(lambda p: p.astype(jnp.bfloat16)
                        if p.dtype == jnp.float32 and p.ndim > 1 else p,
                        jquant.quantize_params(params))


def _port_int8_unett(qparams):
    net = build_backbone(QE2_CFG, VOCAB)
    assert isinstance(net, UNetT)
    net.load_state_dict(state_dict_from_jax(qparams, None, QE2_CFG)[0], strict=True)
    return quant.cast_for_serving(net).eval()


@pytest.fixture(scope="module")
def params():
    jnet = JUNetT(arch=E2_ARCH, text_num_embeds=VOCAB, mel_dim=MEL)
    return redraw(JCFM(transformer=jnet).init_params(jax.random.key(0)), seed=50)


# ---------------------------------------------------------------------------
# kernel 5: the plain version at ff_mult 4 and the card's geometry


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_ff_reference_matches_pallas_at_ff_mult_4(dtype):
    """The tiny UNetT's FF shape (K 128 -> N 512 -> K2 128, ff_mult 4), M a
    multiple of 64 so that the JAX gate takes the kernel."""
    b, m, k, n, k2 = 2, 128, 128, 512, 128
    assert jquant_ff.pick_bm(m, k, n, k2) is not None
    x, jargs, targs = _ff_operands(51, b, m, k, n, k2)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want = np.asarray(jquant_ff.int8_ff_fused(jnp.asarray(x, jdt), *jargs, interpret=True)
                      .astype(jnp.float32))
    got = quant_ff.int8_ff(torch.from_numpy(x).to(tdt), *targs)
    assert got.dtype == tdt and got.shape == (b, m, k2)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    else:
        close(got.float().numpy(), want, 2 ** -7, "int8_ff bf16 ff_mult 4")


@pytest.mark.parametrize("k,n,k2,cluster,gemm2", [
    (1024, 2048, 1024, 4, 128), (1024, 4096, 1024, 8, 64), (768, 1536, 768, 3, 128),
    (768, 3072, 768, 6, 64), (512, 1024, 512, 2, 128), (128, 512, 128, 1, 64)])
def test_int8_ff_geometry_covers_every_preset(k, n, k2, cluster, gemm2):
    """Every preset's FF (dim 768 / 1024 at ff_mult 2 / 4) is inside the
    kernel's domain: a cluster of N / 512 CTAs each owning a 512-column slab
    (two warpgroups of 256), GEMM 2's output columns split evenly over the
    CTAs and their two warpgroups, the shared memory within a block's."""
    geo = quant_ff.int8_ff_geometry(k, n, k2)
    assert geo["cluster"] == cluster and geo["gemm2_columns"] == gemm2
    assert geo["cluster"] * geo["slab"] == n and geo["slab"] == 2 * geo["wg_columns"]
    assert geo["cluster"] * geo["out_columns"] == k2 == 2 * cluster * gemm2
    assert geo["shared_bytes"] == 182144 <= quant_ff.SMEM_LIMIT
    assert geo["gemm2_stages"] == (6 if gemm2 == 64 else 3)
    assert geo["steps"] == (k // 128, n // 128) and geo["steps"][1] >= geo["stages"]
    assert geo["w1_map"]["box"] == (128, 256) and geo["w2_map"]["box"] == (128, 2 * gemm2)
    assert quant_ff.int8_ff_grid(2 * 1088, n) == 34 * cluster


@pytest.mark.parametrize("k,n,k2", [(1024, 5120, 1024), (1088, 2048, 1024), (2048, 4096, 2048),
                                    (96, 512, 128), (1024, 2048, 768), (1024, 1536, 1024),
                                    (1024, 2000, 1024), (768, 2048, 768)])
def test_int8_ff_geometry_refuses_outside_the_domain(k, n, k2):
    with pytest.raises(ValueError, match="the kernel takes"):
        quant_ff.int8_ff_geometry(k, n, k2)


# ---------------------------------------------------------------------------
# the quantized UNetT


def test_unett_quantized_keys_and_codes_match_quantize_params(params):
    """`quantize_state_dict(..., "UNetT")` on the fp weights and the JAX
    `quantize_params` tree through the port's converter: the same keys (the
    six projections of each layer, never `skip_proj`), the same codes and
    scales bit for bit, the rest untouched."""
    qtree = jquant.quantize_params(params)
    assert all("kernel_q" not in qtree[f"skip_proj_{i}"] and "kernel" in qtree[f"skip_proj_{i}"]
               for i in range(E2_ARCH.depth // 2, E2_ARCH.depth))
    fp_sd = state_dict_from_jax(params, None, E2_CFG)[0]
    via_port = quant.quantize_state_dict(fp_sd, E2_ARCH.depth, "UNetT")
    via_jax = state_dict_from_jax(qtree, None, QE2_CFG)[0]
    assert via_port.keys() == via_jax.keys()
    keys = quant.quantized_weight_keys(E2_ARCH.depth, "UNetT")
    assert len(keys) == 6 * E2_ARCH.depth
    assert {".".join(k.split(".")[3:-1]) for k in keys} == {
        "to_q", "to_k", "to_v", "to_out.0", "ff.0.0", "ff.2"}
    assert not any(".0.weight" in k and k.count(".") == 3 for k in keys)  # layers.i.0 = skip_proj
    assert set(fp_sd) - set(via_port) == set(keys)
    for key, value in via_port.items():
        assert value.dtype == via_jax[key].dtype, key
        torch.testing.assert_close(value, via_jax[key], rtol=0, atol=0, msg=key)


def test_quantized_jax_unett_tree_loads_strict(params):
    net = _port_int8_unett(_jax_int8_tree(params))
    sd = net.state_dict()
    assert sd["layers.3.4.ff.2.weight_q"].dtype == torch.int8
    assert sd["layers.3.4.ff.2.weight_q"].shape == (E2_ARCH.dim, 4 * E2_ARCH.dim)
    assert sd["layers.3.2.to_q.weight_scale"].dtype == torch.float32
    assert sd["layers.3.0.weight"].dtype == torch.bfloat16  # skip_proj: unquantized
    assert sd["layers.3.3.g"].dtype == torch.float32
    assert isinstance(net.layers[3][4].ff[0][0], quant.QuantLinear)
    assert isinstance(net.layers[3][0], torch.nn.Linear)


@pytest.mark.parametrize("int8_ff", [False, True])
def test_quantized_unett_matches_jax(params, monkeypatch, int8_ff):
    """The quantized UNetT (bf16 compute) against the JAX quantized UNetT on
    the same tree, 128 positions with the time token: the QuantLinear chain
    with ``ERAX_INT8_FF`` unset, the one-kernel FF with it set (the JAX side
    forced on the CPU by its test hook, the Pallas kernel in interpret mode).
    Never kernel 2: a quantized layer's FF is unfused. Tolerance 2e-2 of the
    output's scale, the quantized DiT test's (measured 7.7e-3 / 6.5e-3; the JAX
    norms keep their fp32 gain, so their outputs reach the quantizers
    unrounded where the port's are bf16, and a few activation codes flip)."""
    monkeypatch.delenv("ERAX_INT8_FF", raising=False)
    if int8_ff:
        monkeypatch.setenv("ERAX_INT8_FF", "1")
        monkeypatch.setattr(jfm, "_FORCE_FOR_TESTS", True)
        assert jquant_ff.use_int8_ff(N + 1, 128, 512, 128)
    inputs = _inputs()
    x, cond, text, time, drop, lens = inputs
    mask = np.arange(N)[None] < lens[:, None]
    qtree = _jax_int8_tree(params)
    jnet = JUNetT(arch=QE2_ARCH, text_num_embeds=VOCAB, mel_dim=MEL, compute_dtype=jnp.bfloat16)

    def jax_run(p):
        te = jnet.apply({"params": p}, text, N, drop, method="embed_text")
        return jnet.apply({"params": p}, x, cond, te, time, drop, mask, method="run")

    want = jax.jit(jax_run)(qtree)
    calls = {"ff": 0, "ln_mod": 0}
    plain_ff, plain_ln = modules.int8_ff, modules.ln_mod_matmul

    def count(name, fn):
        return lambda *a, **kw: calls.__setitem__(name, calls[name] + 1) or fn(*a, **kw)

    monkeypatch.setattr(modules, "int8_ff", count("ff", plain_ff))
    monkeypatch.setattr(modules, "ln_mod_matmul", count("ln_mod", plain_ln))
    got = _port_unett_run(_port_int8_unett(qtree), inputs)
    assert calls == {"ff": E2_ARCH.depth if int8_ff else 0, "ln_mod": 0}
    assert got.dtype == torch.float32 and got.shape == (2, N, MEL)
    assert np.isfinite(got.numpy()).all()
    close(got.numpy(), want, 2e-2, f"quantized UNetT.run int8_ff={int8_ff}")


# ---------------------------------------------------------------------------
# the int8 E2-TTS wrapper


@pytest.fixture(scope="module")
def int8_wrappers(params):
    jcfm = JCFM(transformer=JUNetT(arch=E2_ARCH, text_num_embeds=len(CHARS), mel_dim=MEL))
    wparams = redraw(jcfm.init_params(jax.random.key(0)), seed=52)
    vparams = redraw(jax.jit(JVocos().init)(jax.random.key(1), jnp.zeros((1, MEL, 8)))["params"],
                     seed=53, std=0.05)
    vparams["head_out"]["bias"] += 2.0
    common = dict(model_cfg=E2_CFG, vocab_char_map=CHARS, nfe_step=4,
                  params=jquant.quantize_params(wparams), vocoder_params=vparams,
                  compute_dtype="int8", **BUCKETS)
    jw = JWrapper(**common)
    tw = F5TTSWrapper(device="cpu", **common)
    jref = jw.preprocess_reference(ref_audio=_ref_audio(), ref_sample_rate=SR, ref_text=REF_TEXT)
    return jw, jref, tw


def test_int8_e2tts_sample_vocode_pcm_matches_jax(int8_wrappers):
    """The int8 UNetT's fused sample-and-vocode step against the JAX int8
    wrapper's, same quantized tree, the JAX noise handed in: 160 LSB, the DiT
    int8 test's bound (measured 68 LSB on a 2932 LSB peak)."""
    jw, jref, tw = int8_wrappers
    assert isinstance(tw.transformer, UNetT) and tw.transformer.arch.quantized
    rng = np.random.default_rng(54)
    text = np.full((1, 64), -1, np.int32)
    text[0, :55] = rng.integers(0, len(CHARS), 55)
    n_ref, bucket, duration = jref.n_frames, 127, 120
    vstart = n_ref - twrapper.VOCODE_MARGIN_FRAMES
    key = jax.random.key(55)
    static = dict(steps=4, cfg_strength=2.0, sway=-1.0, max_duration=bucket,
                  vocode_start=vstart, gen_start=n_ref - vstart)
    want, _ = jw._sample_vocode_jit(
        jw.params, jw.vocoder_params, jref.mel, jnp.asarray(text), jnp.asarray([duration]),
        jnp.asarray([n_ref]), key, jnp.asarray(1.0, jnp.float32), **static)
    noise = np.array(jax.random.normal(key, (bucket, MEL), jnp.float32))
    got, _ = tw._sample_vocode(_t(np.array(jref.mel)), _t(text).long(), torch.tensor([duration]),
                               torch.tensor([n_ref]), _t(noise), 1.0, **static)
    want = np.asarray(want).astype(np.int32)
    assert got.dtype == torch.int16 and got.shape == want.shape
    assert np.abs(want).max() > 1000
    diff = np.abs(got.numpy().astype(np.int32) - want)
    assert diff.max() <= PCM_LSB, f"PCM differs by {diff.max()} LSB"


def test_int8_e2tts_generate_batch_serves(int8_wrappers):
    """`generate` and `generate_batch` over the int8 UNetT: finite audio, the
    longer text the longer wave."""
    _, _, tw = int8_wrappers
    ref = tw.preprocess_reference(ref_audio=_ref_audio(), ref_sample_rate=SR, ref_text=REF_TEXT)
    waves = tw.generate_batch(["first words.", "a longer second one."], ref=ref, nfe_step=2,
                              seed=3, use_pinyin=False)
    assert len(waves) == 2 and len(waves[1]) > len(waves[0]) > 0
    assert all(np.isfinite(w).all() for w in waves)
    wave = tw.generate("one more.", ref=ref, nfe_step=2, seed=4, use_pinyin=False)
    assert len(wave) > 0 and np.isfinite(wave).all()


def test_int8_e2tts_quality_gate_refuses_and_serves(monkeypatch):
    """``int8_validate=True`` quantizes a UNetT at load and runs
    `quant_divergence` against a bf16 twin of the same weights, at 255
    frames (the UNetT's 64k - 1 rule), refusing past the threshold."""
    monkeypatch.setattr(quant, "INT8_REL_MSE_THRESHOLD", -1.0)
    kwargs = dict(model_cfg=E2_CFG, vocab_char_map=CHARS, compute_dtype="int8",
                  int8_validate=True, device="cpu")
    with pytest.raises(ValueError, match="quality gate failed"):
        F5TTSWrapper(**kwargs)
    monkeypatch.setattr(quant, "INT8_REL_MSE_THRESHOLD", float("inf"))
    w = F5TTSWrapper(**kwargs)
    report = w.int8_report
    assert report["passes_gate"] and np.isfinite(report["lsd_db"])
    assert 0.0 < report["rel_mse"] < 1e-2 and 0.0 < report["forward_rel_mse"] < 1e-2
    assert isinstance(w.transformer, UNetT)
    assert w.transformer.layers[0][2].to_q.weight_q.dtype == torch.int8
    assert w.transformer.layers[E2_ARCH.depth - 1][0].weight.dtype == torch.bfloat16
