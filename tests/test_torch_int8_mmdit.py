"""PyTorch port, the int8 MMDiT: its quantized keys, codes and scales against
`quantize_params`, the quantized MMDiT with ``ERAX_INT8_FF`` unset (the
QuantLinear chain) and set (kernel 5's plain version on both streams), its
quality gate against the JAX gate, and the int8 wrapper's gate and PCM
against the JAX int8 wrapper's, on the same numpy inputs (CPU; the JAX
Pallas kernel in interpret mode).

Tolerances: codes and scales bit for bit; the quantized bf16 MMDiT 2e-2 of
the output's scale and the int8 PCM 160 LSB, the DiT int8 tests' bounds;
the gate's statistics within a factor of 4 of the JAX gate's, as the DiT's.
"""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.infer.wrapper import F5TTSWrapper as JWrapper
from eraxvif5tts_tpu.models.vocos import Vocos as JVocos
from eraxvif5tts_tpu.ops import fused_matmul as jfm
from eraxvif5tts_tpu.ops import quant as jquant
from eraxvif5tts_tpu.ops import quant_ff as jquant_ff
from eraxvif5tts_tpu_torch.compression.convert import state_dict_from_jax
from eraxvif5tts_tpu_torch.infer import wrapper as twrapper
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
from eraxvif5tts_tpu_torch.ops import quant
from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask
from test_torch_mmdit_training import _one_torch_thread  # noqa: F401 (autouse here too)
from test_torch_models import MEL, close, redraw
from test_torch_quant import BUCKETS, SR, VOCAB_MAP, _jax_int8_tree, _ref_audio


def _mm_setup():
    from eraxvif5tts_tpu.configs import ArchConfig, ModelConfig

    from test_torch_mmdit import jax_params

    arch = ArchConfig(dim=128, depth=3, heads=2, dim_head=64, ff_mult=2, dropout=0.0)
    cfg = ModelConfig(name="tiny-mmdit", backbone="MMDiT", arch=arch)
    qcfg = dataclasses.replace(cfg, arch=dataclasses.replace(arch, quantized=True))
    return cfg, qcfg, jax_params(arch, seed=70, text_num_embeds=len(VOCAB_MAP))


@pytest.fixture(scope="module")
def mm():
    return _mm_setup()


def _port_int8_mmdit(qcfg, qparams):
    from eraxvif5tts_tpu_torch.models import build_backbone

    net = build_backbone(qcfg, len(VOCAB_MAP))
    net.load_state_dict(state_dict_from_jax(qparams, None, qcfg)[0], strict=True)
    return quant.cast_for_serving(net).eval()


def test_mmdit_quantized_keys_and_codes_match_quantize_params(mm):
    """`quantized_weight_keys(depth, "MMDiT")` is the set of Dense kernels
    `quantize_params` rewrites, mapped through `mmdit_rules`: twelve a block
    (both streams' q / k / v and output projections, both feed-forwards'
    two), nine in the last (no `to_out_c`, no `ff_c`); `quantize_state_dict`
    and the JAX tree through the converter give the same codes and scales
    bit for bit, every other entry untouched."""
    from eraxvif5tts_tpu_torch.compression.convert import mmdit_rules

    cfg, qcfg, params = mm
    depth = cfg.arch.depth
    qtree = jquant.quantize_params(params)
    rewritten = []

    def walk(tree, path):
        for name, node in tree.items():
            if isinstance(node, dict):
                if "kernel_q" in node:
                    rewritten.append(path + (name, "kernel"))
                walk(node, path + (name,))

    walk(qtree, ())
    by_path = {path: key for key, path, _, _ in mmdit_rules(depth)}
    keys = quant.quantized_weight_keys(depth, "MMDiT")
    assert sorted(keys) == sorted(by_path[p] for p in rewritten)
    assert len(keys) == 12 * (depth - 1) + 9
    last = {k.split(".", 2)[2] for k in keys if k.startswith(f"transformer_blocks.{depth - 1}.")}
    assert last == {"attn.to_q.weight", "attn.to_k.weight", "attn.to_v.weight",
                    "attn.to_q_c.weight", "attn.to_k_c.weight", "attn.to_v_c.weight",
                    "attn.to_out.0.weight", "ff_x.ff.0.0.weight", "ff_x.ff.2.weight"}
    fp_sd = state_dict_from_jax(params, None, cfg)[0]
    via_port = quant.quantize_state_dict(fp_sd, depth, "MMDiT")
    via_jax = state_dict_from_jax(qtree, None, qcfg)[0]
    assert via_port.keys() == via_jax.keys()
    assert set(fp_sd) - set(via_port) == set(keys)
    for key, value in via_port.items():
        assert value.dtype == via_jax[key].dtype, key
        torch.testing.assert_close(value, via_jax[key], rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("int8_ff", [False, True])
def test_quantized_mmdit_matches_jax(mm, monkeypatch, int8_ff):
    """The quantized MMDiT (bf16 compute) against the JAX quantized MMDiT on
    the same tree, mel 128 frames and a 64-token text: the QuantLinear chain
    with ``ERAX_INT8_FF`` unset, the one-kernel FF with it set on both
    streams (22 blocks' ``ff_x`` and 21 ``ff_c`` on the card; here 3 and 2),
    the JAX side forced on the CPU by its test hook (the Pallas kernel in
    interpret mode). Tolerance 2e-2 of the output's scale, the quantized
    DiT test's."""
    from eraxvif5tts_tpu.models import mmdit as jmmdit

    from eraxvif5tts_tpu_torch.models import modules

    cfg, qcfg, params = mm
    n, nt = 128, 64
    monkeypatch.delenv("ERAX_INT8_FF", raising=False)
    if int8_ff:
        monkeypatch.setenv("ERAX_INT8_FF", "1")
        monkeypatch.setattr(jfm, "_FORCE_FOR_TESTS", True)
        assert jquant_ff.use_int8_ff(nt, 128, 256, 128) and jquant_ff.use_int8_ff(n, 128, 256, 128)
    rng = np.random.default_rng(71)
    x, cond = (rng.standard_normal((2, n, MEL)).astype(np.float32) for _ in range(2))
    text = np.full((2, nt), -1, np.int32)
    text[0, :50] = rng.integers(0, len(VOCAB_MAP), 50)
    text[1, :9] = rng.integers(0, len(VOCAB_MAP), 9)
    time, drop = np.array([0.3, 0.8], np.float32), np.array([False, True])
    lens = np.array([n, n - 45])
    mask = np.arange(n)[None] < lens[:, None]
    qtree = _jax_int8_tree(params)
    jnet = jmmdit.MMDiT(arch=qcfg.arch, text_num_embeds=len(VOCAB_MAP), mel_dim=MEL,
                        compute_dtype=jnp.bfloat16)

    def jax_run(p):
        te = jnet.apply({"params": p}, text, n, drop, method="embed_text")
        return jnet.apply({"params": p}, x, cond, te, time, drop, mask, method="run")

    want = np.asarray(jax.jit(jax_run)(qtree))
    calls = []
    plain_ff = modules.int8_ff

    def counted(h, *args):
        calls.append(tuple(h.shape))
        return plain_ff(h, *args)

    monkeypatch.setattr(modules, "int8_ff", counted)
    net = _port_int8_mmdit(qcfg, qtree)
    with torch.no_grad():
        te = net.embed_text(torch.from_numpy(text).long(), n, torch.from_numpy(drop))
        got = net.run(torch.from_numpy(x), torch.from_numpy(cond), te, torch.from_numpy(time),
                      torch.from_numpy(drop), lens_to_mask(torch.from_numpy(lens), n))
    depth = cfg.arch.depth
    want_calls = [(2, nt, 128), (2, n, 128)] * (depth - 1) + [(2, n, 128)]
    assert calls == (want_calls if int8_ff else [])
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    close(got.numpy(), want, 2e-2, f"quantized MMDiT.run int8_ff={int8_ff}")


def test_mmdit_quant_divergence_matches_jax_on_the_jax_fixture(mm):
    """The port's gate statistic over the MMDiT on the JAX gate's own draws
    (its 40-token text, noise key 3, forward input key 11), bf16 against
    int8 of the same weights: the same magnitudes, as the DiT's."""
    from eraxvif5tts_tpu.models import mmdit as jmmdit
    from eraxvif5tts_tpu.models.cfm import CFM as JCFM

    from eraxvif5tts_tpu_torch.models import build_backbone
    from eraxvif5tts_tpu_torch.models.cfm import CFM

    cfg, qcfg, params = mm
    steps, max_duration = 2, 256

    def jax_cfm(arch):
        return JCFM(transformer=jmmdit.MMDiT(arch=arch, text_num_embeds=len(VOCAB_MAP),
                                             mel_dim=MEL, compute_dtype=jnp.bfloat16))

    fp_cfm, q_cfm = jax_cfm(cfg.arch), jax_cfm(qcfg.arch)
    want = jquant.quant_divergence(fp_cfm, params, q_cfm, _jax_int8_tree(params),
                                   steps=steps, max_duration=max_duration)
    cond, text, duration, lens = jquant._fixed_inputs(fp_cfm, max_duration)
    inputs = {"cond": cond, "text": text, "duration": duration, "lens": lens,
              "noise": jax.random.normal(jax.random.key(3), (max_duration, MEL)),
              "x_in": 0.5 * jax.random.normal(jax.random.key(11), (1, max_duration, MEL))}
    inputs = {k: np.asarray(v) for k, v in inputs.items()}
    twin = build_backbone(cfg, len(VOCAB_MAP))
    twin.load_state_dict(state_dict_from_jax(params, None, cfg)[0], strict=True)
    got = quant.quant_divergence(CFM(twin.to(torch.bfloat16).eval()),
                                 CFM(_port_int8_mmdit(qcfg, _jax_int8_tree(params))),
                                 steps=steps, max_duration=max_duration, inputs=inputs)
    assert got["passes_gate"] and want["passes_gate"]
    for key in ("rel_mse", "lsd_db", "forward_rel_mse"):
        assert want[key] / 4 < got[key] < 4 * want[key], (key, got[key], want[key])


def test_int8_mmdit_wrapper_gate_and_pcm_match_jax(mm, monkeypatch):
    """`F5TTSWrapper(compute_dtype="int8")` over the MMDiT: with
    ``int8_validate`` it quantizes a reference checkpoint at load and reads
    the gate on a 64-token text (a 64-aligned joint sequence for the card's
    kernel), refusing past the threshold; from the JAX `quantize_params`
    tree its fused sample-and-vocode step gives the JAX int8 wrapper's PCM
    within 160 LSB (the DiT int8 test's bound), the JAX noise handed in."""
    from eraxvif5tts_tpu.compression.convert import backbone_params_to_torch

    from eraxvif5tts_tpu_torch.models.mmdit import MMDiT

    cfg, qcfg, params = mm
    with tempfile.TemporaryDirectory() as tmp:
        sd = backbone_params_to_torch(params, "MMDiT", cfg.arch.depth, 0)
        torch.save({f"ema_model.{k}": torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   f"{tmp}/model.pt")
        kwargs = dict(model_cfg=cfg, vocab_char_map=VOCAB_MAP, compute_dtype="int8",
                      int8_validate=True, device="cpu", ckpt_path=f"{tmp}/model.pt")
        seen = []
        plain_inputs = quant.fixed_inputs

        def gate_inputs(*args, **kw):
            out = plain_inputs(*args, **kw)
            seen.append(out["text"].shape[1])
            return out

        monkeypatch.setattr(quant, "fixed_inputs", gate_inputs)
        monkeypatch.setattr(quant, "INT8_REL_MSE_THRESHOLD", -1.0)
        with pytest.raises(ValueError, match="quality gate failed"):
            F5TTSWrapper(**kwargs)
        monkeypatch.setattr(quant, "INT8_REL_MSE_THRESHOLD", 1e-2)
        w = F5TTSWrapper(**kwargs)
    assert seen == [64, 64]  # 32 tokens and 32 filler: 64 + 256 frames
    report = w.int8_report
    assert report["passes_gate"] and 0.0 < report["rel_mse"] < 1e-2
    assert isinstance(w.transformer, MMDiT)
    assert w.transformer.transformer_blocks[0].ff_c.ff[2].weight_q.dtype == torch.int8

    vparams = redraw(jax.jit(JVocos().init)(jax.random.key(1), jnp.zeros((1, MEL, 8)))["params"],
                     seed=72, std=0.05)
    vparams["head_out"]["bias"] += 2.0
    common = dict(model_cfg=cfg, vocab_char_map=VOCAB_MAP, nfe_step=4,
                  params=jquant.quantize_params(params), vocoder_params=vparams,
                  compute_dtype="int8", **BUCKETS)
    jw, tw = JWrapper(**common), F5TTSWrapper(device="cpu", **common)
    jref = jw.preprocess_reference(ref_audio=_ref_audio(), ref_sample_rate=SR,
                                   ref_text="hello there, this is the reference voice")
    rng = np.random.default_rng(73)
    text = np.full((1, 64), -1, np.int32)
    text[0, :55] = rng.integers(0, len(VOCAB_MAP), 55)
    n_ref, bucket, duration = jref.n_frames, 128, 120
    vstart = n_ref - twrapper.VOCODE_MARGIN_FRAMES
    key = jax.random.key(74)
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
