"""PyTorch port, the MMDiT slice: the text stream's embedding, the joint
attention, the dual-stream blocks (the last `context_pre_only`), the whole
backbone with and without `qk_norm`, its key rules, `CFM.sample` over it and
the wrapper's PCM, each against the JAX package on the same weights (every
JAX leaf redrawn from a seeded normal, carried across by
`state_dict_from_jax`) and the same numpy inputs; then the serving attention's
domain, widened to the MMDiT's joint sequence (64 <= n <= 6144, n % 64 == 0).

Tolerances: fp32 1e-5 of the output's scale for the single modules, 1e-4
through the three blocks of the backbone and the sampler's four calls (fp32
sums in other orders); the wrapper's int16 PCM within 4 LSB, as
`tests/test_torch_slice.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.compression import convert as jconvert
from eraxvif5tts_tpu.configs import ArchConfig, ModelConfig
from eraxvif5tts_tpu.infer.wrapper import F5TTSWrapper as JWrapper
from eraxvif5tts_tpu.models import mmdit as jmmdit
from eraxvif5tts_tpu.models.cfm import CFM as JCFM
from eraxvif5tts_tpu.models.vocos import Vocos as JVocos
from eraxvif5tts_tpu.ops.rotary import rotary_freqs as j_rotary_freqs
from eraxvif5tts_tpu_torch.compression.convert import mmdit_rules, state_dict_from_jax
from eraxvif5tts_tpu_torch.configs import PRESETS
from eraxvif5tts_tpu_torch.infer import wrapper as twrapper
from eraxvif5tts_tpu_torch.infer.utils import DURATION_BUCKETS, TEXT_BUCKETS
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
from eraxvif5tts_tpu_torch.models import build_backbone, mmdit, modules
from eraxvif5tts_tpu_torch.models.cfm import CFM
from eraxvif5tts_tpu_torch.ops import quant
from eraxvif5tts_tpu_torch.ops import serving_attention as sa
from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask
from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs
from test_torch_models import close, redraw
from test_torch_slice import PCM_LSB, REF_TEXT, SR, _ref_audio

MEL = 100
VOCAB = 40
ARCH = ArchConfig(dim=128, depth=3, heads=2, dim_head=64, ff_mult=2, dropout=0.0)
CFG = ModelConfig(name="tiny-mmdit", backbone="MMDiT", arch=ARCH)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _arch(qk_norm):
    return dataclasses.replace(ARCH, qk_norm=qk_norm)


def jax_mmdit(arch=ARCH, text_num_embeds=VOCAB):
    return jmmdit.MMDiT(arch=arch, text_num_embeds=text_num_embeds, mel_dim=MEL)


def jax_params(arch=ARCH, seed=50, text_num_embeds=VOCAB):
    jcfm = JCFM(transformer=jax_mmdit(arch, text_num_embeds))
    return redraw(jcfm.init_params(jax.random.key(0)), seed=seed)


def port_mmdit(params, arch=ARCH, text_num_embeds=VOCAB):
    cfg = dataclasses.replace(CFG, arch=arch)
    net = build_backbone(cfg, text_num_embeds)
    assert isinstance(net, mmdit.MMDiT)
    net.load_state_dict(state_dict_from_jax(params, None, cfg)[0], strict=True)
    return net.eval()


@pytest.fixture(scope="module")
def params_by_norm():
    return {norm: jax_params(_arch(norm)) for norm in (None, "rms_norm")}


def _inputs(n=128, nt=64, seed=51):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n, MEL)).astype(np.float32)
    cond = rng.standard_normal((2, n, MEL)).astype(np.float32)
    text = np.full((2, nt), -1, np.int32)
    text[0, :nt - 10] = rng.integers(0, VOCAB, nt - 10)
    text[1, :12] = rng.integers(0, VOCAB, 12)
    time = np.array([0.3, 0.8], np.float32)
    lens = np.array([n, n - 38])
    return x, cond, text, time, lens


def _jax_run(arch, params, inputs, drop_audio, drop_text, masked=True):
    jnet = jax_mmdit(arch)
    x, cond, text, time, lens = inputs
    n = x.shape[1]
    mask = (np.arange(n)[None] < lens[:, None]) if masked else None

    def run(p):
        te = jnet.apply({"params": p}, text, n, drop_text, method="embed_text")
        return jnet.apply({"params": p}, x, cond, te, time, drop_audio, mask, method="run")

    return np.asarray(jax.jit(run)(params))


def _port_run(net, inputs, drop_audio, drop_text, masked=True):
    x, cond, text, time, lens = inputs
    n = x.shape[1]
    mask = lens_to_mask(_t(lens), n) if masked else None
    with torch.no_grad():
        te = net.embed_text(_t(text).long(), n, _t(drop_text))
        return net.run(_t(x), _t(cond), te, _t(time), _t(drop_audio), mask)


# ---------------------------------------------------------------------------
# the modules


def test_text_embedding_matches_flax_past_the_position_table():
    """The text stream at a length past `TEXT_MAX_POS` (positions clamped),
    the filler masked by the ids before the CFG drop, the dropped sample all
    filler ids (fp32, exact up to 1e-6 of scale)."""
    assert mmdit.TEXT_MAX_POS == jmmdit.TEXT_MAX_POS == 1024
    rng = np.random.default_rng(52)
    nt = 1088
    text = np.full((2, nt), -1, np.int32)
    text[0, :1070] = rng.integers(0, VOCAB, 1070)
    text[1, :30] = rng.integers(0, VOCAB, 30)
    drop = np.array([False, True])
    for mask_padding in (True, False):
        jemb = jmmdit.MMTextEmbedding(VOCAB, 64, mask_padding=mask_padding)
        p = redraw(jax.jit(jemb.init)(jax.random.key(0), text, drop)["params"], 53, 0.5)
        want = np.asarray(jax.jit(lambda p: jemb.apply({"params": p}, text, drop))(p))
        emb = mmdit.MMTextEmbedding(VOCAB, 64, mask_padding=mask_padding)
        emb.load_state_dict({"text_embed.weight": _t(np.asarray(p["embed"]["embedding"]))})
        with torch.no_grad():
            got = emb(_t(text).long(), _t(drop), torch.float32)
        close(got.numpy(), want, 1e-6, f"MMTextEmbedding mask_padding={mask_padding}")
        assert got.shape == (2, nt, 64)
        # the dropped sample keeps its filler mask: its tail is zero only when masked
        assert bool(torch.all(got[1, 30:] == 0)) == mask_padding


def _joint_attention_state_dict(p):
    sd = {}
    for name in ("to_q", "to_k", "to_v", "to_q_c", "to_k_c", "to_v_c", "to_out_c"):
        if name in p:
            sd[f"{name}.weight"] = _t(np.asarray(p[name]["kernel"]).T)
            sd[f"{name}.bias"] = _t(np.asarray(p[name]["bias"]))
    sd["to_out.0.weight"] = _t(np.asarray(p["to_out"]["kernel"]).T)
    sd["to_out.0.bias"] = _t(np.asarray(p["to_out"]["bias"]))
    for name in ("q_norm", "k_norm", "c_q_norm", "c_k_norm"):
        if name in p:
            sd[f"{name}.weight"] = _t(np.asarray(p[name]["weight"]))
    return sd


@pytest.mark.parametrize("qk_norm", [None, "rms_norm"], ids=["plain", "qk_norm"])
@pytest.mark.parametrize("context_pre_only", [False, True], ids=["both", "pre_only"])
def test_joint_attention_matches_flax(qk_norm, context_pre_only, monkeypatch):
    """`JointAttention` against the flax module (fp32, 1e-5 of scale), with a
    padded audio sample: the serving attention gets the text-first joint
    q / k / v, contiguous, without rotary, the key lengths `nt + mel_lens`;
    `context_pre_only` has no `to_out_c` and no text output."""
    rng = np.random.default_rng(54)
    n, nt = 128, 64
    x = rng.standard_normal((2, n, 128)).astype(np.float32)
    c = rng.standard_normal((2, nt, 128)).astype(np.float32)
    lens = np.array([n, 77])
    mask = np.arange(n)[None] < lens[:, None]
    rope, c_rope = j_rotary_freqs(n, 64), j_rotary_freqs(nt, 64)
    jattn = jmmdit.JointAttention(dim=128, heads=2, dim_head=64, dropout=0.0,
                                  context_pre_only=context_pre_only, qk_norm=qk_norm)
    p = redraw(jax.jit(jattn.init)(jax.random.key(0), x, c, mask, rope, c_rope)["params"],
               55, 0.1)
    want_x, want_c = jax.jit(lambda p: jattn.apply({"params": p}, x, c, mask, rope, c_rope))(p)
    attn = mmdit.JointAttention(128, 2, 64, context_pre_only, qk_norm)
    attn.load_state_dict(_joint_attention_state_dict(p), strict=True)
    seen = []
    plain = mmdit.dot_product_attention

    def spy(q, k, v, key_valid=None, rope=None):
        seen.append((q.shape, q.is_contiguous(), key_valid.sum(-1).tolist(), rope))
        return plain(q, k, v, key_valid=key_valid, rope=rope)

    monkeypatch.setattr(mmdit, "dot_product_attention", spy)
    with torch.no_grad():
        got_x, got_c = attn.eval()(_t(x), _t(c), _t(mask), rotary_freqs(n, 64),
                                   rotary_freqs(nt, 64))
    assert seen == [((2, nt + n, 2, 64), True, [nt + n, nt + 77], None)]
    close(got_x.numpy(), np.asarray(want_x), 1e-5, "JointAttention x")
    assert torch.all(got_x[1, 77:] == 0)
    if context_pre_only:
        assert got_c is None and attn.to_out_c is None
    else:
        close(got_c.numpy(), np.asarray(want_c), 1e-5, "JointAttention c")


# ---------------------------------------------------------------------------
# the backbone


DROPS = {  # (drop_audio_cond, drop_text) per sample
    "cond": ([False, False], [False, False]),
    "uncond": ([True, True], [True, True]),
    "cfg_batch": ([False, True], [False, True]),  # CFM.sample's doubled batch
    "audio_only": ([True, False], [False, False]),  # CFM.loss draws them apart
}


@pytest.mark.parametrize("qk_norm", [None, "rms_norm"], ids=["plain", "qk_norm"])
@pytest.mark.parametrize("drops", sorted(DROPS))
def test_mmdit_run_matches_flax(params_by_norm, qk_norm, drops):
    """`MMDiT.run` from `embed_text` against the JAX MMDiT, fp32, 1e-4 of
    scale, under each pattern of CFG drops; the second sample's mel padded
    (the prefix mask)."""
    arch = _arch(qk_norm)
    inputs = _inputs()
    drop_audio, drop_text = (np.array(d) for d in DROPS[drops])
    want = _jax_run(arch, params_by_norm[qk_norm], inputs, drop_audio, drop_text)
    got = _port_run(port_mmdit(params_by_norm[qk_norm], arch), inputs, drop_audio, drop_text)
    assert got.dtype == torch.float32 and got.shape == (2, 128, MEL)
    close(got.numpy(), want, 1e-4, f"MMDiT.run qk_norm={qk_norm} drops={drops}")


def test_mmdit_without_a_mask_and_forward(params_by_norm):
    """No mask (every key valid: the kernel's `lens=None`), and `forward`,
    which embeds the text itself (fp32, 1e-4 of scale)."""
    inputs = _inputs(n=192, nt=128, seed=56)
    drop = np.array([False, True])
    want = _jax_run(ARCH, params_by_norm[None], inputs, drop, drop, masked=False)
    net = port_mmdit(params_by_norm[None])
    close(_port_run(net, inputs, drop, drop, masked=False).numpy(), want, 1e-4,
          "MMDiT.run unmasked")
    x, cond, text, time, _ = inputs
    with torch.no_grad():
        got = net(_t(x), _t(cond), _t(text).long(), _t(time), _t(drop), _t(drop))
    close(got.numpy(), want, 1e-4, "MMDiT.forward")


def test_mmdit_last_block_is_context_pre_only(params_by_norm):
    """Only the last block is `context_pre_only`: its text stream has the
    two-way final AdaLN, no `to_out_c` and no text feed-forward, and its
    text output is None; every other block returns both streams."""
    net = port_mmdit(params_by_norm[None])
    blocks = net.transformer_blocks
    assert [b.context_pre_only for b in blocks] == [False, False, True]
    last = blocks[-1]
    assert isinstance(last.attn_norm_c, modules.AdaLayerNormFinal)
    assert last.ff_c is None and last.attn.to_out_c is None
    assert last.attn_norm_c.linear.out_features == 2 * ARCH.dim
    assert all(isinstance(b.attn_norm_c, modules.AdaLayerNorm) for b in blocks[:-1])
    x = torch.randn(1, 64, ARCH.dim, generator=torch.Generator().manual_seed(0))
    c = torch.randn(1, 64, ARCH.dim, generator=torch.Generator().manual_seed(1))
    t = torch.randn(1, ARCH.dim, generator=torch.Generator().manual_seed(2))
    rope = rotary_freqs(64, 64)
    with torch.no_grad():
        c_out, x_out = last(x, c, t, None, rope, rope)
        c_mid, _ = blocks[0](x, c, t, None, rope, rope)
    assert c_out is None and x_out.shape == x.shape and c_mid.shape == c.shape


def test_mmdit_feed_forward_is_unfused_and_kernel_1_has_no_rotary(params_by_norm, monkeypatch):
    """In bf16 eval, as it serves on the card: the projection kernel (kernel
    2) never runs in an MMDiT, and every attention call is the serving
    kernel's domain without rotary: one call per block, the joint
    `[2, 64 + 128, 2, 64]` bf16, lengths `64 + mel_lens`."""
    ln_calls, attn_calls = [], []
    monkeypatch.setattr(modules, "ln_mod_matmul", lambda *a, **k: ln_calls.append(1))
    plain = mmdit.dot_product_attention

    def spy(q, k, v, key_valid=None, rope=None):
        lens = key_valid.sum(-1, dtype=torch.int32)
        sa._check_cuda_args(q, k, v, lens, rope)  # the kernel would take it
        attn_calls.append((tuple(q.shape), q.dtype, lens.tolist(), rope))
        return plain(q, k, v, key_valid=key_valid, rope=rope)

    monkeypatch.setattr(mmdit, "dot_product_attention", spy)
    net = port_mmdit(params_by_norm[None]).to(torch.bfloat16)
    inputs = _inputs()
    drop = np.array([False, True])
    out = _port_run(net, inputs, drop, drop)
    assert torch.isfinite(out).all() and ln_calls == []
    assert attn_calls == [((2, 192, 2, 64), torch.bfloat16, [192, 154], None)] * ARCH.depth


def test_mmdit_rules_round_trip_and_reference_schema(params_by_norm):
    """The port's MMDiT holds exactly the reference torch keys (`mmdit_rules`,
    a copy of the JAX package's, with the four `qk_norm` weights a block);
    `state_dict_from_jax` gives them, `load_state_dict(strict=True)` takes
    them, the JAX importer gives the JAX tree back bit for bit, and a
    reference-format checkpoint file loads through the wrapper's reader."""
    for qk_norm, params in params_by_norm.items():
        arch = _arch(qk_norm)
        want_keys = {r[0] for r in jconvert.mmdit_rules(arch.depth, qk_norm=bool(qk_norm))}
        assert {r[0] for r in mmdit_rules(arch.depth, qk_norm=bool(qk_norm))} == want_keys
        net = build_backbone(dataclasses.replace(CFG, arch=arch), VOCAB)
        assert set(net.state_dict()) == want_keys
        assert sum(k.endswith(("q_norm.weight", "k_norm.weight")) for k in want_keys) == (
            4 * arch.depth if qk_norm else 0)
        net = port_mmdit(params, arch)
        back = jconvert.backbone_params_from_torch(
            {k: v.numpy() for k, v in net.state_dict().items()}, "MMDiT", arch.depth,
            qk_norm=bool(qk_norm))
        flat_want = jax.tree_util.tree_leaves_with_path(params)
        flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_want) == len(flat_back)
        for path, leaf in flat_want:
            np.testing.assert_array_equal(flat_back[path], leaf)


def test_mmdit_reference_checkpoint_loads_strict(params_by_norm, tmp_path):
    from eraxvif5tts_tpu_torch.compression.convert import (
        backbone_state_dict_to_reference,
        infer_depth,
        reference_backbone_state_dict,
    )

    net = port_mmdit(params_by_norm["rms_norm"], _arch("rms_norm"))
    sd = backbone_state_dict_to_reference(net.state_dict())
    torch.save({f"ema_model.{k}": torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "mmdit.pt")
    loaded = reference_backbone_state_dict(str(tmp_path / "mmdit.pt"))
    assert infer_depth({k: v.numpy() for k, v in loaded.items()}) == ARCH.depth
    fresh = build_backbone(dataclasses.replace(CFG, arch=_arch("rms_norm")), VOCAB)
    fresh.load_state_dict(loaded, strict=True)
    for key, value in net.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key


def test_mmdit_serves_only_and_int8_waits():
    """Training mode trains at dropout 0 and refuses dropout 0.1 (the
    reference MMDiT's missing `hash_dropout`, ROADMAP queue 3); the int8
    MMDiT builds, in the backbone and in the wrapper, and refuses to train;
    `scan_layers` still raises."""
    x = torch.zeros(1, 64, MEL)
    args = (x, x, torch.zeros(1, 8, dtype=torch.long), torch.zeros(1),
            torch.zeros(1, dtype=torch.bool), torch.zeros(1, dtype=torch.bool))
    net = build_backbone(CFG, VOCAB).train()
    assert net(*args).shape == x.shape
    dropping = dataclasses.replace(CFG, arch=dataclasses.replace(ARCH, dropout=0.1))
    with pytest.raises(ValueError, match="hash_dropout.*queue 3"):
        build_backbone(dropping, VOCAB).train()(*args)
    quantized = dataclasses.replace(CFG, arch=dataclasses.replace(ARCH, quantized=True))
    qnet = build_backbone(quantized, VOCAB)
    assert isinstance(qnet.transformer_blocks[0].attn.to_k_c, quant.QuantLinear)
    assert qnet.transformer_blocks[-1].ff_c is None
    with pytest.raises(ValueError, match="a quantized MMDiT serves only"):
        qnet.train()(*args)
    w = F5TTSWrapper(model_cfg=CFG, compute_dtype="int8", device="cpu")
    assert isinstance(w.transformer, mmdit.MMDiT) and w.transformer.arch.quantized
    with pytest.raises(ValueError, match="scan_layers=True .* is not ported"):
        build_backbone(dataclasses.replace(
            CFG, arch=dataclasses.replace(ARCH, scan_layers=True)), VOCAB)


def test_mmdit_preset_builds_at_full_width_on_meta():
    """`F5TTS_v1_MMDiT` builds at its published width (dim 1024, 22 blocks,
    16 x 64 heads, ff_mult 2: about 0.6 B parameters) and its keys are the
    reference's (built on the `meta` device: no memory)."""
    cfg = PRESETS["F5TTS_v1_MMDiT"]
    with torch.device("meta"):
        net = build_backbone(cfg, 2545)
    a = cfg.arch
    assert (a.dim, a.depth, a.heads, a.dim_head, a.ff_mult) == (1024, 22, 16, 64, 2)
    assert set(net.state_dict()) == {r[0] for r in jconvert.mmdit_rules(22)}
    n_params = sum(p.numel() for p in net.parameters())
    assert 0.55e9 < n_params < 0.7e9, n_params


# ---------------------------------------------------------------------------
# the sampler and the wrapper


def test_cfm_sample_over_mmdit_matches_jax(params_by_norm):
    """`CFM.sample` over the MMDiT, 4 Euler steps with CFG (the text stream
    embedded once, cond and uncond as one doubled batch), the JAX noise
    handed in (fp32, 1e-4 of the mel's scale)."""
    params = params_by_norm["rms_norm"]
    arch = _arch("rms_norm")
    rng = np.random.default_rng(57)
    maxd = 128
    cond = rng.standard_normal((2, 40, MEL)).astype(np.float32)
    text = np.full((2, 64), -1, np.int32)
    text[0, :50] = rng.integers(0, VOCAB, 50)
    text[1, :20] = rng.integers(0, VOCAB, 20)
    lens, duration = np.array([40, 25]), np.array([100, 128])
    key = jax.random.key(0)
    want = JCFM(transformer=jax_mmdit(arch)).sample(
        params, jnp.asarray(cond), jnp.asarray(text), jnp.asarray(duration),
        jnp.asarray(lens), key, steps=4, cfg_strength=2.0, sway_sampling_coef=-1.0,
        max_duration=maxd)
    noise = np.array(jax.random.normal(key, (maxd, MEL), jnp.float32))
    got = CFM(port_mmdit(params, arch)).sample(
        _t(cond), _t(text).long(), _t(duration), _t(lens), noise=_t(noise), steps=4,
        cfg_strength=2.0, sway_sampling_coef=-1.0, max_duration=maxd).numpy()
    assert got.shape == (2, maxd, MEL)
    close(got, np.asarray(want), 1e-4, "CFM.sample over MMDiT")
    np.testing.assert_array_equal(got[0, :40], cond[0])
    assert np.all(got[0, 100:] == 0) and np.any(got[1, 127] != 0)


CHARS = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,!?'-0123456")}
BUCKETS = dict(duration_buckets=(64, 128, 192, 256), text_buckets=(64,))


@pytest.fixture(scope="module")
def wrappers():
    params = jax_params(_arch("rms_norm"), seed=58, text_num_embeds=len(CHARS))
    vparams = redraw(jax.jit(JVocos().init)(jax.random.key(1), jnp.zeros((1, MEL, 8)))
                     ["params"], seed=59, std=0.05)
    vparams["head_out"]["bias"] += 2.0  # log-magnitude ~2: a signal well above 1 LSB
    cfg = dataclasses.replace(CFG, arch=_arch("rms_norm"))
    common = dict(model_cfg=cfg, vocab_char_map=CHARS, nfe_step=4, params=params,
                  vocoder_params=vparams, compute_dtype="float32", **BUCKETS)
    jw, tw = JWrapper(**common), F5TTSWrapper(device="cpu", **common)
    refs = [w.preprocess_reference(ref_audio=_ref_audio(), ref_sample_rate=SR,
                                   ref_text=REF_TEXT) for w in (jw, tw)]
    return jw, refs[0], tw, refs[1]


def test_mmdit_sample_vocode_pcm_matches_jax(wrappers):
    """The fused sample-and-vocode step over the MMDiT: int16 PCM within
    4 LSB of the JAX wrapper's, the JAX noise handed in."""
    jw, jref, tw, _ = wrappers
    assert isinstance(tw.transformer, mmdit.MMDiT)
    assert tw.duration_buckets == jw.duration_buckets == BUCKETS["duration_buckets"]
    rng = np.random.default_rng(60)
    text = np.full((1, 64), -1, np.int32)
    text[0, :55] = rng.integers(0, len(CHARS), 55)
    n_ref, bucket, duration = jref.n_frames, 128, 120
    vstart = n_ref - twrapper.VOCODE_MARGIN_FRAMES
    key = jax.random.key(61)
    static = dict(steps=4, cfg_strength=2.0, sway=-1.0, max_duration=bucket,
                  vocode_start=vstart, gen_start=n_ref - vstart)
    want_pcm, want_mel = jw._sample_vocode_jit(
        jw.params, jw.vocoder_params, jref.mel, jnp.asarray(text), jnp.asarray([duration]),
        jnp.asarray([n_ref]), key, jnp.asarray(1.0, jnp.float32), **static)
    noise = np.array(jax.random.normal(key, (bucket, MEL), jnp.float32))
    got_pcm, got_mel = tw._sample_vocode(
        _t(np.array(jref.mel)), _t(text).long(), torch.tensor([duration]),
        torch.tensor([n_ref]), _t(noise), 1.0, **static)
    want_pcm = np.asarray(want_pcm)
    assert got_pcm.dtype == torch.int16 and got_pcm.shape == want_pcm.shape
    assert np.abs(want_pcm).max() > 1000  # a real signal, not silence
    diff = np.abs(got_pcm.numpy().astype(np.int32) - want_pcm.astype(np.int32))
    assert diff.max() <= PCM_LSB, f"PCM differs by {diff.max()} LSB"
    np.testing.assert_allclose(got_mel.numpy(), np.asarray(want_mel), atol=1e-4)


def test_mmdit_generate_matches_jax_wave(wrappers, monkeypatch):
    jw, jref, tw, tref = wrappers
    seed, draws = 7, []

    def jax_noise(self, generator, n_frames):
        key = jax.random.fold_in(jax.random.key(seed), len(draws))
        draws.append(n_frames)
        return _t(np.array(jax.random.normal(key, (n_frames, MEL), jnp.float32)))

    monkeypatch.setattr(F5TTSWrapper, "_draw_noise", jax_noise)
    text = "one two three four five six seven."
    want = jw.generate(text, ref=jref, seed=seed, use_pinyin=False)
    got = tw.generate(text, ref=tref, seed=seed, use_pinyin=False)
    assert len(draws) > 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= PCM_LSB / 32767.0


# ---------------------------------------------------------------------------
# kernel 1's domain: the MMDiT's joint sequence


def test_serving_attention_bound_is_the_largest_joint_bucket():
    assert sa.MAX_N == TEXT_BUCKETS[-1] + DURATION_BUCKETS[-1] == 6144
    assert all(b % sa.TILE == 0 for b in TEXT_BUCKETS + DURATION_BUCKETS)


@pytest.mark.parametrize("n", list(range(64, 6144 + 1, 64)))
def test_serving_attention_domain_takes_every_joint_length(n):
    """Every 64-aligned n up to 6144, with lengths and with rotary: the
    checks that guard the CUDA launch pass (run on CPU tensors)."""
    q = torch.zeros(1, n, 1, 64, dtype=torch.bfloat16)
    sa._check_cuda_args(q, q, q, torch.tensor([n // 2 + 1]), None)
    sa._check_cuda_args(q, q, q, None, rotary_freqs(n, 64))


@pytest.mark.parametrize("n", [0, 32, 100, 4160 + 32, 6144 - 1, 6144 + 32, 6144 + 64, 8192])
def test_serving_attention_domain_refuses_past_the_joint_bucket(n):
    q = torch.zeros(1, n, 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"n must be a multiple of 64 in \[64, 6144\]"):
        sa._check_cuda_args(q, q, q, None, None)
