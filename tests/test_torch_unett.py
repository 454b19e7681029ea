"""PyTorch port, the E2-TTS slice: the RMS mode of `ln_mod_matmul`, the
UNetT's norms, rotary on the first heads only, the DiT's `F5TTS_Base` options,
the UNetT backbone, the sampler, the loss and the whole wrapper over it,
each against the JAX package on the same weights (every JAX leaf redrawn from
a seeded normal, converted with `state_dict_from_jax`) and the same numpy
inputs. The JAX Pallas kernel runs in interpret mode; the JAX UNetT's fused
serving branch is reached with `fused_matmul._FORCE_FOR_TESTS`.

Tolerances: fp32 1e-5 relative to the output's scale (2e-5 through the four
layers and the sampler's four calls, 1e-4 for the loss and its gradients, as
the DiT's training test); bf16 a few bf16 ulps, stated per test; the wrapper's
int16 PCM within 4 LSB, as `tests/test_torch_slice.py`.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.compression import convert as jconvert
from eraxvif5tts_tpu.configs import ArchConfig, ModelConfig
from eraxvif5tts_tpu.infer.wrapper import F5TTSWrapper as JWrapper
from eraxvif5tts_tpu.models import modules as jm
from eraxvif5tts_tpu.models.cfm import CFM as JCFM
from eraxvif5tts_tpu.models.dit import DiT as JDiT
from eraxvif5tts_tpu.models.unett import UNetT as JUNetT
from eraxvif5tts_tpu.models.unett import XRMSNorm as JXRMSNorm
from eraxvif5tts_tpu.models.vocos import Vocos as JVocos
from eraxvif5tts_tpu.ops import fused_matmul as jfm
from eraxvif5tts_tpu.ops.rotary import apply_rotary as j_apply_rotary
from eraxvif5tts_tpu.ops.rotary import rotary_freqs as j_rotary_freqs
from eraxvif5tts_tpu_torch.compression.convert import state_dict_from_jax, unett_rules
from eraxvif5tts_tpu_torch.infer import wrapper as twrapper
from eraxvif5tts_tpu_torch.infer.utils import DURATION_BUCKETS
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
from eraxvif5tts_tpu_torch.models import build_backbone, modules
from eraxvif5tts_tpu_torch.models.cfm import CFM
from eraxvif5tts_tpu_torch.models.dit import DiT
from eraxvif5tts_tpu_torch.models.unett import UNetT
from eraxvif5tts_tpu_torch.ops import fused_matmul as tfm
from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask
from eraxvif5tts_tpu_torch.ops.rotary import apply_rotary_heads, rotary_freqs
from eraxvif5tts_tpu_torch.serving.socket_server import TTSStreamingProcessor
from test_torch_models import close, redraw
from test_torch_training import _jax_draws

MEL = 100
VOCAB = 40
E2_ARCH = ArchConfig(dim=128, depth=4, heads=2, dim_head=64, ff_mult=4, text_dim=None,
                     text_mask_padding=False, pe_attn_head=1, conv_layers=0, dropout=0.0)
E2_CFG = ModelConfig(name="tiny-e2", backbone="UNetT", arch=E2_ARCH)
DIT_ARCH = ArchConfig(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32,
                      conv_layers=1, dropout=0.0)
N = 127  # mel frames; the time token makes the transformer's sequence 128


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _dtypes(name):
    return (jnp.float32, torch.float32) if name == "float32" else (jnp.bfloat16, torch.bfloat16)


def _inputs(n=N, seed=4, mel=MEL):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n, mel)).astype(np.float32)
    cond = rng.standard_normal((2, n, mel)).astype(np.float32)
    text = np.full((2, 48), -1, np.int32)
    text[0, :40] = rng.integers(0, VOCAB, 40)
    text[1, :12] = rng.integers(0, VOCAB, 12)
    time = np.array([0.3, 0.8], np.float32)
    drop = np.array([False, True])
    lens = np.array([n, n - 38])
    return x, cond, text, time, drop, lens


def jax_unett(arch=E2_ARCH, dtype=jnp.float32, mel=MEL):
    return JUNetT(arch=arch, text_num_embeds=VOCAB, mel_dim=mel, compute_dtype=dtype)


@pytest.fixture(scope="module")
def unett_params():
    return redraw(JCFM(transformer=jax_unett()).init_params(jax.random.key(0)), seed=30)


def port_unett(params, dtype=torch.float32, cfg=E2_CFG):
    net = build_backbone(cfg, VOCAB)
    assert isinstance(net, UNetT)
    net.load_state_dict(state_dict_from_jax(params, None, cfg)[0], strict=True)
    return net.to(dtype).eval()


# ---------------------------------------------------------------------------
# the kernel's plain version and the small modules


@pytest.mark.parametrize("activation", [None, "gelu_tanh"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_mod_matmul_rms_matches_pallas_interpret(activation, dtype):
    """`ln_mod_matmul_reference(norm="rms", eps=1e-12)` against the Pallas
    kernel in interpret mode, with an all-zero row (a masked frame): 1e6 x 0
    must give 0, so that row is act(bias), never NaN. fp32 1e-5 of scale;
    bf16 8e-3 (one bf16 rounding of the modulated row and of the output)."""
    rng = np.random.default_rng(31)
    b, m, k, n = 2, 72, 128, 512  # m not a multiple of any tile
    x = (rng.standard_normal((b, m, k)) + 0.5).astype(np.float32)
    x[1, 5] = 0.0
    g = (1.0 + 0.1 * rng.standard_normal((k,))).astype(np.float32)
    scale = np.broadcast_to(g[None] - 1.0, (b, k)).copy()
    shift = np.zeros((b, k), np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    bias = (0.1 * rng.standard_normal((n,))).astype(np.float32)
    jdt, tdt = _dtypes(dtype)
    want = jfm.ln_mod_matmul(*(jnp.asarray(a, jdt) for a in (x, scale, shift, w, bias)),
                             activation=activation, interpret=True, norm="rms", eps=1e-12)
    args = (*(_t(a, tdt) for a in (x, scale, shift)), _t(w.T, tdt), _t(bias, tdt))
    got = tfm.ln_mod_matmul(*args, activation=activation, norm="rms", eps=1e-12)
    assert got.dtype == tdt and got.shape == (b, m, n)
    assert torch.isfinite(got).all()
    close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
          1e-5 if dtype == "float32" else 8e-3, "ln_mod_matmul rms")
    # eps defaults to the norm's own; the wrapper on a CPU tensor is the plain version
    torch.testing.assert_close(got, tfm.ln_mod_matmul_reference(*args, activation, "rms"),
                               rtol=0, atol=0)
    zero_row = _t(bias, tdt).float()
    if activation == "gelu_tanh":
        zero_row = torch.nn.functional.gelu(zero_row, approximate="tanh")
    torch.testing.assert_close(got[1, 5].float(), zero_row.to(tdt).float(), rtol=0, atol=0)
    # the layernorm mode is another function of the same inputs
    assert not torch.allclose(got.float(), tfm.ln_mod_matmul(*args, activation=activation).float(),
                              atol=1e-2)


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-6), ("bfloat16", 8e-3)])
def test_xrmsnorm_matches_flax(dtype, rel):
    """`XRMSNorm` against the flax module, an all-zero row included (the
    1e-12 floor keeps it zero); and against the kernel's RMS form with the
    gain folded into scale = g - 1, which the fused serving branch relies on."""
    rng = np.random.default_rng(32)
    jdt, tdt = _dtypes(dtype)
    x = rng.standard_normal((2, 9, 128)).astype(np.float32)
    x[0, 3] = 0.0
    g = (1.0 + 0.1 * rng.standard_normal((128,))).astype(np.float32)
    want = jax.jit(JXRMSNorm(128).apply)({"params": {"g": jnp.asarray(g, jdt)}},
                                         jnp.asarray(x, jdt))
    norm = modules.XRMSNorm(128)
    norm.load_state_dict({"g": _t(g)})
    with torch.no_grad():
        got = norm.to(tdt)(_t(x, tdt))
    assert got.dtype == tdt and torch.all(got[0, 3] == 0)
    close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rel, "XRMSNorm")
    if dtype == "float32":
        eye, zeros = torch.eye(128), torch.zeros(128)
        scale = (_t(g) - 1.0).expand(2, -1)
        folded = tfm.ln_mod_matmul_reference(_t(x), scale, torch.zeros_like(scale), eye, zeros,
                                             None, "rms")
        close(folded.numpy(), got.numpy(), 1e-5, "rms kernel form vs XRMSNorm")


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-6), ("bfloat16", 8e-3)])
def test_partial_head_rotary_matches_jax(dtype, rel):
    """Rotary on the first `pe_attn_head` heads only, cos/sin cast to the
    compute dtype, as `models/modules.py:386-390`."""
    rng = np.random.default_rng(33)
    jdt, tdt = _dtypes(dtype)
    x = rng.standard_normal((2, 96, 4, 64)).astype(np.float32)
    jx, rope = jnp.asarray(x, jdt), j_rotary_freqs(96, 64)
    for pn in (1, 3):
        want = jx.at[:, :, :pn].set(
            j_apply_rotary(jx[:, :, :pn].swapaxes(1, 2), rope).swapaxes(1, 2))
        got = apply_rotary_heads(_t(x, tdt), rotary_freqs(96, 64), pn)
        assert got.dtype == tdt and got.is_contiguous()
        close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rel, f"rotary pn={pn}")
        torch.testing.assert_close(got[:, :, pn:], _t(x, tdt)[:, :, pn:], rtol=0, atol=0)
    every = apply_rotary_heads(_t(x, tdt), rotary_freqs(96, 64), None)
    torch.testing.assert_close(every, apply_rotary_heads(_t(x, tdt), rotary_freqs(96, 64), 4),
                               rtol=0, atol=0)


def _port_attention(params, **options):
    attn = modules.Attention(128, heads=2, dim_head=64, **options)
    sd = {}
    for name in ("to_q", "to_k", "to_v"):
        sd[f"{name}.weight"] = _t(np.asarray(params[name]["kernel"]).T)
        sd[f"{name}.bias"] = _t(np.asarray(params[name]["bias"]))
    sd["to_out.0.weight"] = _t(np.asarray(params["to_out"]["kernel"]).T)
    sd["to_out.0.bias"] = _t(np.asarray(params["to_out"]["bias"]))
    for name in ("q_norm", "k_norm"):
        if name in params:
            sd[f"{name}.weight"] = _t(np.asarray(params[name]["weight"]))
    attn.load_state_dict(sd, strict=True)
    return attn


@pytest.mark.parametrize("options", [dict(pe_attn_head=1), dict(qk_norm="rms_norm"),
                                     dict(pe_attn_head=1, qk_norm="rms_norm")],
                         ids=["pe_attn_head", "qk_norm", "both"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_attention_options_match_flax(options, training):
    """`Attention` with rotary on head 0 only and with the q / k RMS norm, in
    both modes at dropout 0 (fp32, 1e-5 of scale; one sample masked)."""
    rng = np.random.default_rng(34)
    x = rng.standard_normal((2, 128, 128)).astype(np.float32)
    mask = np.arange(128)[None] < np.array([128, 77])[:, None]
    jattn = jm.Attention(dim=128, heads=2, dim_head=64, dropout=0.0, **options)
    rope = j_rotary_freqs(128, 64)
    params = redraw(jax.jit(jattn.init)(jax.random.key(0), x, mask, rope)["params"], 35, 0.1)
    want = jax.jit(lambda p, x: jattn.apply({"params": p}, x, mask, rope,
                                            deterministic=not training))(params, x)
    attn = _port_attention(params, **options).train(training)
    with torch.no_grad():
        got = attn(_t(x), _t(mask), rotary_freqs(128, 64))
    close(got.numpy(), want, 1e-5, f"Attention {options}")
    with pytest.raises(ValueError, match="unimplemented qk_norm: 'layer_norm'"):
        modules.Attention(128, qk_norm="layer_norm")


@pytest.mark.parametrize("option", [dict(pe_attn_head=1), dict(qk_norm="rms_norm"),
                                    dict(long_skip_connection=True),
                                    dict(text_mask_padding=False, pe_attn_head=1)],
                         ids=["pe_attn_head", "qk_norm", "long_skip", "f5tts_base"])
def test_dit_options_match_flax(option):
    """The DiT with each `F5TTS_Base`-family option against the JAX DiT
    (fp32, 1e-5 of scale), its keys the reference schema's."""
    arch = dataclasses.replace(DIT_ARCH, **option)
    cfg = ModelConfig(name="tiny", arch=arch)
    jd = JDiT(arch=arch, text_num_embeds=VOCAB, mel_dim=MEL)
    params = redraw(JCFM(transformer=jd).init_params(jax.random.key(0)), seed=36)
    x, cond, text, time, drop, lens = _inputs(128)
    mask = np.arange(128)[None] < lens[:, None]

    def jax_run(p):
        te = jd.apply({"params": p}, text, 128, drop, method="embed_text")
        return jd.apply({"params": p}, x, cond, te, time, drop, mask, method="run")

    want = jax.jit(jax_run)(params)
    dit = build_backbone(cfg, VOCAB)
    assert isinstance(dit, DiT)
    rules = jconvert.dit_rules(arch.depth, arch.conv_layers, qk_norm=arch.qk_norm is not None,
                               long_skip=arch.long_skip_connection)
    assert set(dit.state_dict()) == {rule[0] for rule in rules}
    dit.load_state_dict(state_dict_from_jax(params, None, cfg)[0], strict=True)
    dit.eval()
    with torch.no_grad():
        te = dit.embed_text(_t(text).long(), 128, _t(drop))
        got = dit.run(_t(x), _t(cond), te, _t(time), _t(drop), lens_to_mask(_t(lens), 128))
    close(got.numpy(), want, 1e-5, f"DiT {option}")


# ---------------------------------------------------------------------------
# the UNetT


def _jax_unett_run(jnet, params, inputs, dtype=jnp.float32):
    x, cond, text, time, drop, lens = inputs
    mask = np.arange(x.shape[1])[None] < lens[:, None]
    p = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)

    def run(p):
        te = jnet.apply({"params": p}, text, x.shape[1], drop, method="embed_text")
        return jnet.apply({"params": p}, x, cond, te, time, drop, mask, method="run")

    return jax.jit(run)(p)


def _port_unett_run(net, inputs):
    x, cond, text, time, drop, lens = inputs
    with torch.no_grad():
        te = net.embed_text(_t(text).long(), x.shape[1], _t(drop))
        return net.run(_t(x), _t(cond), te, _t(time), _t(drop),
                       lens_to_mask(_t(lens), x.shape[1]))


@pytest.mark.parametrize("path,dtype,rel", [("unfused", "float32", 2e-5),
                                            ("fused", "float32", 2e-5),
                                            ("fused", "bfloat16", 3e-2)])
def test_unett_run_matches_flax(unett_params, monkeypatch, path, dtype, rel):
    """`UNetT.run` against the JAX UNetT on its unfused path and on its fused
    serving path (the Pallas RMS kernel in interpret mode, forced on the CPU).
    The port fuses in bf16 only, as the JAX gate does outside the tests: in
    fp32 its unfused XRMSNorm is held to the JAX kernel. bf16: 3e-2 of scale
    through four layers (the DiT's bf16 test allows 2e-2 through two)."""
    jdt, tdt = _dtypes(dtype)
    inputs = _inputs()
    if path == "fused":
        monkeypatch.setattr(jfm, "_FORCE_FOR_TESTS", True)
        assert jfm.use_fused_serving(N + 1, 128, 512, jdt)
    want = _jax_unett_run(jax_unett(dtype=jdt), unett_params, inputs, jdt)
    calls = []
    plain = modules.ln_mod_matmul
    monkeypatch.setattr(modules, "ln_mod_matmul",
                        lambda *a, **kw: calls.append(kw["norm"]) or plain(*a, **kw))
    got = _port_unett_run(port_unett(unett_params, tdt), inputs)
    assert got.dtype == torch.float32 and got.shape == (2, N, MEL)
    assert calls == (["rms"] * E2_ARCH.depth if dtype == "bfloat16" else [])
    close(got.numpy(), want, rel, f"UNetT.run {path} {dtype}")


@pytest.mark.parametrize("skip", ["add", "none"])
def test_unett_skip_connect_types_match_flax(skip):
    jnet = JUNetT(arch=E2_ARCH, text_num_embeds=VOCAB, mel_dim=MEL, skip_connect_type=skip)
    params = redraw(JCFM(transformer=jnet).init_params(jax.random.key(0)), seed=37)
    inputs = _inputs(63)
    want = _jax_unett_run(jnet, params, inputs)
    net = UNetT(E2_ARCH, VOCAB, MEL, skip_connect_type=skip)
    rules = unett_rules(E2_ARCH.depth, 0, skip_connect_type=skip)
    assert set(net.state_dict()) == {rule[0] for rule in rules}
    sd = {key: _t(inverse(np.asarray(jconvert._get_path(params, path))))
          for key, path, _, inverse in rules}
    net.load_state_dict(sd, strict=True)
    close(_port_unett_run(net.eval(), inputs).numpy(), want, 2e-5, f"UNetT skip={skip}")
    with pytest.raises(ValueError, match="skip_connect_type must be one of"):
        UNetT(E2_ARCH, VOCAB, MEL, skip_connect_type="mul")


def test_unett_state_dict_is_the_reference_schema_and_round_trips(unett_params):
    """The port's UNetT holds exactly the reference torch keys, so a reference
    E2-TTS checkpoint loads with strict=True; `state_dict_from_jax` gives them
    from the flat and from the scan-stacked JAX tree; the JAX package's own
    import of that state dict gives the JAX tree back."""
    want_keys = {rule[0] for rule in jconvert.unett_rules(E2_ARCH.depth, 0)}
    net = UNetT(E2_ARCH, VOCAB, MEL)
    assert set(net.state_dict()) == want_keys
    sd, none = state_dict_from_jax(unett_params, None, E2_CFG)
    assert none is None and set(sd) == want_keys
    net.load_state_dict(sd, strict=True)
    stacked = jconvert.stack_unett_params(unett_params)
    assert "down_blocks" in stacked
    for key, value in state_dict_from_jax(stacked, None, E2_CFG)[0].items():
        torch.testing.assert_close(value, sd[key], rtol=0, atol=0)
    back = jconvert.backbone_params_from_torch(
        {k: v.numpy() for k, v in net.state_dict().items()}, "UNetT", E2_ARCH.depth,
        conv_layers=0)
    flat_want = jax.tree_util.tree_leaves_with_path(unett_params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_back)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_cfm_sample_over_unett_matches_jax(unett_params):
    """`CFM.sample` over the UNetT, 4 Euler steps with CFG, the JAX noise
    handed in (fp32, 2e-5 of the mel's scale)."""
    rng = np.random.default_rng(38)
    maxd = 127
    cond = rng.standard_normal((2, 40, MEL)).astype(np.float32)
    text = np.full((2, 64), -1, np.int32)
    text[0, :50] = rng.integers(0, VOCAB, 50)
    text[1, :20] = rng.integers(0, VOCAB, 20)
    lens, duration = np.array([40, 25]), np.array([100, 127])
    key = jax.random.key(0)
    want = JCFM(transformer=jax_unett()).sample(
        unett_params, jnp.asarray(cond), jnp.asarray(text), jnp.asarray(duration),
        jnp.asarray(lens), key, steps=4, cfg_strength=2.0, sway_sampling_coef=-1.0,
        max_duration=maxd)
    noise = np.array(jax.random.normal(key, (maxd, MEL), jnp.float32))
    got = CFM(port_unett(unett_params)).sample(
        _t(cond), _t(text).long(), _t(duration), _t(lens), noise=_t(noise), steps=4,
        cfg_strength=2.0, sway_sampling_coef=-1.0, max_duration=maxd).numpy()
    assert got.shape == (2, maxd, MEL)
    close(got, want, 2e-5, "CFM.sample over UNetT")
    np.testing.assert_array_equal(got[0, :40], cond[0])
    assert np.all(got[0, 100:] == 0) and np.any(got[1, 126] != 0)


def test_unett_loss_and_gradients_match_jax():
    """`CFM.loss` over the UNetT in training mode at dropout 0 (the unfused
    feed-forward, the training attention over the sequence with its time
    token) and every parameter's gradient against `jax.grad` (1e-4 of scale)."""
    mel, n = 8, 15  # 8 mel channels: the width `_jax_draws` draws x0 at
    arch = dataclasses.replace(E2_ARCH, dim=32, depth=2, heads=2, dim_head=16)
    cfg = dataclasses.replace(E2_CFG, arch=arch)
    jcfm = JCFM(transformer=JUNetT(arch=arch, text_num_embeds=VOCAB, mel_dim=mel))
    params = redraw(jcfm.init_params(jax.random.key(0)), seed=39, std=0.2)
    rng = np.random.default_rng(40)
    batch = (rng.standard_normal((2, n, mel)).astype(np.float32),
             np.asarray([[1, 2, -1], [3, 1, -1]], np.int32), np.asarray([n, 11], np.int32))
    key = jax.random.key(1)
    (want_loss, want_pred), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda out: (out[0], out[2]))(jcfm.loss(p, *batch, key)),
        has_aux=True))(params)
    net = UNetT(arch, VOCAB, mel)
    net.load_state_dict(state_dict_from_jax(params, None, cfg)[0], strict=True)
    loss, _, pred = CFM(net.train()).loss(*(_t(a) for a in batch), _jax_draws(key, 2, n))
    loss.backward()
    close(loss.item(), float(want_loss), 1e-4, "loss")
    close(pred.detach().numpy(), want_pred, 1e-4, "pred")
    want = jconvert.backbone_params_to_torch(jgrads, "UNetT", arch.depth, conv_layers=0,
                                             with_prefix=False)
    got = dict(net.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        close(got[name].grad.numpy(), g, 1e-4, f"grad {name}")


# ---------------------------------------------------------------------------
# the whole slice: the wrapper and the socket server over a tiny UNetT

SR = 24000
CHARS = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,!?'-0123456")}
BUCKETS = dict(duration_buckets=(63, 127, 191, 255), text_buckets=(64,))
REF_TEXT = "hello there, this is the reference voice"
PCM_LSB = 4


def _ref_audio():
    t = np.arange(int(SR * 0.8)) / SR  # 75 frames: longer than the vocode margin
    return (0.2 * np.sin(2 * np.pi * 190 * t) + 0.05 * np.sin(2 * np.pi * 900 * t)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def wrappers():
    jcfm = JCFM(transformer=JUNetT(arch=E2_ARCH, text_num_embeds=len(CHARS), mel_dim=MEL))
    params = redraw(jcfm.init_params(jax.random.key(0)), seed=41)
    vparams = redraw(jax.jit(JVocos().init)(jax.random.key(1), jnp.zeros((1, MEL, 8)))
                     ["params"], seed=42, std=0.05)
    vparams["head_out"]["bias"] += 2.0  # log-magnitude ~2: a signal well above 1 LSB
    common = dict(model_cfg=E2_CFG, vocab_char_map=CHARS, nfe_step=4, params=params,
                  vocoder_params=vparams, compute_dtype="float32", **BUCKETS)
    jw, tw = JWrapper(**common), F5TTSWrapper(device="cpu", **common)
    refs = [w.preprocess_reference(ref_audio=_ref_audio(), ref_sample_rate=SR,
                                   ref_text=REF_TEXT) for w in (jw, tw)]
    return jw, refs[0], tw, refs[1]


def test_e2tts_sample_vocode_pcm_matches_jax(wrappers):
    """The fused sample-and-vocode step over the UNetT: int16 PCM within
    4 LSB of the JAX wrapper's, the JAX noise handed in."""
    jw, jref, tw, _ = wrappers
    assert isinstance(tw.transformer, UNetT)
    rng = np.random.default_rng(43)
    text = np.full((1, 64), -1, np.int32)
    text[0, :55] = rng.integers(0, len(CHARS), 55)
    n_ref, bucket, duration = jref.n_frames, 127, 120
    vstart = n_ref - twrapper.VOCODE_MARGIN_FRAMES
    key = jax.random.key(44)
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


def test_e2tts_generate_matches_jax_wave(wrappers, monkeypatch):
    jw, jref, tw, tref = wrappers
    seed, draws = 6, []

    def jax_noise(self, generator, n_frames):
        key = jax.random.fold_in(jax.random.key(seed), len(draws))
        draws.append(n_frames)
        return _t(np.array(jax.random.normal(key, (n_frames, MEL), jnp.float32)))

    monkeypatch.setattr(F5TTSWrapper, "_draw_noise", jax_noise)
    text = "one two three four five six seven."
    want = jw.generate(text, ref=jref, seed=seed, use_pinyin=False)
    got = tw.generate(text, ref=tref, seed=seed, use_pinyin=False)
    assert len(draws) > 1 and all(n % 64 == 63 for n in draws)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= PCM_LSB / 32767.0


def test_unett_wrapper_bucket_rule_matches_jax(wrappers):
    """With the default buckets a UNetT wrapper takes mel buckets of 64k - 1
    frames (the JAX rule, `tests/test_wrapper.py` `test_unett_wrapper_aligned_buckets`),
    so the time token lands the transformer on 64-aligned sequences; explicit
    buckets and DiT wrappers keep theirs."""
    default = F5TTSWrapper(model_cfg=E2_CFG, vocab_char_map=CHARS, device="cpu",
                           compute_dtype="float32")
    jdefault = JWrapper(model_cfg=E2_CFG, vocab_char_map=CHARS)
    assert default.duration_buckets == jdefault.duration_buckets
    assert default.duration_buckets == tuple(b - 1 for b in DURATION_BUCKETS)
    assert all((b + 1) % 64 == 0 for b in default.duration_buckets)
    assert wrappers[2].duration_buckets == BUCKETS["duration_buckets"]
    dit = F5TTSWrapper(model_cfg=ModelConfig(name="tiny", arch=DIT_ARCH), vocab_char_map=CHARS,
                       device="cpu", compute_dtype="float32")
    assert dit.duration_buckets == DURATION_BUCKETS


def test_e2tts_generate_batch_and_socket_processor(wrappers):
    """`generate_batch` and the socket server's processor run over the UNetT
    wrapper: finite audio per text, the longer text the longer wave, and a
    streamed response that ends with END."""
    _, _, tw, tref = wrappers
    waves = tw.generate_batch(["first words.", "a longer second one."],
                              ref=tref, nfe_step=2, seed=3, use_pinyin=False)
    assert len(waves) == 2 and len(waves[1]) > len(waves[0]) > 0
    assert all(np.isfinite(w).all() for w in waves)
    processor = TTSStreamingProcessor(tw, ref_state=tref, nfe_step=2, output_file=None,
                                      warm_up=False)
    sent, lock = [], threading.Lock()

    def send(data):
        with lock:
            sent.append(data)

    processor.generate_stream("a short request.", send)
    assert sent[-1] == b"END" and len(sent) > 1
    pcm = np.frombuffer(b"".join(sent[:-1]), np.float32)
    assert len(pcm) > 0 and np.isfinite(pcm).all()
