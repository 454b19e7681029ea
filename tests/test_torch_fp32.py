"""PyTorch port, fp32 serving (the JAX package's default dtype): kernel 1's
fp32 mode against the JAX kernel in interpret mode, the feed-forward's
fusion gate, the default dtype of the wrapper and of the entry points, the
TF32 block that an fp32 backbone and vocoder call hold, and a default-built
port wrapper's PCM against a default-built JAX wrapper's (CPU; the port's
kernel wrappers take their plain versions for CPU tensors).

Tolerances: attention 1e-5 of the output's scale (the same fp32 algorithm,
sums in other orders); the fused sample-and-vocode step's int16 PCM within
4 LSB, as `test_torch_slice.py` holds it.
"""

import inspect
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.infer.wrapper import F5TTSWrapper as JWrapper
from eraxvif5tts_tpu.models.vocos import Vocos as JVocos
from eraxvif5tts_tpu.ops import serving_attention as jsa
from eraxvif5tts_tpu.ops.rotary import rotary_freqs as j_rotary_freqs
from eraxvif5tts_tpu_torch.configs import ArchConfig as TArchConfig
from eraxvif5tts_tpu_torch.infer import utils_infer
from eraxvif5tts_tpu_torch.infer import wrapper as twrapper
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
from eraxvif5tts_tpu_torch.models import modules
from eraxvif5tts_tpu_torch.models.dit import DiT
from eraxvif5tts_tpu_torch.models.modules import FeedForward, layer_norm
from eraxvif5tts_tpu_torch.models.unett import UNetT
from eraxvif5tts_tpu_torch.models.vocos import Vocos
from eraxvif5tts_tpu_torch.ops import fused_matmul as tfm
from eraxvif5tts_tpu_torch.ops import serving_attention as tsa
from eraxvif5tts_tpu_torch.ops import train_attention as tta
from eraxvif5tts_tpu_torch.serving import socket_server
from test_torch_models import MEL, redraw, tiny_params
from test_torch_slice import BUCKETS, CFG, PCM_LSB, REF_TEXT, SR, VOCAB, _ref_audio

PORT_ARCH = TArchConfig(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32,
                        conv_layers=1, dropout=0.0)


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= rel, f"{what}: max error {err:.3g} of scale > {rel}"


# ---- kernel 1 in fp32 ----------------------------------------------------------


@pytest.mark.parametrize("n", [64, 192, 1088])
@pytest.mark.parametrize("with_rope", [False, True])
@pytest.mark.parametrize("lens", [(0, 37), (64, 0), None])
def test_serving_attention_fp32_matches_pallas_interpret(n, with_rope, lens):
    """fp32 q, k, v through the port's `serving_attention` (its plain
    version here; the fp32 kernel on the card) and through the JAX Pallas
    kernel in interpret mode: one tile, three, the DiT's 1088 bucket; a
    sample with no valid key beside one whose keys end inside (or on) a
    tile, or no lengths."""
    rng = np.random.default_rng(n + 7 * with_rope)
    q, k, v = (rng.standard_normal((2, n, 2, 64)).astype(np.float32) for _ in range(3))
    rope = np.array(j_rotary_freqs(n, 64)) if with_rope else None
    lens_np = None if lens is None else np.minimum(np.array(lens, np.int32), n)
    want = jsa.serving_attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        None if lens_np is None else jnp.asarray(lens_np),
        rope=None if rope is None else jnp.asarray(rope), interpret=True)
    got = tsa.serving_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if lens_np is None else torch.from_numpy(lens_np),
        None if rope is None else torch.from_numpy(rope))
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    _close(got.numpy(), np.asarray(want), 1e-5, "fp32 attention")


def test_fp32_kernel_domain_and_counters():
    """The card's argument checks admit fp32 as they admit bf16 (one dtype
    for q, k and v, the same shapes), and the fp32 kernel keeps counters of
    its own, so that every bf16 count stays as it was."""
    q = torch.zeros(2, 6144, 2, 64)
    tsa._check_cuda_args(q, q, q, torch.tensor([6144, 0], dtype=torch.int32), None)
    with pytest.raises(ValueError, match=r"multiple of 64 in \[64, 6144\]"):
        big = torch.zeros(1, 6208, 1, 64)
        tsa._check_cuda_args(big, big, big, None, None)
    with pytest.raises(TypeError, match="v is torch.bfloat16, q torch.float32"):
        tsa._check_cuda_args(q, q, q.bfloat16(), None, None)
    assert tsa.KERNEL_DTYPES == (torch.bfloat16, torch.float32)
    assert set(tsa.serving_attention.launches_fp32_by_rope) == {True, False}
    with pytest.raises(ValueError, match="unsupported device"):
        tsa.serving_attention(*(torch.zeros(1, 64, 1, 64, device="meta"),) * 3)


@pytest.mark.parametrize("d", tta.HEAD_DIMS)
@pytest.mark.parametrize("n", list(range(64, tsa.MAX_N + 1, 64)))
def test_fp32_kernel_geometry_covers_every_row_once_within_the_card(n, d):
    """Kernel 1 fp32's launch over its whole domain (the fp32 forward core
    that kernel 4a's fp32 mode shares): n / 64 blocks a (sample, head) of
    64 query rows, each row owned once and no block past the sample, the
    shared memory within a block's 232,448 bytes. At d = 64 four warps of
    16, a ring of two stages, two blocks an SM; at d = 128 eight warps in
    two sets of four that each cover the block's rows once, one stage of
    32-key K and V tiles a set (big and small parts) beside Q's split
    tiles, one block an SM; every key tile walked by one set."""
    b, h = 2, 16
    geo = tsa.forward_geometry_fp32(b, n, h, d)
    assert geo == tta.forward_geometry_fp32(b, n, h, d)
    assert geo["grid"] == (n // 64, h, b) == (len(geo["blocks"]), h, b)
    sets = {64: 1, 128: 2}[d]
    assert geo["sets"] == sets and geo["threads"] == 128 * sets
    assert geo["warps"] * 32 == geo["threads"] and geo["warps"] // sets * 16 == 64
    assert geo["rows"] == geo["tile"] == 64 and geo["stages"] == {64: 2, 128: 1}[d]
    covered = np.zeros(n, np.int64)
    for block, (start, rows) in enumerate(geo["blocks"]):
        assert (start, rows) == (64 * block, 64) and start + rows <= n
        covered[start:start + rows] += 1
    np.testing.assert_array_equal(covered, 1)
    tile = 64 * (d + 4) * 4
    if d == 64:
        assert geo["key_tile"] == 64 and geo["shared_bytes"] == (2 * 2 + 2) * tile
    else:
        assert geo["key_tile"] == 32 and geo["q_split"]
        assert geo["shared_bytes"] == 2 * tile + 2 * 4 * 32 * (d + 4) * 4
        walked = sorted(t for tiles in tta.set_key_tiles(n, n, d) for t in tiles)
        assert walked == list(range(n // 32))
    assert geo["shared_bytes"] <= tta.SHARED_LIMIT
    per_sm = {64: 2, 128: 1}[d]
    assert geo["blocks_per_sm"] == per_sm
    assert per_sm * (geo["shared_bytes"] + 1024) <= tta.SM_SHARED


@pytest.mark.parametrize("n", [0, 32, 96, tsa.MAX_N + 64])
def test_fp32_kernel_geometry_refuses_outside_the_domain(n):
    with pytest.raises(ValueError, match=r"multiple of 64 in \[64, 6144\]"):
        tsa.forward_geometry_fp32(2, n, 16)


# ---- the feed-forward's fusion gate ----------------------------------------------


def test_feedforward_gate_follows_the_jax_dtype_rule(monkeypatch):
    """In eval mode an fp32 block's feed-forward takes the unfused layernorm
    + modulate + project branch and a bf16 block calls `ln_mod_matmul`
    (the JAX `use_fused_serving` admits bf16 only); the UNetT asks the same
    gate, so its fp32 layers never call the kernel either."""
    calls = []
    real = modules.ln_mod_matmul

    def recording(x, *args, **kwargs):
        calls.append((x.dtype, kwargs.get("norm", "ln")))
        return real(x, *args, **kwargs)

    monkeypatch.setattr(modules, "ln_mod_matmul", recording)
    assert tfm.use_fused_serving(torch.bfloat16) and not tfm.use_fused_serving(torch.float32)
    torch.manual_seed(0)
    ff = FeedForward(128, mult=2).eval()
    x, scale, shift = torch.randn(2, 9, 128), 0.1 * torch.randn(2, 128), torch.randn(2, 128)
    with torch.no_grad():
        got = ff(x, scale, shift)
        want = ff.project(layer_norm(x) * (1 + scale[:, None]) + shift[:, None])
        assert calls == [] and torch.equal(got, want)
        ff.bfloat16()(x.bfloat16(), scale.bfloat16(), shift.bfloat16())
    assert calls == [(torch.bfloat16, "ln")]

    calls.clear()
    arch = TArchConfig(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=None,
                       text_mask_padding=False, pe_attn_head=1, conv_layers=0, dropout=0.0)
    unett = UNetT(arch, 20, MEL).eval()
    rng = np.random.default_rng(1)
    x, cond = (torch.from_numpy(rng.standard_normal((2, 63, MEL)).astype(np.float32))
               for _ in range(2))
    text = torch.from_numpy(rng.integers(0, 20, (2, 30)))
    drop = torch.tensor([False, True])
    for dtype, want_calls in ((torch.float32, []),
                              (torch.bfloat16, [(torch.bfloat16, "rms")] * arch.depth)):
        net = unett.to(dtype)
        with torch.no_grad():
            out = net(x, cond, text, torch.full((2,), 0.4), drop, drop)
        assert torch.isfinite(out).all() and calls == want_calls
        calls.clear()


# ---- the default dtype ------------------------------------------------------------


def test_wrapper_default_dtype_is_the_jax_wrappers():
    """`F5TTSWrapper()` computes in the JAX wrapper's default dtype, and every
    entry point asks `compute_dtype_for`, which gives it on any device."""
    default = inspect.signature(F5TTSWrapper.__init__).parameters["compute_dtype"].default
    want = inspect.signature(JWrapper.__init__).parameters["compute_dtype"].default
    assert default == want == "float32"
    for device in ("cpu", "cuda", "cuda:1", torch.device("cuda", 0)):
        assert utils_infer.compute_dtype_for(torch.device(device)) == "float32"
    w = F5TTSWrapper(model_cfg=CFG, vocab_char_map=VOCAB, device="cpu", **BUCKETS)
    assert w.compute_dtype == "float32"
    assert {p.dtype for p in w.transformer.parameters()} == {torch.float32}
    assert w.vocoder.dtype == torch.float32


def test_socket_server_smoke_wrapper_follows_the_entry_points(monkeypatch):
    """The socket server's tiny test wrapper takes the entry points' dtype on
    the card and on the CPU (it asked bf16 of the card before)."""
    w, state = socket_server.smoke_wrapper("cpu")
    assert w.compute_dtype == "float32" and state.n_frames > 0
    built = []

    class Stop(Exception):
        pass

    def fake(**kwargs):
        built.append(kwargs)
        raise Stop

    monkeypatch.setattr(socket_server, "F5TTSWrapper", fake)
    for device in ("cuda", "cuda:1"):
        with pytest.raises(Stop):
            socket_server.smoke_wrapper(device)
        assert built[-1]["device"] == device and built[-1]["compute_dtype"] == "float32"


# ---- the TF32 block ------------------------------------------------------------------


def test_tf32_block_holds_both_flags_under_two_threads(monkeypatch):
    """Two threads each run an fp32 DiT call and an fp32 Vocos call at once,
    the interpreter switching threads every few microseconds: every product
    and convolution inside them sees TF32 off for both cuBLAS and cuDNN, a
    bf16 call takes no block (it sees the process's flags), and both flags
    are back at their values afterwards, for each value they had."""
    seen = []
    real_linear, real_conv = torch.nn.functional.linear, torch.nn.functional.conv1d

    def flags():
        return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32

    def linear(*args, **kwargs):
        seen.append((threading.current_thread().name, flags()))
        return real_linear(*args, **kwargs)

    def conv1d(*args, **kwargs):
        seen.append((threading.current_thread().name, flags()))
        return real_conv(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "linear", linear)
    monkeypatch.setattr(torch.nn.functional, "conv1d", conv1d)
    torch.manual_seed(0)
    dit = DiT(PORT_ARCH, 20, MEL).eval()
    vocos = Vocos(input_channels=MEL).eval()
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 64, MEL)).astype(np.float32))
    text = torch.from_numpy(rng.integers(0, 20, (2, 16)))
    drop = torch.tensor([False, True])
    errors = []

    def serve():
        try:
            with torch.no_grad():
                for _ in range(2):
                    te = dit.embed_text(text, 64, drop)
                    dit.run(x, x, te, torch.full((2,), 0.5), drop)
                    vocos(x.transpose(1, 2))
        except Exception as exc:  # noqa: BLE001 — surfaced by the assertion below
            errors.append(exc)

    saved, interval = flags(), sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = flag
            seen.clear()
            threads = [threading.Thread(target=serve, name=f"fp32-{i}") for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads) and not errors
            assert flags() == (flag, flag)
            assert len(seen) > 40 and {f for _, f in seen} == {(False, False)}
            assert {name for name, _ in seen} == {"fp32-0", "fp32-1"}
        # bf16 takes no block: its products see the process's flags
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        seen.clear()
        with torch.no_grad():
            dit.bfloat16().run(x, x, dit.embed_text(text, 64, drop), torch.full((2,), 0.5),
                               drop)
        assert seen and {f for _, f in seen} == {(True, True)}
        with modules.fp32_convolutions():
            assert flags() == (False, False)
            with modules.fp32_convolutions():  # re-entrant
                assert flags() == (False, False)
            assert flags() == (False, False)
        assert flags() == (True, True)
    finally:
        sys.setswitchinterval(interval)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---- the slice as a whole: default-built wrappers ------------------------------------


def test_default_wrappers_pcm_matches_jax():
    """A port wrapper and a JAX wrapper, both built without `compute_dtype`
    (fp32, each package's default) on the same weights: one fused
    sample-and-vocode step with the JAX noise handed in, PCM within 4 LSB."""
    params = tiny_params(seed=30)
    vparams = redraw(jax.jit(JVocos().init)(jax.random.key(1), jnp.zeros((1, MEL, 8)))
                     ["params"], seed=31, std=0.05)
    vparams["head_out"]["bias"] += 2.0  # a signal well above 1 LSB
    jw = JWrapper(model_cfg=CFG, vocab_char_map=VOCAB, nfe_step=4, params=params,
                  vocoder_params=vparams, **BUCKETS)
    tw = F5TTSWrapper(model_cfg=CFG, vocab_char_map=VOCAB, nfe_step=4, params=params,
                      vocoder_params=vparams, device="cpu", **BUCKETS)
    assert jw.compute_dtype == tw.compute_dtype == "float32"
    jref = jw.preprocess_reference(ref_audio=_ref_audio(), ref_sample_rate=SR,
                                   ref_text=REF_TEXT)
    rng = np.random.default_rng(32)
    text = np.full((1, 64), -1, np.int32)
    text[0, :50] = rng.integers(0, len(VOCAB), 50)
    n_ref, bucket, duration = jref.n_frames, 128, 118
    vstart = n_ref - twrapper.VOCODE_MARGIN_FRAMES
    key = jax.random.key(33)
    static = dict(steps=4, cfg_strength=2.0, sway=-1.0, max_duration=bucket,
                  vocode_start=vstart, gen_start=n_ref - vstart)
    want_pcm, _ = jw._sample_vocode_jit(
        jw.params, jw.vocoder_params, jref.mel, jnp.asarray(text), jnp.asarray([duration]),
        jnp.asarray([n_ref]), key, jnp.asarray(1.0, jnp.float32), **static)
    noise = np.array(jax.random.normal(key, (bucket, MEL), jnp.float32))
    got_pcm, _ = tw._sample_vocode(
        torch.from_numpy(np.array(jref.mel)), torch.from_numpy(text).long(),
        torch.tensor([duration]), torch.tensor([n_ref]), torch.from_numpy(noise), 1.0,
        **static)
    want_pcm = np.asarray(want_pcm)
    assert got_pcm.shape == want_pcm.shape and np.abs(want_pcm).max() > 1000
    diff = np.abs(got_pcm.numpy().astype(np.int32) - want_pcm.astype(np.int32))
    assert diff.max() <= PCM_LSB, f"PCM differs by {diff.max()} LSB"
