"""PyTorch port, ops layer: each op against its JAX counterpart on the same
numpy inputs (CPU; the port's kernel wrappers take their plain versions for
CPU tensors, the JAX Pallas kernels run in interpret mode).

Tolerances: fp32 comparisons 1e-5 relative to the output's scale unless a
test says otherwise; bf16 comparisons a few bf16 ulps (2^-8 relative), since
the two frameworks round at the same points but accumulate in other orders.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.ops import fused_matmul as jfm
from eraxvif5tts_tpu.ops import serving_attention as jsa
from eraxvif5tts_tpu.ops.masks import lens_to_mask as j_lens_to_mask
from eraxvif5tts_tpu.ops.rotary import abs_pos_embedding_table as j_abs_table
from eraxvif5tts_tpu.ops.rotary import apply_rotary as j_apply_rotary
from eraxvif5tts_tpu.ops.rotary import rotary_freqs as j_rotary_freqs
from eraxvif5tts_tpu.ops.stft import MelSpectrogram as JMel
from eraxvif5tts_tpu.ops.stft import istft as j_istft
from eraxvif5tts_tpu_torch.ops import fused_matmul as tfm
from eraxvif5tts_tpu_torch.ops import serving_attention as tsa
from eraxvif5tts_tpu_torch.ops.attention import dot_product_attention
from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask
from eraxvif5tts_tpu_torch.ops.rotary import abs_pos_embedding_table, apply_rotary, rotary_freqs
from eraxvif5tts_tpu_torch.ops.stft import MelSpectrogram, istft

REPO_ROOT = Path(__file__).resolve().parent.parent

PORT_PACKAGE = REPO_ROOT / "eraxvif5tts_tpu_torch"
# every module of the port, from its files: a new module is covered at once
PORT_MODULES = sorted(
    ".".join(p.relative_to(REPO_ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT_PACKAGE.rglob("*.py"))


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{what}: max error {err:.3g} of scale > {rel}"


def test_port_imports_no_jax_flax_triton():
    """Importing every port module and `chip_smoke` (import only) loads no
    jax, flax, triton or HF datasets, and nothing of the JAX package: the port keeps its
    own copies of the host modules it needs."""
    code = ("import importlib, json, sys\n"
            f"sys.path.insert(0, {str(REPO_ROOT)!r})\n"
            f"for m in {PORT_MODULES + ['chip_smoke']!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax', 'triton', 'datasets', "
            "'eraxvif5tts_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True, cwd=REPO_ROOT)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert {"eraxvif5tts_tpu_torch.models.unett", "eraxvif5tts_tpu_torch.models.mmdit",
            "eraxvif5tts_tpu_torch.models.bigvgan",
            "eraxvif5tts_tpu_torch.tools.bench"} <= set(PORT_MODULES)
    assert len(PORT_MODULES) >= 40


def test_rotary_and_masks_match_jax():
    n, d = 96, 64
    np.testing.assert_array_equal(rotary_freqs(n, d).numpy(), np.asarray(j_rotary_freqs(n, d)))
    np.testing.assert_array_equal(abs_pos_embedding_table(32, 128), j_abs_table(32, 128))
    x = np.random.default_rng(0).standard_normal((2, 3, n, d)).astype(np.float32)
    got = apply_rotary(torch.from_numpy(x), rotary_freqs(n, d))
    want = j_apply_rotary(jnp.asarray(x), j_rotary_freqs(n, d))
    _close(got.numpy(), want, 1e-6, "apply_rotary")
    lens = np.array([0, 5, 96], np.int64)
    np.testing.assert_array_equal(lens_to_mask(torch.from_numpy(lens), n).numpy(),
                                  np.asarray(j_lens_to_mask(jnp.asarray(lens), n)))


def test_mel_spectrogram_matches_jax():
    rng = np.random.default_rng(1)
    wav = (0.3 * rng.standard_normal((2, 24000 // 2))).astype(np.float32)
    got = MelSpectrogram()(torch.from_numpy(wav)).numpy()
    want = np.asarray(jax.jit(JMel().__call__)(jnp.asarray(wav)))
    assert got.shape == want.shape == (2, 100, 24000 // 2 // 256 + 1)
    # log-mel: absolute error; the FFT and the basis convolution sum in other orders
    assert np.abs(got - want).max() < 1e-3


@pytest.mark.parametrize("magnitude", [1.0, 1e6])
def test_istft_matches_jax(magnitude):
    rng = np.random.default_rng(2)
    real = (magnitude * rng.standard_normal((2, 513, 40))).astype(np.float32)
    imag = (magnitude * rng.standard_normal((2, 513, 40))).astype(np.float32)
    got = istft(torch.from_numpy(real), torch.from_numpy(imag)).numpy()
    want = np.asarray(jax.jit(j_istft)(jnp.asarray(real), jnp.asarray(imag)))
    assert got.shape == want.shape == (2, 39 * 256)
    assert np.isfinite(got).all()
    _close(got, want, 1e-5, "istft")


def _attn_inputs(n, seed, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, n, 2, 64)).astype(np.float32) for _ in range(3))
    lens = np.array([0, n - 37], np.int32)  # one sample with no valid key
    rope = np.array(j_rotary_freqs(n, 64))
    j = [jnp.asarray(a, dtype) for a in (q, k, v)]
    t = [torch.from_numpy(a).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
         for a in (q, k, v)]
    return j, t, lens, rope


@pytest.mark.parametrize("n", [256, 320])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_attention_matches_pallas_interpret(n, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    (jq, jk, jv), (tq, tk, tv), lens, rope = _attn_inputs(n, n, jdt)
    want = jsa.serving_attention(jq, jk, jv, jnp.asarray(lens), rope=jnp.asarray(rope),
                                 interpret=True)
    got = tsa.serving_attention(tq, tk, tv, torch.from_numpy(lens), torch.from_numpy(rope))
    assert got.dtype == tq.dtype
    want = np.asarray(want.astype(jnp.float32))
    assert np.isfinite(got.float().numpy()).all()
    # fp32: same algorithm; bf16: one bf16 rounding of P and of the output apart
    _close(got.float().numpy(), want, 1e-5 if dtype == "float32" else 8e-3, "attention")
    # the dispatch layer reduces a prefix mask to the same lengths
    mask = lens_to_mask(torch.from_numpy(lens), n)
    via_mask = dot_product_attention(tq, tk, tv, key_valid=mask, rope=torch.from_numpy(rope))
    torch.testing.assert_close(via_mask, got, rtol=0, atol=0)


@pytest.mark.parametrize("activation", [None, "gelu_tanh"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_mod_matmul_matches_pallas_interpret(activation, dtype):
    rng = np.random.default_rng(3)
    b, m, k, n = 2, 72, 128, 256  # m not a multiple of any tile
    x = (rng.standard_normal((b, m, k)) + 0.5).astype(np.float32)
    scale = (0.1 * rng.standard_normal((b, k))).astype(np.float32)
    shift = (0.1 * rng.standard_normal((b, k))).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    bias = (0.1 * rng.standard_normal((n,))).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jfm.ln_mod_matmul(*(jnp.asarray(a, jdt) for a in (x, scale, shift, w, bias)),
                             activation=activation, interpret=True)
    got = tfm.ln_mod_matmul(*(torch.from_numpy(a).to(tdt) for a in (x, scale, shift)),
                            torch.from_numpy(np.ascontiguousarray(w.T)).to(tdt),
                            torch.from_numpy(bias).to(tdt), activation=activation)
    assert got.dtype == tdt and got.shape == (b, m, n)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           1e-5 if dtype == "float32" else 8e-3, "ln_mod_matmul")


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    """The argument checks that guard the CUDA launches (run here on CPU
    tensors; on a card the same checks raise before any launch)."""
    q = torch.zeros(2, 128, 2, 64, dtype=torch.bfloat16)
    tsa._check_cuda_args(q, q, q, None, None)
    tsa._check_cuda_args(q.float(), q.float(), q.float(), None, None)  # the fp32 kernel
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tsa._check_cuda_args(q.half(), q.half(), q.half(), None, None)
    with pytest.raises(TypeError, match="k is torch.float32, q torch.bfloat16"):
        tsa._check_cuda_args(q, q.float(), q, None, None)
    bad_n = torch.zeros(2, 96, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        tsa._check_cuda_args(bad_n, bad_n, bad_n, None, None)
    bad_d = torch.zeros(2, 128, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tsa._check_cuda_args(bad_d, bad_d, bad_d, None, None)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 2).contiguous().transpose(1, 2)
        tsa._check_cuda_args(t, t, t, None, None)
    misaligned = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        tsa._check_cuda_args(misaligned, misaligned, misaligned, None, None)

    x = torch.zeros(2, 5, 64, dtype=torch.bfloat16)
    s = torch.zeros(2, 64, dtype=torch.bfloat16)
    w = torch.zeros(128, 64, dtype=torch.bfloat16)
    bias = torch.zeros(128, dtype=torch.bfloat16)
    tfm._check_cuda_args(x, s, s, w, bias, "gelu_tanh", "ln", 1e-6)
    tfm._check_cuda_args(x, s, s, w, bias, None, "rms", 1e-12)
    with pytest.raises(TypeError, match="bfloat16"):
        tfm._check_cuda_args(x.float(), s, s, w, bias, None, "ln", 1e-6)
    with pytest.raises(TypeError, match="bfloat16"):
        tfm._check_cuda_args(x.float(), s.float(), s.float(), w.float(), bias.float(), None,
                             "rms", 1e-12)
    with pytest.raises(ValueError, match="multiple"):
        tfm._check_cuda_args(x, s, s, w[:96], bias[:96], None, "rms", 1e-12)
    with pytest.raises(ValueError, match="weight must be"):
        tfm._check_cuda_args(x, s, s, w.t(), bias, None, "ln", 1e-6)
    with pytest.raises(ValueError, match="activation"):
        tfm._check_cuda_args(x, s, s, w, bias, "relu", "ln", 1e-6)
    with pytest.raises(ValueError, match=r"unknown norm 'bogus' \(ln \| rms\)"):
        tfm._check_cuda_args(x, s, s, w, bias, None, "bogus", 1e-6)
    with pytest.raises(ValueError, match="eps must be positive"):
        tfm._check_cuda_args(x, s, s, w, bias, None, "rms", 0.0)
    # the plain version refuses an unknown norm too, and each norm has its eps
    with pytest.raises(ValueError, match="unknown norm 'bogus'"):
        tfm.ln_mod_matmul(x, s, s, w, bias, norm="bogus")
    assert tfm.EPS == {"ln": 1e-6, "rms": 1e-12}


def test_wrapper_refuses_what_is_not_ported():
    """Each refusal of the wrapper and of `build_backbone`, with its message."""
    import dataclasses

    from eraxvif5tts_tpu_torch.configs import PRESETS
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
    from eraxvif5tts_tpu_torch.models import build_backbone

    from eraxvif5tts_tpu_torch.ops import quant

    e2 = PRESETS["E2TTS_Small"]
    tiny = dataclasses.replace(e2.arch, dim=128, depth=2, heads=2)
    # an unknown backbone has no int8 form: refused before any build
    with pytest.raises(ValueError, match="int8 quantization of backbone 'GPT' is not ported"):
        quant.quantize_state_dict({}, 2, "GPT")
    quantized = build_backbone(dataclasses.replace(
        e2, arch=dataclasses.replace(tiny, quantized=True)), 16).train()
    x = torch.zeros(1, 63, e2.mel_spec.n_mel_channels)
    with pytest.raises(ValueError, match="a quantized UNetT serves only"):
        quantized(x, x, torch.zeros(1, 8, dtype=torch.long), torch.zeros(1),
                  torch.zeros(1, dtype=torch.bool), torch.zeros(1, dtype=torch.bool))
    scan = dataclasses.replace(e2, arch=dataclasses.replace(tiny, scan_layers=True))
    for cfg in (scan, dataclasses.replace(scan, backbone="DiT")):
        with pytest.raises(ValueError, match="scan_layers=True .* is not ported"):
            build_backbone(cfg, 16)
        with pytest.raises(ValueError, match="scan_layers=True .* is not ported"):
            F5TTSWrapper(model_cfg=cfg, device="cpu", compute_dtype="float32")
    # the MMDiT preset: int8 builds (and serves only), training refuses the
    # preset's dropout 0.1 (ROADMAP queue 3) and trains at 0
    mm = PRESETS["F5TTS_v1_MMDiT"]
    mm_tiny = dataclasses.replace(mm.arch, dim=128, depth=2, heads=2)
    mm_args = (x, x, torch.zeros(1, 8, dtype=torch.long), torch.zeros(1),
               torch.zeros(1, dtype=torch.bool), torch.zeros(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="a quantized MMDiT serves only"):
        build_backbone(dataclasses.replace(
            mm, arch=dataclasses.replace(mm_tiny, quantized=True)), 16).train()(*mm_args)
    with pytest.raises(ValueError, match="MMDiT training at dropout 0.1 is refused"):
        build_backbone(dataclasses.replace(mm, arch=mm_tiny), 16).train()(*mm_args)
    build_backbone(dataclasses.replace(
        mm, arch=dataclasses.replace(mm_tiny, dropout=0.0)), 16).train()(*mm_args)
    with pytest.raises(ValueError, match="vocoder_name must be 'vocos' or 'bigvgan'"):
        F5TTSWrapper(model_cfg=dataclasses.replace(e2, arch=tiny), vocoder_name="hifigan",
                     device="cpu", compute_dtype="float32")
    with pytest.raises(ValueError, match="unknown backbone 'GPT'"):
        build_backbone(dataclasses.replace(e2, backbone="GPT"), 16)
    with pytest.raises(ValueError, match="depth must be even"):
        build_backbone(dataclasses.replace(e2, arch=dataclasses.replace(tiny, depth=3)), 16)
