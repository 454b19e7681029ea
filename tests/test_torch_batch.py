"""PyTorch port, batched serving: `F5TTSWrapper.generate_batch` against the
JAX wrapper's on the same weights, reference clip and sampler noise (the
JAX draw handed to the port), in bf16 and in int8.

Tolerances: per-sample lengths exactly; the waveforms within a bound stated
per dtype, from the bf16 DiT's rounding at other points than the JAX DiT
through four Euler steps and the vocoder (and, in int8, the activation
codes that rounding flips); in fp32, a sample alone against the same
sample in a batch within 2 LSB (measured 1: the batch changes only the
GEMMs' row count, and with it their order of summation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.infer.wrapper import F5TTSWrapper as JWrapper
from eraxvif5tts_tpu.models.vocos import Vocos as JVocos
from eraxvif5tts_tpu.ops.quant import quantize_params
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
from test_torch_models import CFG, MEL, redraw, tiny_params

SR = 24000
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,!?'-0123456")}
BUCKETS = dict(duration_buckets=(64, 128, 192, 256), text_buckets=(64, 128))
REF_TEXT = "hello there, this is the reference voice"
# three durations in one bucket; "five six." is under 10 bytes and takes the
# short-text speed 0.3
TEXTS = ["one two three four.", "five six.", "seven eight nine ten eleven."]
SEED = 9
# max |port - JAX| in units of full scale (measured 0.0027 in bf16 and in
# int8, on waves of peak ~0.1)
WAVE_TOL = 0.004


def _ref_audio():
    t = np.arange(int(SR * 0.8)) / SR
    return (0.2 * np.sin(2 * np.pi * 190 * t) + 0.05 * np.sin(2 * np.pi * 900 * t)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    params = tiny_params(seed=40)
    vparams = redraw(jax.jit(JVocos().init)(jax.random.key(1), jnp.zeros((1, MEL, 8)))["params"],
                     seed=41, std=0.05)
    vparams["head_out"]["bias"] += 2.0  # log-magnitude ~2: a signal well above 1 LSB
    return params, vparams


def _wrapper(cls, weights, dtype, **kwargs):
    """A wrapper of either package on the weights (the JAX tree quantized by
    `quantize_params` for int8) and its reference state."""
    params, vparams = weights
    if dtype == "int8":
        params = quantize_params(params)
    wrapper = cls(model_cfg=CFG, vocab_char_map=VOCAB, nfe_step=4, params=params,
                  vocoder_params=vparams, compute_dtype=dtype, **BUCKETS, **kwargs)
    return wrapper, wrapper.preprocess_reference(ref_audio=_ref_audio(), ref_sample_rate=SR,
                                                 ref_text=REF_TEXT)


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's sampler noise replaced by the JAX wrapper's draw for
    ``seed`` (``generate_batch`` hands ``jax.random.key(seed)`` to the
    sampler); returns the shapes drawn."""
    draws = []

    def draw(self, generator, n_frames):
        draws.append(n_frames)
        return torch.from_numpy(np.array(jax.random.normal(jax.random.key(SEED),
                                                           (n_frames, MEL), jnp.float32)))

    monkeypatch.setattr(F5TTSWrapper, "_draw_noise", draw)
    return draws


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_generate_batch_matches_jax(weights, jax_noise, dtype):
    jw, jref = _wrapper(JWrapper, weights, dtype)
    tw, tref = _wrapper(F5TTSWrapper, weights, dtype, device="cpu")
    want = jw.generate_batch(TEXTS, ref=jref, seed=SEED, use_pinyin=False)
    got = tw.generate_batch(TEXTS, ref=tref, seed=SEED, use_pinyin=False)
    # one [bucket, n_mels] draw, shared by the batch
    assert len(jax_noise) == 1 and jax_noise[0] in BUCKETS["duration_buckets"]
    assert [len(w) for w in got] == [len(w) for w in want]
    assert len({len(w) for w in got}) == len(TEXTS)  # per-sample end trim
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.abs(w).max() > 0.02
        assert np.abs(g - w).max() <= WAVE_TOL, np.abs(g - w).max()
    assert tw.generate_batch([], ref=tref) == jw.generate_batch([], ref=jref) == []


def test_generate_batch_sample_alone_matches_the_batch(weights, jax_noise):
    tw, tref = _wrapper(F5TTSWrapper, weights, "float32", device="cpu")
    batch = tw.generate_batch(TEXTS, ref=tref, seed=SEED, use_pinyin=False)
    alone = tw.generate_batch(TEXTS[2:], ref=tref, seed=SEED, use_pinyin=False)[0]
    assert jax_noise[0] == jax_noise[1]  # the same bucket alone and in the batch
    assert alone.shape == batch[2].shape
    assert np.abs(alone - batch[2]).max() <= 2 / 32767.0
