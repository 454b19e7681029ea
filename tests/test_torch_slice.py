"""PyTorch port, the whole slice: zero-shot cloning through the port's
`F5TTSWrapper` against the JAX wrapper on the same weights (every leaf of
both parameter trees redrawn from a seeded normal), the same reference clip
and the same sampler noise (the JAX draw, handed to the port).

Tolerances: the fused sample-and-vocode step's int16 PCM within 4 LSB
(1.2e-4 of full scale: fp32 sums in other orders through four DiT calls and
the vocoder); the reference mel (FFT vs basis convolution) within 1e-5
of its scale in magnitude; `generate`'s waveform within 4 / 32767 after
cross-fading.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.configs import ModelConfig
from eraxvif5tts_tpu.infer.wrapper import F5TTSWrapper as JWrapper
from eraxvif5tts_tpu.models.vocos import Vocos as JVocos
from eraxvif5tts_tpu_torch.infer import wrapper as twrapper
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
from test_torch_models import ARCH, MEL, redraw, tiny_params

SR = 24000
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,!?'-0123456")}
CFG = ModelConfig(name="tiny", arch=ARCH)
BUCKETS = dict(duration_buckets=(64, 128, 192, 256), text_buckets=(64,))
REF_TEXT = "hello there, this is the reference voice"
PCM_LSB = 4


def _ref_audio():
    t = np.arange(int(SR * 0.8)) / SR  # 75 frames: longer than the vocode margin
    return (0.2 * np.sin(2 * np.pi * 190 * t) + 0.05 * np.sin(2 * np.pi * 900 * t)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def wrappers():
    params = tiny_params(seed=20)
    vparams = redraw(jax.jit(JVocos().init)(jax.random.key(1), jnp.zeros((1, MEL, 8)))
                     ["params"], seed=21, std=0.05)
    vparams["head_out"]["bias"] += 2.0  # log-magnitude ~2: a signal well above 1 LSB
    jw = JWrapper(model_cfg=CFG, vocab_char_map=VOCAB, nfe_step=4, params=params,
                  vocoder_params=vparams, compute_dtype="float32", **BUCKETS)
    tw = F5TTSWrapper(model_cfg=CFG, vocab_char_map=VOCAB, nfe_step=4, params=params,
                      vocoder_params=vparams, compute_dtype="float32", device="cpu",
                      **BUCKETS)
    jref = jw.preprocess_reference(ref_audio=_ref_audio(), ref_sample_rate=SR,
                                   ref_text=REF_TEXT)
    tref = tw.preprocess_reference(ref_audio=_ref_audio(), ref_sample_rate=SR,
                                   ref_text=REF_TEXT)
    return jw, jref, tw, tref


def test_reference_state_matches_jax(wrappers):
    jw, jref, tw, tref = wrappers
    assert (tref.text, tref.n_frames, tref.audio_len_samples) == (
        jref.text, jref.n_frames, jref.audio_len_samples)
    assert tref.rms == pytest.approx(jref.rms)
    # log-mel of a two-tone clip: most bins sit near the 1e-5 floor, where the
    # log magnifies rounding; compare the mel magnitudes
    got, want = np.exp(tref.mel.numpy()), np.exp(np.asarray(jref.mel))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_fused_sample_vocode_pcm_matches_jax(wrappers):
    jw, jref, tw, _ = wrappers
    rng = np.random.default_rng(22)
    text = np.full((1, 64), -1, np.int32)
    text[0, :55] = rng.integers(0, len(VOCAB), 55)
    n_ref, bucket, duration = jref.n_frames, 128, 120
    vstart = n_ref - twrapper.VOCODE_MARGIN_FRAMES
    key = jax.random.key(23)
    static = dict(steps=4, cfg_strength=2.0, sway=-1.0, max_duration=bucket,
                  vocode_start=vstart, gen_start=n_ref - vstart)
    want_pcm, want_mel = jw._sample_vocode_jit(
        jw.params, jw.vocoder_params, jref.mel, jnp.asarray(text), jnp.asarray([duration]),
        jnp.asarray([n_ref]), key, jnp.asarray(1.0, jnp.float32), **static)
    noise = np.array(jax.random.normal(key, (bucket, MEL), jnp.float32))
    got_pcm, got_mel = tw._sample_vocode(
        torch.from_numpy(np.array(jref.mel)), torch.from_numpy(text).long(),
        torch.tensor([duration]), torch.tensor([n_ref]), torch.from_numpy(noise), 1.0,
        **static)
    want_pcm = np.asarray(want_pcm)
    assert got_pcm.dtype == torch.int16 and got_pcm.shape == want_pcm.shape
    assert np.abs(want_pcm).max() > 1000  # a real signal, not silence
    diff = np.abs(got_pcm.numpy().astype(np.int32) - want_pcm.astype(np.int32))
    assert diff.max() <= PCM_LSB, f"PCM differs by {diff.max()} LSB"
    np.testing.assert_allclose(got_mel.numpy(), np.asarray(want_mel), atol=1e-4)


def test_generate_matches_jax_chunking_and_wave(wrappers, monkeypatch):
    jw, jref, tw, tref = wrappers
    seed, draws = 5, []

    def jax_noise(self, generator, n_frames):
        key = jax.random.fold_in(jax.random.key(seed), len(draws))
        draws.append(n_frames)
        return torch.from_numpy(np.array(jax.random.normal(key, (n_frames, MEL), jnp.float32)))

    monkeypatch.setattr(F5TTSWrapper, "_draw_noise", jax_noise)
    text = "one two three four five six seven."
    want = jw.generate(text, ref=jref, seed=seed, use_pinyin=False)
    got = tw.generate(text, ref=tref, seed=seed, use_pinyin=False)
    max_chars, hard = tw._max_chars_for(tref)
    assert (max_chars, hard) == jw._max_chars_for(jref)
    from eraxvif5tts_tpu.text.chunk import chunk_text

    assert len(draws) == len(chunk_text(text, max_chars=max_chars, hard_max=hard)) > 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= PCM_LSB / 32767.0
    assert tw.get_current_audio_length() == pytest.approx(len(want) / SR)


def test_float32_wrapper_on_cuda_is_refused():
    """The refusal this test held is gone: fp32 on the card serves through
    its own attention kernel, so only a dtype the port does not serve is
    refused, and an fp32 wrapper on ``cuda`` fails only where there is no
    card to move its weights to (here), never for its dtype."""
    with pytest.raises(ValueError, match="compute_dtype must be one of"):
        F5TTSWrapper(model_cfg=CFG, vocab_char_map=VOCAB, compute_dtype="float16",
                     device="cuda")
    if torch.cuda.is_available():
        w = F5TTSWrapper(model_cfg=CFG, vocab_char_map=VOCAB, device="cuda")
        assert w.compute_dtype == "float32"
        assert next(w.transformer.parameters()).dtype == torch.float32
        return
    with pytest.raises((AssertionError, RuntimeError)) as refused:
        F5TTSWrapper(model_cfg=CFG, vocab_char_map=VOCAB, compute_dtype="float32",
                     device="cuda")
    assert "CUDA" in str(refused.value) and "not ported" not in str(refused.value)


def test_reference_checkpoints_load(wrappers, tmp_path):
    """Reference-format checkpoints (EMA-prefixed F5-TTS .pt with counters;
    a Vocos .pt with its feature-extractor and window buffers) load into the
    port with strict key matching and give the same weights as the JAX
    parameter trees."""
    from eraxvif5tts_tpu.compression.convert import backbone_params_to_torch

    jw, _, tw, _ = wrappers
    dit = backbone_params_to_torch(jax.tree.map(np.asarray, jw.params), "DiT",
                                   ARCH.depth, ARCH.conv_layers)
    ckpt = {f"ema_model.{k}": torch.from_numpy(np.array(v)) for k, v in dit.items()}
    ckpt.update({"initted": torch.tensor(True), "step": torch.tensor(7)})
    torch.save(ckpt, tmp_path / "model.pt")
    vocos = dict(tw.vocoder.state_dict())
    vocos["head.istft.window"] = torch.hann_window(1024)
    vocos["feature_extractor.mel_spec.spectrogram.window"] = torch.hann_window(1024)
    torch.save(vocos, tmp_path / "vocos.pt")
    loaded = F5TTSWrapper(model_cfg=CFG, vocab_char_map=VOCAB, compute_dtype="float32",
                          device="cpu", ckpt_path=str(tmp_path / "model.pt"),
                          vocoder_ckpt_path=str(tmp_path / "vocos.pt"))
    for got, want in ((loaded.transformer, tw.transformer), (loaded.vocoder, tw.vocoder)):
        want_sd = want.state_dict()
        assert got.state_dict().keys() == want_sd.keys()
        for key, value in got.state_dict().items():
            torch.testing.assert_close(value, want_sd[key], rtol=0, atol=0)
