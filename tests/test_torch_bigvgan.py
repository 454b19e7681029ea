"""PyTorch port, BigVGAN: the generator against the JAX package's on tiny
configurations (weights from a reference-layout state dict, fresh and
weight-normed in both of PyTorch's layouts, and from the JAX tree), the
alias-free activation's parts, the `bigvgan` mel frontend, the wrapper with
`vocoder_name="bigvgan"` against the JAX wrapper's PCM, `load_vocoder` and
the CLI's `--vocoder_name bigvgan`, and the TF32 switch under concurrent
callers.

Tolerances: the generator 1e-5 of the output's scale in fp32 (convolutions
summed in other orders); the mel frontend 1e-3 absolute in log-mel (the FFT
against the JAX basis convolution, as `tests/test_torch_ops.py`); the
wrapper's int16 PCM within 4 LSB, as `tests/test_torch_slice.py`.
"""

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.infer.wrapper import F5TTSWrapper as JWrapper
from eraxvif5tts_tpu.models import bigvgan as jb
from eraxvif5tts_tpu.ops.stft import MelSpectrogram as JMel
from eraxvif5tts_tpu_torch.audio.io import read_wav, write_wav
from eraxvif5tts_tpu_torch.compression import convert as tconvert
from eraxvif5tts_tpu_torch.infer import infer_cli as tcli
from eraxvif5tts_tpu_torch.infer import utils_infer as tui
from eraxvif5tts_tpu_torch.infer import wrapper as twrapper
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
from eraxvif5tts_tpu_torch.models import bigvgan as tb
from eraxvif5tts_tpu_torch.models import modules
from eraxvif5tts_tpu_torch.ops.stft import MelSpectrogram
from test_bigvgan import TINY, _TTinyBigVGAN
from test_torch_models import close, redraw, tiny_params
from test_torch_slice import BUCKETS, CFG, PCM_LSB, REF_TEXT, SR, VOCAB, _ref_audio

MEL = 100
# snakebeta, three kernel sizes with their own dilations, two stages
TINY3 = jb.BigVGANConfig(num_mels=8, upsample_initial_channel=32, upsample_rates=(4, 2),
                         upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3, 7, 11),
                         resblock_dilation_sizes=((1, 3, 5), (1, 3), (1,)))
# the v1 base's options: snake without beta, tanh, a bias at the end
TINY_V1 = dataclasses.replace(TINY, activation="snake", use_tanh_at_final=True,
                              use_bias_at_final=True)
# a vocoder for the wrapper: 100 mels, hop 256 = 4 x 4 x 4 x 4
WRAPPER_VOCODER = jb.BigVGANConfig(upsample_initial_channel=64, upsample_rates=(4, 4, 4, 4),
                                   upsample_kernel_sizes=(8, 8, 8, 8),
                                   resblock_kernel_sizes=(3, 7),
                                   resblock_dilation_sizes=((1, 3), (1, 3, 5)))


def port_config(config):
    """The port's copy of a JAX `BigVGANConfig` (the two are distinct types)."""
    return tb.BigVGANConfig(**dataclasses.asdict(config))


def _jax_wave(config, params, mel):
    return np.asarray(jax.jit(jb.BigVGAN(config).__call__)(params, jnp.asarray(mel)))


def _port_wave(config, state_dict, mel):
    net = tb.BigVGAN(port_config(config))
    net.load_state_dict(state_dict, strict=True)
    with torch.no_grad():
        return net.eval()(torch.from_numpy(mel)).numpy()


def _mel(config, frames=20, seed=70):
    return np.random.default_rng(seed).standard_normal(
        (2, config.num_mels, frames)).astype(np.float32)


def _numpy_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _weight_normed(module, parametrized: bool):
    """``module`` with weight norm on each of its convolutions: the legacy
    ``weight_g`` / ``weight_v`` or the ``parametrizations.weight.original0/1``
    layout (reference checkpoints carry one of the two)."""
    norm = (torch.nn.utils.parametrizations.weight_norm if parametrized
            else torch.nn.utils.weight_norm)
    for sub in list(module.modules()):
        if isinstance(sub, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            norm(sub)
            with torch.no_grad():  # a gain that is not the weight's own norm
                g = (sub.parametrizations.weight.original0 if parametrized else sub.weight_g)
                g.mul_(1.5)
    return module


@pytest.mark.parametrize("layout", ["fresh", "weight_norm", "parametrizations"])
def test_bigvgan_matches_jax_on_a_reference_state_dict(layout):
    """A reference-layout generator (the JAX test's independent torch model,
    snake alphas and betas drawn) read by both packages' importers, weight
    norm fused by each: the waves agree to 1e-5 of scale."""
    torch.manual_seed(0)
    ref = _TTinyBigVGAN(TINY).eval()
    if layout != "fresh":
        ref = _weight_normed(ref, layout == "parametrizations")
    sd = _numpy_sd(ref)
    assert any(k.endswith("weight_g") or k.endswith("original0") for k in sd) == (
        layout != "fresh")
    mel = _mel(TINY)
    want = _jax_wave(TINY, jb.bigvgan_params_from_torch(sd, TINY), mel)
    got = _port_wave(TINY, tconvert.bigvgan_state_dict_from_reference(sd, port_config(TINY)),
                     mel)
    assert got.shape == want.shape == (2, 20 * 4)
    close(got, want, 1e-5, f"BigVGAN {layout}")
    # under a `generator` key, and with tensors rather than arrays
    nested = {"generator": dict(ref.state_dict())}
    again = tconvert.bigvgan_state_dict_from_reference(nested, port_config(TINY))
    for key, value in tconvert.bigvgan_state_dict_from_reference(sd, port_config(TINY)).items():
        torch.testing.assert_close(again[key], value, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["tiny", "tiny3", "v1_base"])
def test_bigvgan_matches_jax_on_its_random_tree(name):
    """`init_random_params(np.random.default_rng(1))` of the JAX generator,
    every leaf then redrawn (snake parameters and biases included, so that
    they are not zero), carried across by `bigvgan_state_dict_from_jax`:
    1e-5 of scale. `random_state_dict` draws what `init_random_params` draws."""
    config = {"tiny": TINY, "tiny3": TINY3, "v1_base": TINY_V1}[name]
    raw = jb.BigVGAN(config).init_random_params(np.random.default_rng(1))
    params = redraw(raw, seed=71, std=0.05)
    mel = _mel(config)
    want = _jax_wave(config, params, mel)
    assert 1e-2 < np.abs(want).max() < 0.95  # a signal the clamp / tanh leaves alone
    got = _port_wave(config, tconvert.bigvgan_state_dict_from_jax(params),
                     mel)
    close(got, want, 1e-5, f"BigVGAN {name}")
    drawn = tb.random_state_dict(port_config(config), np.random.default_rng(1))
    from_tree = tconvert.bigvgan_state_dict_from_jax(raw)
    assert set(drawn) == set(from_tree)
    for key, value in from_tree.items():
        np.testing.assert_array_equal(drawn[key], value.numpy(), err_msg=key)


def test_alias_free_parts_match_jax():
    """The filter bit for bit, the 2x up- and downsampling and both snakes
    against the JAX functions (1e-6 of scale)."""
    for args in ((0.25, 0.3, 12), (0.5, 0.6, 12), (0.25, 0.3, 11), (0.0, 0.3, 12)):
        np.testing.assert_array_equal(tb.kaiser_sinc_filter1d(*args),
                                      jb.kaiser_sinc_filter1d(*args))
    filt = jb.kaiser_sinc_filter1d(0.25, 0.3, 12)
    x = np.random.default_rng(72).standard_normal((2, 3, 40)).astype(np.float32)
    jx, tx, tf = jnp.asarray(x.transpose(0, 2, 1)), torch.from_numpy(x), torch.from_numpy(filt)
    close(tb.upsample2x(tx, tf).numpy(),
          np.asarray(jb.upsample2x(jx, jnp.asarray(filt))).transpose(0, 2, 1), 1e-6, "up")
    close(tb.lowpass_downsample2x(tx, tf).numpy(),
          np.asarray(jb.lowpass_downsample2x(jx, jnp.asarray(filt))).transpose(0, 2, 1),
          1e-6, "down")
    alpha, beta = np.array([0.5, -0.2, 0.1], np.float32), np.array([-0.3, 0.2, 0.0], np.float32)
    for logscale in (True, False):
        close(tb.snakebeta(tx, torch.from_numpy(alpha), torch.from_numpy(beta), logscale).numpy(),
              np.asarray(jb.snakebeta(jx, alpha, beta, logscale)).transpose(0, 2, 1), 1e-6,
              "snakebeta")
        close(tb.snake(tx, torch.from_numpy(alpha), logscale).numpy(),
              np.asarray(jb.snake(jx, alpha, logscale)).transpose(0, 2, 1), 1e-6, "snake")


def test_bigvgan_configs_equal_the_jax_packages():
    assert dataclasses.asdict(tb.BigVGANConfig()) == dataclasses.asdict(jb.BigVGANConfig())
    assert dataclasses.asdict(tb.BIGVGAN_BASE_24KHZ) == dataclasses.asdict(
        jb.BIGVGAN_BASE_24KHZ)
    with torch.device("meta"):
        full = tb.BigVGAN()
    assert full.conv_pre.out_channels == 1536 and len(full.resblocks) == 18
    assert not any("filter" in key for key in full.state_dict())


@pytest.mark.parametrize("mel_spec_type", ["vocos", "bigvgan"])
def test_mel_frontends_match_jax(mel_spec_type):
    """Both mel frontends against `MelSpectrogram(mel_spec_type=...)` of the
    JAX package: the bigvgan one pads (n_fft - hop) / 2 by reflection, takes
    no centre and the Slaney filterbank, and gives one frame fewer."""
    rng = np.random.default_rng(73)
    wav = (0.3 * rng.standard_normal((2, 256 * 47))).astype(np.float32)
    got = MelSpectrogram(mel_spec_type=mel_spec_type)(torch.from_numpy(wav)).numpy()
    want = np.asarray(jax.jit(JMel(mel_spec_type=mel_spec_type).__call__)(jnp.asarray(wav)))
    assert got.shape == want.shape == (2, 100, 47 + (mel_spec_type == "vocos"))
    assert np.abs(got - want).max() < 1e-3
    with pytest.raises(ValueError, match="unknown mel_spec_type"):
        MelSpectrogram(mel_spec_type="hifigan")


def test_fp32_convolutions_hold_under_concurrent_callers():
    """Two threads vocode at once, with the interpreter switching threads
    every few microseconds: every BigVGAN convolution sees TF32 off, and the
    process-wide cuDNN flag is back at its value afterwards (both values)."""
    net = tb.BigVGAN(port_config(TINY3)).eval()
    seen, errors = [], []
    for module in net.modules():
        if isinstance(module, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            module.register_forward_pre_hook(
                lambda m, args: seen.append(torch.backends.cudnn.allow_tf32))
    mel = torch.from_numpy(_mel(TINY3, frames=12))

    def vocode():
        try:
            for _ in range(3):
                with torch.no_grad():
                    net(mel)
        except Exception as exc:  # noqa: BLE001 — surfaced by the assertion below
            errors.append(exc)

    saved_flag, saved_interval = torch.backends.cudnn.allow_tf32, sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            threads = [threading.Thread(target=vocode) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads) and not errors
            assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        sys.setswitchinterval(saved_interval)
        torch.backends.cudnn.allow_tf32 = saved_flag
    n_convs = sum(isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d))
                  for m in net.modules())
    assert len(seen) == 2 * 2 * 3 * n_convs and not any(seen)
    # the duration predictor's convolutions take the same switch
    with modules.fp32_convolutions():
        assert torch.backends.cudnn.allow_tf32 is False
        with modules.fp32_convolutions():  # re-entrant
            assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is saved_flag


# ---------------------------------------------------------------------------
# the wrapper


def _wrapper_vocoder_params():
    raw = jb.BigVGAN(WRAPPER_VOCODER).init_random_params(np.random.default_rng(1))
    return redraw(raw, seed=74, std=0.05)


@pytest.fixture(scope="module")
def wrappers():
    params = tiny_params(seed=75)
    common = dict(model_cfg=CFG, vocab_char_map=VOCAB, nfe_step=4, params=params,
                  vocoder_params=_wrapper_vocoder_params(), vocoder_name="bigvgan",
                  compute_dtype="float32", **BUCKETS)
    jw = JWrapper(vocoder_config=WRAPPER_VOCODER, **common)
    tw = F5TTSWrapper(vocoder_config=port_config(WRAPPER_VOCODER), device="cpu", **common)
    refs = [w.preprocess_reference(ref_audio=_ref_audio(), ref_sample_rate=SR,
                                   ref_text=REF_TEXT) for w in (jw, tw)]
    return jw, refs[0], tw, refs[1]


def test_bigvgan_wrapper_takes_the_bigvgan_frontend(wrappers):
    """`vocoder_name="bigvgan"` overrides the configuration's mel frontend, as
    in the JAX wrapper; the reference mel's magnitudes agree to 1e-5 of
    scale; the vocoder's parameters stay fp32."""
    jw, jref, tw, tref = wrappers
    assert tw.mel_spec_type == jw.mel_spec_type == "bigvgan"
    assert tw.config.mel_spec.mel_spec_type == jw.config.mel_spec.mel_spec_type == "bigvgan"
    assert tw.mel_spec.mel_spec_type == "bigvgan" and isinstance(tw.vocoder, tb.BigVGAN)
    assert all(p.dtype == torch.float32 for p in tw.vocoder.parameters())
    assert tref.n_frames == jref.n_frames
    got, want = np.exp(tref.mel.numpy()), np.exp(np.asarray(jref.mel))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_bigvgan_sample_vocode_pcm_matches_jax(wrappers):
    """The fused sample-and-vocode step with BigVGAN: int16 PCM within 4 LSB
    of the JAX wrapper's, the JAX noise handed in."""
    jw, jref, tw, _ = wrappers
    rng = np.random.default_rng(76)
    text = np.full((1, 64), -1, np.int32)
    text[0, :55] = rng.integers(0, len(VOCAB), 55)
    n_ref, bucket, duration = jref.n_frames, 128, 120
    vstart = n_ref - twrapper.VOCODE_MARGIN_FRAMES
    key = jax.random.key(77)
    static = dict(steps=4, cfg_strength=2.0, sway=-1.0, max_duration=bucket,
                  vocode_start=vstart, gen_start=n_ref - vstart)
    want_pcm, want_mel = jw._sample_vocode_jit(
        jw.params, jw.vocoder_params, jref.mel, jnp.asarray(text), jnp.asarray([duration]),
        jnp.asarray([n_ref]), key, jnp.asarray(1.0, jnp.float32), **static)
    noise = np.array(jax.random.normal(key, (bucket, MEL), jnp.float32))
    got_pcm, got_mel = tw._sample_vocode(
        torch.from_numpy(np.array(jref.mel)), torch.from_numpy(text).long(),
        torch.tensor([duration]), torch.tensor([n_ref]), torch.from_numpy(noise), 1.0, **static)
    want_pcm = np.asarray(want_pcm)
    assert got_pcm.dtype == torch.int16 and got_pcm.shape == want_pcm.shape
    assert np.abs(want_pcm).max() > 1000  # a real signal, not silence
    diff = np.abs(got_pcm.numpy().astype(np.int32) - want_pcm.astype(np.int32))
    assert diff.max() <= PCM_LSB, f"PCM differs by {diff.max()} LSB"
    np.testing.assert_allclose(got_mel.numpy(), np.asarray(want_mel), atol=1e-4)


def test_bigvgan_generate_matches_jax_wave(wrappers, monkeypatch):
    jw, jref, tw, tref = wrappers
    seed, draws = 8, []

    def jax_noise(self, generator, n_frames):
        key = jax.random.fold_in(jax.random.key(seed), len(draws))
        draws.append(n_frames)
        return torch.from_numpy(np.array(jax.random.normal(key, (n_frames, MEL), jnp.float32)))

    monkeypatch.setattr(F5TTSWrapper, "_draw_noise", jax_noise)
    text = "one two three four five six seven."
    want = jw.generate(text, ref=jref, seed=seed, use_pinyin=False)
    got = tw.generate(text, ref=tref, seed=seed, use_pinyin=False)
    assert len(draws) > 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= PCM_LSB / 32767.0


def test_bigvgan_wrapper_default_and_checkpoint_weights(tmp_path):
    """Without weights the wrapper draws the JAX wrapper's random BigVGAN
    (`init_random_params(default_rng(1))`); from a weight-normed reference
    generator checkpoint it loads what the JAX importer reads."""
    common = dict(model_cfg=CFG, vocab_char_map=VOCAB, params=tiny_params(seed=78),
                  vocoder_name="bigvgan", compute_dtype="float32", device="cpu")
    tw = F5TTSWrapper(vocoder_config=port_config(WRAPPER_VOCODER), **common)
    want = tconvert.bigvgan_state_dict_from_jax(
        jb.BigVGAN(WRAPPER_VOCODER).init_random_params(np.random.default_rng(1)))
    for key, value in tw.vocoder.state_dict().items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0, msg=key)
    torch.manual_seed(1)
    ref = _weight_normed(_TTinyBigVGAN(WRAPPER_VOCODER), parametrized=False)
    torch.save({"generator": ref.state_dict()}, tmp_path / "bigvgan_generator.pt")
    tw = F5TTSWrapper(vocoder_config=port_config(WRAPPER_VOCODER),
                      vocoder_ckpt_path=str(tmp_path / "bigvgan_generator.pt"), **common)
    mel = _mel(WRAPPER_VOCODER, frames=8)
    want = _jax_wave(WRAPPER_VOCODER,
                     jb.bigvgan_params_from_torch(_numpy_sd(ref), WRAPPER_VOCODER), mel)
    with torch.no_grad():
        close(tw.vocoder(torch.from_numpy(mel)).numpy(), want, 1e-5, "checkpoint BigVGAN")
    with pytest.raises(ValueError, match="vocoder_name must be 'vocos' or 'bigvgan'"):
        F5TTSWrapper(**dict(common, vocoder_name="hifigan"))


# ---------------------------------------------------------------------------
# load_vocoder and the CLI


def test_load_vocoder_bigvgan_matches_jax(tmp_path):
    """`load_vocoder("bigvgan", is_local=True, local_path=...)` reads a
    reference generator checkpoint (weight-normed, under `generator`) as the
    JAX `load_bigvgan` does; without one it draws the JAX function's random
    generator (seed 0)."""
    torch.manual_seed(2)
    ref = _weight_normed(_TTinyBigVGAN(TINY), parametrized=True)
    path = str(tmp_path / "bigvgan_generator.pt")
    torch.save({"generator": ref.state_dict()}, path)
    got = tui.load_vocoder("bigvgan", is_local=True, local_path=path, device="cpu",
                           vocoder_config=port_config(TINY))
    assert isinstance(got, tb.BigVGAN) and not got.training
    jmodel, jparams = jb.load_bigvgan(path, TINY)
    mel = _mel(TINY)
    with torch.no_grad():
        close(got(torch.from_numpy(mel)).numpy(), _jax_wave(TINY, jparams, mel), 1e-5,
              "load_vocoder(bigvgan)")
    drawn = tui.load_vocoder("bigvgan", device="cpu", vocoder_config=port_config(TINY3))
    want = jb.BigVGAN(TINY3).init_random_params(np.random.default_rng(0))
    mel = _mel(TINY3)
    with torch.no_grad():
        close(drawn(torch.from_numpy(mel)).numpy(), _jax_wave(TINY3, want, mel), 1e-5,
              "load_vocoder(bigvgan) random")


def test_cli_vocoder_name_bigvgan(tmp_path, monkeypatch):
    """`--vocoder_name bigvgan` reaches the wrapper, which vocodes with
    BigVGAN (a tiny one here: the CLI's wrapper is built with the tiny
    model's configuration and vocoder added) and writes a finite WAV."""
    ref_path = str(tmp_path / "ref.wav")
    write_wav(ref_path, _ref_audio(), SR)
    built = {}

    def tiny_wrapper(**kwargs):
        built.update(kwargs)
        kwargs = {k: v for k, v in kwargs.items() if k not in ("model_name", "vocab_file")}
        return F5TTSWrapper(model_cfg=CFG, vocab_char_map=VOCAB, params=tiny_params(seed=79),
                            vocoder_config=port_config(WRAPPER_VOCODER), **BUCKETS, **kwargs)

    monkeypatch.setattr(tcli, "F5TTSWrapper", tiny_wrapper)
    out = tmp_path / "out"
    tcli.main(["-t", "a short line for the vocoder.", "-r", ref_path, "-s", REF_TEXT,
               "--vocoder_name", "bigvgan", "--device", "cpu", "--nfe_step", "2",
               "-o", str(out), "-w", "cli.wav"])
    assert built["vocoder_name"] == "bigvgan" and built["compute_dtype"] == "float32"
    wav, sr = read_wav(str(out / "cli.wav"))
    assert sr == SR and wav.shape[1] > SR // 4 and np.isfinite(wav).all()
    assert np.abs(wav).max() > 0  # random weights: a quiet signal, not silence
