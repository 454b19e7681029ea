"""PyTorch port, inference porcelain: `CFM.sample`'s editing inputs, speech
editing, `utils_infer`, the CLI, the `F5TTS` API and the gradio-free core of
the web UI, against the JAX package on the same weights (every leaf of both
parameter trees redrawn from a seeded normal), the same clips and the same
sampler noise (the JAX draw, handed to the port through `_draw_noise`).

Tolerances: `CFM.sample` 1e-5 of the mel's scale (fp32, as
`tests/test_torch_cfm.py`); `edit_speech`, handed the JAX frontend's mel of
the edited clip too, 1e-5 of the mel's scale and 1e-4 of the waveform's (the
vocoder adds an ISTFT of large magnitudes), and with the port's own frontend
the kept frames' magnitudes within 1e-5 of scale (as `tests/test_torch_slice.py`
holds the reference mel); waveforms through `generate` within 4 / 32767
(`tests/test_torch_slice.py`'s PCM_LSB).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.audio.io import read_wav as j_read_wav
from eraxvif5tts_tpu.infer import infer_cli as jcli
from eraxvif5tts_tpu.infer import speech_edit as jedit
from eraxvif5tts_tpu.infer import utils_infer as jui
from eraxvif5tts_tpu.infer.wrapper import F5TTSWrapper as JWrapper
from eraxvif5tts_tpu.models.cfm import CFM as JCFM
from eraxvif5tts_tpu.models.cfm import sway_time_grid as j_sway_time_grid
from eraxvif5tts_tpu.models.vocos import Vocos as JVocos
from eraxvif5tts_tpu_torch.audio.io import read_wav, write_wav
from eraxvif5tts_tpu_torch.infer import api as tapi
from eraxvif5tts_tpu_torch.infer import infer_cli as tcli
from eraxvif5tts_tpu_torch.infer import infer_gradio as tgradio
from eraxvif5tts_tpu_torch.infer import speech_edit as tedit
from eraxvif5tts_tpu_torch.infer import utils_infer as tui
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
from eraxvif5tts_tpu_torch.models.cfm import CFM, sway_time_grid
from test_torch_models import MEL, VOCAB, close, port_dit, redraw, tiny_jax_dit, tiny_params
from test_torch_slice import BUCKETS, CFG, PCM_LSB, REF_TEXT, SR
from test_torch_slice import VOCAB as VOCAB_MAP
from test_torch_slice import _ref_audio

REPO_ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = REPO_ROOT / "eraxvif5tts_tpu" / "infer" / "examples"
MAXD = 128


# ---- shared tiny wrappers and the JAX noise ---------------------------------


def tiny_wrappers(nfe_step: int = 2):
    """The JAX wrapper and the port's, fp32 on the CPU, on the same redrawn
    weights (as `tests/test_torch_slice.py`)."""
    params = tiny_params(seed=20)
    vparams = redraw(jax.jit(JVocos().init)(jax.random.key(1), jnp.zeros((1, MEL, 8)))
                     ["params"], seed=21, std=0.05)
    vparams["head_out"]["bias"] += 2.0  # log-magnitude ~2: a signal well above 1 LSB
    jw = JWrapper(model_cfg=CFG, vocab_char_map=VOCAB_MAP, nfe_step=nfe_step, params=params,
                  vocoder_params=vparams, compute_dtype="float32", **BUCKETS)
    tw = F5TTSWrapper(model_cfg=CFG, vocab_char_map=VOCAB_MAP, nfe_step=nfe_step,
                      params=params, vocoder_params=vparams, compute_dtype="float32",
                      device="cpu", **BUCKETS)
    return jw, tw


def jax_noise(fold: bool):
    """A replacement for `F5TTSWrapper._draw_noise` that draws what the JAX
    package draws for the generator's seed: per chunk
    ``fold_in(key(seed), chunk)`` (`generate`) or ``key(seed)`` itself
    (`edit_speech`). The generators seen are kept, so their chunk counts
    cannot pass to a new generator at a reused address."""
    seen: list = []

    def draw(self, generator, n_frames):
        for entry in seen:
            if entry[0] is generator:
                break
        else:
            entry = [generator, 0]
            seen.append(entry)
        key = jax.random.key(generator.initial_seed())
        if fold:
            key = jax.random.fold_in(key, entry[1])
        entry[1] += 1
        return torch.from_numpy(np.array(jax.random.normal(key, (n_frames, MEL), jnp.float32)))

    return draw


@pytest.fixture(scope="module")
def wrappers():
    return tiny_wrappers()


@pytest.fixture(scope="module")
def ref_wav_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("refs") / "ref.wav")
    write_wav(path, _ref_audio(), SR)
    return path


# ---- CFM.sample: edit mask, no reference audio, intermediate start ---------


@pytest.fixture(scope="module")
def cfms():
    params = tiny_params(seed=10)
    return JCFM(transformer=tiny_jax_dit()), params, CFM(port_dit(params))


def _sample_inputs(seed=30):
    rng = np.random.default_rng(seed)
    cond = rng.standard_normal((2, 60, MEL)).astype(np.float32)
    text = np.full((2, 64), -1, np.int32)
    text[0, :50] = rng.integers(0, VOCAB, 50)
    text[1, :20] = rng.integers(0, VOCAB, 20)
    return cond, text, np.array([60, 44]), np.array([110, 128])


CASES = {
    "edit_mask": dict(edit_mask=True),
    "no_ref_audio": dict(no_ref_audio=True),
    "t_start_with_inter": dict(t_start=0.4, inter=True),
    "t_start_without_inter": dict(t_start=0.4),
    "all_inputs": dict(edit_mask=True, no_ref_audio=True, t_start=0.25, inter=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cfm_sample_editing_inputs_match_jax(cfms, case):
    jcfm, params, cfm = cfms
    opts = CASES[case]
    cond, text, lens, duration = _sample_inputs()
    rng = np.random.default_rng(31)
    kw_j, kw_t = {}, {}
    if opts.get("edit_mask"):
        em = np.ones((2, 90), bool)  # shorter than MAXD: padded with False
        em[0, 10:25] = False
        em[1, 30:44] = False
        kw_j["edit_mask"], kw_t["edit_mask"] = jnp.asarray(em), torch.from_numpy(em)
    if opts.get("no_ref_audio"):
        kw_j["no_ref_audio"] = kw_t["no_ref_audio"] = True
    if "t_start" in opts:
        kw_j["t_start"] = kw_t["t_start"] = opts["t_start"]
    if opts.get("inter"):
        inter = rng.standard_normal((2, 100, MEL)).astype(np.float32)
        kw_j["t_inter_cond"], kw_t["t_inter_cond"] = jnp.asarray(inter), torch.from_numpy(inter)
    key = jax.random.key(32)
    want = np.asarray(jcfm.sample(params, jnp.asarray(cond), jnp.asarray(text),
                                  jnp.asarray(duration), jnp.asarray(lens), key, steps=3,
                                  cfg_strength=2.0, sway_sampling_coef=-1.0,
                                  max_duration=MAXD, **kw_j))
    noise = np.array(jax.random.normal(key, (MAXD, MEL), jnp.float32))
    got = cfm.sample(torch.from_numpy(cond), torch.from_numpy(text).long(),
                     torch.from_numpy(duration), torch.from_numpy(lens),
                     noise=torch.from_numpy(noise), steps=3, cfg_strength=2.0,
                     sway_sampling_coef=-1.0, max_duration=MAXD, **kw_t).numpy()
    close(got, want, 1e-5, f"CFM.sample {case}")
    if opts.get("edit_mask") and not opts.get("no_ref_audio"):
        # edited frames are generated, kept prompt frames pasted back
        np.testing.assert_array_equal(got[0, :10], cond[0, :10])
        assert not np.array_equal(got[0, 10:25], cond[0, 10:25])
    if opts.get("no_ref_audio") and not opts.get("edit_mask"):
        assert np.all(got[0, :60] == 0)  # the zeroed prompt is what is pasted back


def test_default_sample_ignores_unused_editing_inputs(cfms):
    """`t_inter_cond` without `t_start` is ignored, and an all-True edit mask is
    no edit: both give the default sampler's output bit for bit."""
    _, _, cfm = cfms
    cond, text, lens, duration = _sample_inputs(33)
    noise = torch.from_numpy(np.random.default_rng(34).standard_normal((MAXD, MEL))
                             .astype(np.float32))
    args = (torch.from_numpy(cond), torch.from_numpy(text).long(),
            torch.from_numpy(duration), torch.from_numpy(lens))
    kw = dict(noise=noise, steps=2, max_duration=MAXD)
    base = cfm.sample(*args, **kw)
    inter = torch.ones((2, MAXD, MEL))
    assert torch.equal(cfm.sample(*args, t_inter_cond=inter, **kw), base)
    assert torch.equal(cfm.sample(*args, edit_mask=torch.ones((2, MAXD), dtype=torch.bool),
                                  **kw), base)


@pytest.mark.parametrize("t_start", [0.0, 0.3])
@pytest.mark.parametrize("coef", [-1.0, None])
def test_sway_time_grid_with_t_start_matches_jax(t_start, coef):
    np.testing.assert_allclose(sway_time_grid(16, coef, t_start).numpy(),
                               np.asarray(j_sway_time_grid(16, coef, t_start)), atol=1e-7)


# ---- speech editing ----------------------------------------------------------


@pytest.mark.parametrize("fix", [None, [0.3]])
def test_edit_speech_matches_jax(wrappers, monkeypatch, fix):
    """The same edit through both packages, the port handed the JAX noise and
    the JAX frontend's mel of the edited clip: the zeroed span puts bins at
    the log floor, where the two frontends' rounding (FFT vs basis
    convolution) differs by up to 0.15 in log units and moves the generated
    frames by ~2e-3; the frontends themselves are held in magnitude below."""
    jw, tw = wrappers
    monkeypatch.setattr(F5TTSWrapper, "_draw_noise", jax_noise(fold=False))
    audio = _ref_audio()
    kw = dict(edit_spans_seconds=[(0.25, 0.45)], fix_durations_seconds=fix, nfe_step=2,
              seed=7, use_pinyin=False, return_mel=True)
    jwave, jmel, jmask = jedit.edit_speech(jw, audio, REF_TEXT, "hello dog", **kw)
    own_wave, own_mel, _ = tedit.edit_speech(tw, audio, REF_TEXT, "hello dog", **kw)
    monkeypatch.setattr(tw, "mel_spec",
                        lambda wav: torch.from_numpy(np.array(jw._mel_jit(wav.numpy()))))
    twave, tmel, tmask = tedit.edit_speech(tw, audio, REF_TEXT, "hello dog", **kw)
    np.testing.assert_array_equal(tmask, jmask)
    assert tmask.dtype == bool and not tmask.all() and tmask[:10].all()
    assert tmel.shape == np.asarray(jmel).shape == (MEL, len(tmask))
    close(tmel, jmel, 1e-5, "edit mel")
    assert twave.shape == np.asarray(jwave).shape and twave.dtype == np.float32
    close(twave, jwave, 1e-4, "edit wave")
    # the wave alone, as without return_mel
    alone = tedit.edit_speech(tw, audio, REF_TEXT, "hello dog",
                              **{**kw, "return_mel": False})
    np.testing.assert_array_equal(alone, twave)
    # with the port's own frontend: kept frames are its conditioning mel,
    # pasted back exactly, and equal to the JAX ones in magnitude
    monkeypatch.undo()
    wave, mask = tedit.edit_inputs(audio, kw["edit_spans_seconds"], fix, SR, 256)
    cond = tw.mel_spec(torch.from_numpy(wave[None])).transpose(1, 2)[0, :len(mask)].numpy()
    np.testing.assert_array_equal(own_mel.T[mask], cond[mask])
    kept, want = np.exp(own_mel[:, mask]), np.exp(np.asarray(jmel)[:, mask])
    assert np.abs(kept - want).max() <= 1e-5 * np.abs(want).max()
    assert np.isfinite(own_wave).all() and own_wave.shape == twave.shape


@pytest.mark.parametrize("spans", [[(0.5, 0.2)], [(0.1, 0.3), (0.2, 0.25)], [(0.9, 1.2)]])
def test_edit_span_validation_matches_jax(wrappers, spans):
    jw, tw = wrappers
    audio = _ref_audio()
    with pytest.raises(ValueError) as want:
        jedit.edit_speech(jw, audio, "a", "b", spans, nfe_step=1)
    with pytest.raises(ValueError) as got:
        tedit.edit_speech(tw, audio, "a", "b", spans, nfe_step=1)
    assert str(got.value) == str(want.value)
    assert "spans must be ascending, non-overlapping and inside the clip" in str(got.value)


@pytest.mark.parametrize("text", ["1.5:2.7,4.0:4.8", "0:1", "0.25:0.5,2:3,7.5:9"])
def test_parse_spans_matches_jax(text):
    assert tedit.parse_spans(text) == jedit.parse_spans(text)


@pytest.mark.parametrize("text", ["1.5", "1:2,3"])
def test_parse_spans_errors_match_jax(text):
    with pytest.raises(ValueError) as want:
        jedit.parse_spans(text)
    with pytest.raises(ValueError) as got:
        tedit.parse_spans(text)
    assert str(got.value) == str(want.value)


# ---- utils_infer ---------------------------------------------------------------


def test_infer_process_matches_jax(wrappers, ref_wav_path, monkeypatch):
    jw, tw = wrappers
    monkeypatch.setattr(F5TTSWrapper, "_draw_noise", jax_noise(fold=True))
    text = "one two three four five six seven."
    want = jui.infer_process(ref_wav_path, REF_TEXT, text, jw, nfe_step=2, seed=3,
                             show_info=lambda *_: None)
    got = tui.infer_process(ref_wav_path, REF_TEXT, text, tw, nfe_step=2, seed=3,
                            show_info=lambda *_: None)
    assert got[1] == want[1] == SR
    assert got[0].shape == want[0].shape and got[2].shape == np.asarray(want[2]).shape
    assert np.abs(got[0] - want[0]).max() <= PCM_LSB / 32767.0
    close(got[2], want[2], 1e-4, "infer_process spectrogram")


def test_infer_batch_process_streams_and_batches(wrappers, ref_wav_path, monkeypatch):
    jw, tw = wrappers
    monkeypatch.setattr(F5TTSWrapper, "_draw_noise", jax_noise(fold=True))
    wav, sr = read_wav(ref_wav_path)
    texts = ["first piece.", "second piece."]
    kw = dict(nfe_step=2, seed=0)
    chunks = list(tui.infer_batch_process((wav, sr), REF_TEXT, texts, tw, streaming=True,
                                          chunk_size=1024, **kw))
    want_chunks = list(jui.infer_batch_process((j_read_wav(ref_wav_path)), REF_TEXT, texts,
                                               jw, streaming=True, chunk_size=1024, **kw))
    assert [len(c) for c, _ in chunks] == [len(c) for c, _ in want_chunks]
    assert all(len(c) <= 1024 and s == SR for c, s in chunks)
    got = np.concatenate([c for c, _ in chunks])
    assert np.abs(got - np.concatenate([c for c, _ in want_chunks])).max() <= PCM_LSB / 32767
    (wave, s, spec), = tui.infer_batch_process((wav, sr), REF_TEXT, texts, tw, **kw)
    (jwave, _, jspec), = jui.infer_batch_process((wav, sr), REF_TEXT, texts, jw, **kw)
    assert s == SR and wave.shape == jwave.shape and spec.shape == np.asarray(jspec).shape
    assert np.abs(wave - jwave).max() <= PCM_LSB / 32767
    (none, s, _), = tui.infer_batch_process((wav, sr), REF_TEXT, [], tw)
    assert none is None and s == SR


def test_preprocess_ref_audio_text_matches_jax(ref_wav_path, monkeypatch):
    for text in ("hello ref", "hello ref.", "done. ", "好。"):
        path_t, text_t = tui.preprocess_ref_audio_text(ref_wav_path, text,
                                                       show_info=lambda *_: None)
        path_j, text_j = jui.preprocess_ref_audio_text(ref_wav_path, text,
                                                       show_info=lambda *_: None)
        assert text_t == text_j
        np.testing.assert_array_equal(read_wav(path_t)[0], j_read_wav(path_j)[0])
    # an empty text goes through the md5 cache to the backend, once per clip
    calls = []
    monkeypatch.setattr(tui, "_ref_audio_cache", {})
    monkeypatch.setattr(tui, "_asr_pipe", lambda path: calls.append(path) or "heard it")
    for _ in range(2):
        _, text = tui.preprocess_ref_audio_text(ref_wav_path, "", show_info=lambda *_: None)
        assert text == "heard it. "
    assert len(calls) == 1


def test_transcription_backend_is_local_or_loud(monkeypatch, tmp_path):
    monkeypatch.setattr(tui, "_asr_pipe", None)
    with pytest.raises(NotImplementedError, match="would need its weights fetched"):
        tui.transcribe("x.wav")
    tui.initialize_asr_pipeline(pipe=lambda path, language=None: f" {language or 'any'} ")
    assert tui.transcribe("x.wav") == "any" and tui.transcribe("x.wav", "vi") == "vi"


def test_load_vocoder(tmp_path):
    from eraxvif5tts_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig

    small = BigVGANConfig(upsample_initial_channel=16, upsample_rates=(2,),
                          upsample_kernel_sizes=(4,), resblock_kernel_sizes=(3,),
                          resblock_dilation_sizes=((1,),))
    bigvgan = tui.load_vocoder("bigvgan", device="cpu", vocoder_config=small)
    assert isinstance(bigvgan, BigVGAN) and not bigvgan.training
    with pytest.raises(ValueError, match="unknown vocoder"):
        tui.load_vocoder("hifigan", device="cpu")
    a, b = tui.load_vocoder(device="cpu"), tui.load_vocoder(device="cpu")
    assert not a.training and next(a.parameters()).device.type == "cpu"
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name  # seeded: two calls agree
    sd = dict(a.state_dict())
    sd = {k: v + 0.01 for k, v in sd.items()}
    sd["head.istft.window"] = torch.hann_window(1024)
    sd["feature_extractor.mel_spec.spectrogram.window"] = torch.hann_window(1024)
    torch.save(sd, tmp_path / "vocos.pt")
    loaded = tui.load_vocoder(is_local=True, local_path=str(tmp_path / "vocos.pt"),
                              device="cpu")
    for name, p in loaded.state_dict().items():
        assert torch.equal(p, sd[name]), name


def test_load_model_builds_the_checkpoint(wrappers, tmp_path):
    from eraxvif5tts_tpu.compression.convert import backbone_params_to_torch

    jw, tw = wrappers
    a = CFG.arch
    dit = backbone_params_to_torch(jax.tree.map(np.asarray, jw.params), "DiT", a.depth,
                                   a.conv_layers)
    torch.save({f"ema_model.{k}": torch.from_numpy(np.array(v)) for k, v in dit.items()},
               tmp_path / "model.pt")
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB_MAP) + "\n", encoding="utf-8")
    arch = dict(dim=a.dim, depth=a.depth, heads=a.heads, dim_head=a.dim_head,
                ff_mult=a.ff_mult, text_dim=a.text_dim, conv_layers=a.conv_layers)
    w = tui.load_model("DiT", arch, str(tmp_path / "model.pt"), str(tmp_path / "vocab.txt"),
                       device="cpu")
    assert w.device.type == "cpu" and w.compute_dtype == "float32"
    want = tw.transformer.state_dict()
    for k, v in w.transformer.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_remove_silence_and_spectrogram_match_jax(tmp_path):
    rng = np.random.default_rng(40)
    wav = np.concatenate([0.3 * rng.standard_normal(SR), np.zeros(2 * SR),
                          0.3 * rng.standard_normal(SR // 2)]).astype(np.float32)
    for mod, name in ((tui, "t.wav"), (jui, "j.wav")):
        write_wav(str(tmp_path / name), wav, SR)
        mod.remove_silence_for_generated_wav(str(tmp_path / name))
    got, want = read_wav(str(tmp_path / "t.wav"))[0], read_wav(str(tmp_path / "j.wav"))[0]
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] < len(wav)
    spec = rng.standard_normal((MEL, 40)).astype(np.float32)
    tui.save_spectrogram(spec, str(tmp_path / "spec.png"))
    assert (tmp_path / "spec.png").exists() or (tmp_path / "spec.png.npy").exists()


# ---- the CLI -------------------------------------------------------------------


def test_cli_run_matches_jax(wrappers, ref_wav_path, tmp_path, monkeypatch):
    jw, tw = wrappers
    monkeypatch.setattr(F5TTSWrapper, "_draw_noise", jax_noise(fold=True))
    argv = ["-r", ref_wav_path, "-s", REF_TEXT, "-t", "a cli test. [alt]Another voice!",
            "--nfe_step", "2", "--seed", "4", "-w", "out.wav", "--save_chunk"]
    got = tcli.run(tcli.merge_config(tcli.parse_args([*argv, "-o", str(tmp_path / "t")])),
                   wrapper=tw)
    want = jcli.run(jcli.merge_config(jcli.parse_args([*argv, "-o", str(tmp_path / "j")])),
                    wrapper=jw)
    (g, sr), (w, _) = read_wav(got), read_wav(want)
    assert sr == SR and g.shape == w.shape and g.shape[1] > 0
    assert np.abs(g - w).max() <= 2 * PCM_LSB / 32767  # and the wav's int16 rounding
    assert sorted(os.listdir(tmp_path / "t" / "out_chunks")) == sorted(
        os.listdir(tmp_path / "j" / "out_chunks"))


def test_cli_runs_the_bundled_tomls(wrappers, ref_wav_path, tmp_path):
    _, tw = wrappers
    basic, story = EXAMPLES / "basic" / "basic.toml", EXAMPLES / "multi" / "story.toml"
    cfg = tcli.merge_config(tcli.parse_args([
        "-c", str(basic), "-r", ref_wav_path, "-s", "hello ref.",
        "-t", "an example config test.", "-o", str(tmp_path), "--nfe_step", "2",
        "--seed", "0"]))
    path = tcli.run(cfg, wrapper=tw)
    assert os.path.isfile(path) and path.endswith("infer_cli_basic.wav")
    # the story: a gen_file and three voices, read from any CWD; the bundled
    # clips carry no text, so each voice gets one here
    cfg = tcli.merge_config(tcli.parse_args(["-c", str(story), "-o", str(tmp_path),
                                             "--nfe_step", "1", "--seed", "0"]))
    assert cfg == jcli.merge_config(jcli.parse_args(["-c", str(story), "-o", str(tmp_path),
                                                     "--nfe_step", "1", "--seed", "0"]))
    cfg["ref_text"] = "the main voice."
    for voice in cfg["voices"].values():
        voice["ref_text"] = "another voice."
    text = Path(tcli.resolve_example_path(cfg["gen_file"])).read_text()
    cfg["gen_text"], cfg["gen_file"] = " ".join(text.split()[:12]), ""
    cwd = os.getcwd()
    try:
        os.chdir(tmp_path)
        path = tcli.run(cfg, wrapper=tw)
    finally:
        os.chdir(cwd)
    wav, sr = read_wav(path)
    assert sr == SR and wav.shape[1] > 0 and np.isfinite(wav).all()


def test_merge_config_and_example_paths_match_jax(tmp_path):
    toml = tmp_path / "cfg.toml"
    toml.write_text('model = "F5TTS_v1_Base"\nnfe_step = 16\nref_audio = "x.wav"\n'
                    'device = "cpu"\n')
    for argv in (["-c", str(toml), "--nfe_step", "8"], ["-t", "x", "--remove_silence"],
                 ["-c", str(EXAMPLES / "basic" / "basic.toml"), "--device", "cuda:1"]):
        assert tcli.merge_config(tcli.parse_args(argv)) == jcli.merge_config(
            jcli.parse_args(argv))
    assert tcli.merge_config(tcli.parse_args(["-c", str(toml), "--nfe_step", "8"]))[
        "nfe_step"] == 8
    cwd = os.getcwd()
    try:
        os.chdir(tmp_path)
        for path in ("eraxvif5tts_tpu/infer/examples/multi/town.wav",
                     "eraxvif5tts_tpu/infer/examples/multi/story.txt", "no/such/file.wav", ""):
            assert tcli.resolve_example_path(path) == jcli.resolve_example_path(path)
        assert os.path.isabs(tcli.resolve_example_path(
            "eraxvif5tts_tpu/infer/examples/multi/town.wav"))
    finally:
        os.chdir(cwd)


def test_cli_device_rules(wrappers, ref_wav_path, tmp_path, monkeypatch):
    _, tw = wrappers
    base = dict(gen_text="x.", ref_audio=ref_wav_path, ref_text="r.", output_dir=str(tmp_path),
                output_file="o.wav")
    for bad in ("tpu", "mps", "cuda:x", "xla"):
        with pytest.raises(ValueError, match="not supported by the PyTorch/CUDA port"):
            tcli.run({**base, "device": bad}, wrapper=tw)
    with pytest.raises(ValueError, match="pre-built wrapper is on cpu"):
        tcli.run({**base, "device": "cuda"}, wrapper=tw)
    with pytest.raises(ValueError, match="configure the wrapper at construction"):
        tcli.run({**base, "ckpt_file": "m.pt", "target_rms": 0.2}, wrapper=tw)
    # --vocoder_name configures the wrapper (BigVGAN is ported): not a pre-built one
    with pytest.raises(ValueError, match="configure the wrapper at construction"):
        tcli.run({**base, "vocoder_name": "bigvgan"}, wrapper=tw)
    # without --device the CLI builds its wrapper on the card, in fp32 (the JAX default)
    built = {}

    class Stop(Exception):
        pass

    def fake_wrapper(**kwargs):
        built.update(kwargs)
        raise Stop

    monkeypatch.setattr(tcli, "F5TTSWrapper", fake_wrapper)
    for device, want in ((None, ("cuda", "float32")), ("cpu", ("cpu", "float32")),
                         ("cuda:1", ("cuda:1", "float32"))):
        with pytest.raises(Stop):
            tcli.main(["-t", "x", "-r", ref_wav_path] + (["--device", device] if device else []))
        assert (str(built["device"]), built["compute_dtype"]) == want
        assert built["vocoder_name"] is None  # the model's own mel frontend
    with pytest.raises(Stop):
        tcli.main(["-t", "x", "-r", ref_wav_path, "--vocoder_name", "bigvgan"])
    assert built["vocoder_name"] == "bigvgan"


# ---- the F5TTS API -------------------------------------------------------------


def test_f5tts_refusals_match_jax():
    from eraxvif5tts_tpu.infer import api as japi

    for kwargs in (dict(ode_method="midpoint"), dict(hf_cache_dir="/x")):
        with pytest.raises(ValueError) as want:
            japi.F5TTS(**kwargs)
        with pytest.raises(ValueError) as got:
            tapi.F5TTS(device="cpu", **kwargs)
        assert str(got.value) == str(want.value)
    for device in ("tpu", "mps", "xpu", "cuda:0:1"):
        with pytest.raises(ValueError, match="not supported by the PyTorch/CUDA port"):
            tapi.F5TTS(device=device)


def test_f5tts_devices_and_infer(wrappers, ref_wav_path, tmp_path, monkeypatch):
    _, tw = wrappers
    built = []

    def fake_wrapper(**kwargs):
        built.append(kwargs)
        return tw

    monkeypatch.setattr(tapi, "F5TTSWrapper", fake_wrapper)
    for device, want in ((None, ("cuda", "float32")), ("cuda", ("cuda", "float32")),
                         ("cuda:2", ("cuda:2", "float32")), ("cpu", ("cpu", "float32"))):
        tts = tapi.F5TTS(device=device, ckpt_file="m.pt", vocab_file="v.txt")
        assert (str(built[-1]["device"]), built[-1]["compute_dtype"]) == want
        assert built[-1]["ckpt_path"] == "m.pt" and built[-1]["vocab_file"] == "v.txt"
    wav, sr, spec = tts.infer(ref_wav_path, "hello ref.", "an api test.", nfe_step=2,
                              file_wave=str(tmp_path / "api.wav"), show_info=lambda *_: None)
    assert sr == SR and len(wav) > 0 and np.isfinite(wav).all() and spec.shape[0] == MEL
    assert isinstance(tts.seed, int)
    np.testing.assert_allclose(read_wav(str(tmp_path / "api.wav"))[0][0], wav, atol=1 / 16384)


# ---- the web UI's gradio-free core -------------------------------------------


@pytest.mark.parametrize("text", [
    "{Regular} Hello. {Surprised} What?! {Whisper} bye...", "plain text",
    "lead {A} one {B}{C} two {} three", ""])
def test_parse_speechtypes_text_matches_jax(text):
    from eraxvif5tts_tpu.infer.infer_gradio import parse_speechtypes_text

    assert tgradio.parse_speechtypes_text(text) == parse_speechtypes_text(text)


def test_generate_multistyle_and_model_slot(wrappers, ref_wav_path, tmp_path):
    _, tw = wrappers
    t = np.arange(SR // 2) / SR
    other = str(tmp_path / "other.wav")
    write_wav(other, (0.2 * np.sin(2 * np.pi * 420 * t)).astype(np.float32), SR)
    refs = {"Regular": (ref_wav_path, "hello ref. "), "Whisper": (other, "soft voice. ")}
    wave, sr = tgradio.generate_multistyle(
        tw, refs, "{Regular} one. {Whisper} two. {Unknown} three.", nfe_step=2, seed=0)
    assert sr == SR and len(wave) > 0 and np.isfinite(wave).all()
    wave, _ = tgradio.generate_multistyle(tw, refs, "", nfe_step=2)
    assert wave.shape == (1,)
    slot = tgradio.ModelSlot(wrapper=tw)
    assert slot.active(True) is tw and slot.active(False) is tw


def test_chat_session_matches_jax():
    from eraxvif5tts_tpu.infer.infer_gradio import ChatSession as JChat

    def fake_chat(messages):
        return f"reply #{sum(m['role'] == 'user' for m in messages)}"

    sessions = [tgradio.ChatSession(system_prompt="stay brief."),
                JChat(system_prompt="stay brief.")]
    for s in sessions:
        assert s.process_input("  ", fake_chat) is None
        s.process_input("hello", fake_chat)
        s.process_input("again", fake_chat)
    assert sessions[0].history == sessions[1].history == [("hello", "reply #1"),
                                                          ("again", "reply #2")]
    assert sessions[0].messages == sessions[1].messages
    for s in sessions:
        s.set_system_prompt("new persona")
    assert sessions[0].messages == sessions[1].messages and sessions[0].history == []
    assert tgradio.DEFAULT_SYSTEM_PROMPT == tgradio.ChatSession().system_prompt


def test_chat_response_synthesis(wrappers, ref_wav_path):
    _, tw = wrappers
    s = tgradio.ChatSession()
    assert tgradio.synthesize_chat_response(tw, s, ref_wav_path, "hello ref. ") is None
    s.process_input("say hi", lambda m: "hi there.")
    assert tgradio.synthesize_chat_response(tw, s, None, "hello ref. ") is None
    sr, wave = tgradio.synthesize_chat_response(tw, s, ref_wav_path, "hello ref. ")
    assert sr == SR and len(wave) > 0 and np.isfinite(wave).all()


def test_gradio_and_chat_backends_are_loud(monkeypatch):
    from eraxvif5tts_tpu.infer import infer_gradio as jgradio

    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError) as want:
        jgradio.build_app(None)
    with pytest.raises(ImportError) as got:
        tgradio.build_app(None)
    assert str(got.value) == str(want.value)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="pass chat_fn"):
        tgradio.load_default_chat_fn()


def test_lazy_branches_import_no_jax():
    """The branches that import on call (gradio, the chat backend, the
    vinorm normalizer, the vocoder and ASR builders) load no jax, flax,
    triton or JAX-package module either."""
    code = f"""
import json, sys
sys.path.insert(0, {str(REPO_ROOT)!r})
sys.modules["gradio"] = None
sys.modules["transformers"] = None
from eraxvif5tts_tpu_torch.infer import infer_gradio, utils_infer
from eraxvif5tts_tpu_torch.models.bigvgan import BigVGANConfig
from eraxvif5tts_tpu_torch.serving import http_server
small = BigVGANConfig(upsample_initial_channel=16, upsample_rates=(2,), upsample_kernel_sizes=(4,),
                      resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),))
for call in (lambda: infer_gradio.build_app(None), infer_gradio.load_default_chat_fn,
             lambda: utils_infer.load_vocoder("bigvgan", device="cpu", vocoder_config=small),
             utils_infer.initialize_asr_pipeline):
    try:
        call()
    except (ImportError, ValueError, NotImplementedError):
        pass
utils_infer.load_vocoder(device="cpu")
assert http_server._ttsnorm("Xin chao") and http_server._CLIENT_HTML
print(json.dumps(sorted(m for m in sys.modules
                        if m.split('.')[0] in ('jax', 'flax', 'triton', 'eraxvif5tts_tpu'))))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True, cwd=REPO_ROOT)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
