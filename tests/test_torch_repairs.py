"""PyTorch port, five behaviours of the JAX package that the port lacked:

- the socket server's `main` resolves `--device` as every other entry point
  does and builds its wrapper in that device's serving dtype: fp32 on the
  CPU, as the JAX server's wrapper;

- `F5TTSWrapper(ckpt_path=<the port trainer's model_* directory>)` serves the
  checkpoint's EMA weights (the raw parameters with ``use_ema=False``), depth
  and vocabulary size read from it, as the JAX wrapper serves its trainer's;
- `TTSStreamingProcessor.update_reference` switches the voice;
- `preprocess_reference(ref_text="", transcribe_fn=...)` transcribes through
  the md5-keyed cache and fails loudly, with the JAX package's messages;
- `F5TTSWrapper.warmup` has the JAX signature and returns the same warmed
  (duration bucket, text bucket) pairs for the same config and reference.
"""

import dataclasses

import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.configs import ModelConfig as JModelConfig
from eraxvif5tts_tpu.infer import utils_infer as jutils
from eraxvif5tts_tpu.infer.wrapper import F5TTSWrapper as JWrapper
from eraxvif5tts_tpu_torch.audio.io import write_wav
from eraxvif5tts_tpu_torch.configs import ArchConfig, ModelConfig
from eraxvif5tts_tpu_torch.infer import utils_infer as tutils
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
from eraxvif5tts_tpu_torch.models.cfm import CFM
from eraxvif5tts_tpu_torch.models.dit import DiT
from eraxvif5tts_tpu_torch.serving import socket_server
from eraxvif5tts_tpu_torch.serving.socket_server import TTSStreamingProcessor, smoke_wrapper
from eraxvif5tts_tpu_torch.training import trainer as ttr
from test_torch_models import ARCH as JARCH

SR = 24000
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,!?'-0123456")}
ARCH = ArchConfig(dim=128, depth=3, heads=2, dim_head=64, ff_mult=2, text_dim=32,
                  conv_layers=1, dropout=0.0)
MEL = 100
REF_TEXT = "hello there, this is the reference voice"


def _tone(freq=190.0, seconds=0.8):
    t = np.arange(int(SR * seconds)) / SR
    return (0.2 * np.sin(2 * np.pi * freq * t) + 0.05 * np.sin(2 * np.pi * 900 * t)
            ).astype(np.float32)


# ---- the wrapper serves what the trainer writes ----------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Three steps of the port's Trainer on a tiny DiT, saved."""
    torch.manual_seed(0)
    dit = DiT(ARCH, len(VOCAB), MEL)
    trainer = ttr.Trainer(cfm=CFM(dit.train()),
                          optimizer=ttr.make_optimizer(learning_rate=1e-3, num_warmup_updates=1,
                                                       total_updates=10),
                          ema_update_after_step=0, ema_update_every=1,
                          checkpoint_dir=str(tmp_path_factory.mktemp("ckpts")))
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        batch = {"mel": rng.standard_normal((2, 32, MEL)).astype(np.float32),
                 "text": rng.integers(0, len(VOCAB), (2, 12)).astype(np.int32),
                 "lens": np.asarray([32, 27], np.int32)}
        state, metrics = trainer.train_step(state, batch, gen)
        assert metrics["applied"] == 1.0
    return state, trainer.save_checkpoint(state)


@pytest.mark.parametrize("as_file", [False, True])
def test_wrapper_serves_the_port_trainers_checkpoint(trained, as_file):
    state, path = trained
    # the preset's depth is not the checkpoint's: it is read from the state
    cfg = ModelConfig(name="tiny", arch=dataclasses.replace(ARCH, depth=2))
    ckpt = path + "/state.pt" if as_file else path
    wrapper = F5TTSWrapper(model_cfg=cfg, ckpt_path=ckpt, vocab_char_map=VOCAB, nfe_step=2,
                           compute_dtype="float32", device="cpu",
                           duration_buckets=(64, 128), text_buckets=(64, 128))
    assert wrapper.config.arch.depth == ARCH.depth
    served = dict(wrapper.transformer.named_parameters())
    assert served.keys() == state.ema_params.keys()
    moved = 0
    for name, ema in state.ema_params.items():
        assert torch.equal(served[name], ema), name
        moved += int(not torch.equal(ema, state.params[name]))
    assert moved > 0  # after three updates the EMA is not the raw parameters
    wrapper.preprocess_reference(ref_audio=_tone(), ref_sample_rate=SR, ref_text=REF_TEXT)
    wave = wrapper.generate("a short line.", seed=0)
    assert len(wave) > 0 and np.isfinite(wave).all()


def test_wrapper_serves_the_raw_parameters_without_ema(trained):
    state, path = trained
    wrapper = F5TTSWrapper(model_cfg=ModelConfig(name="tiny", arch=ARCH), ckpt_path=path,
                           use_ema=False, vocab_char_map=VOCAB, compute_dtype="float32",
                           device="cpu")
    for name, p in wrapper.transformer.named_parameters():
        assert torch.equal(p, state.params[name]), name


def test_wrapper_refuses_a_checkpoint_without_parameters(tmp_path):
    (tmp_path / "model_1").mkdir()
    torch.save({"step": 1}, tmp_path / "model_1" / "state.pt")
    with pytest.raises(ValueError, match="params"):
        F5TTSWrapper(model_cfg=ModelConfig(name="tiny", arch=ARCH),
                     ckpt_path=str(tmp_path / "model_1"), vocab_char_map=VOCAB,
                     compute_dtype="float32", device="cpu")
    small = {c: i for i, c in enumerate("ab")}
    torch.manual_seed(0)
    dit = DiT(ARCH, len(small), MEL)
    torch.save({"params": dit.state_dict(), "ema_params": {}}, tmp_path / "model_1" / "state.pt")
    with pytest.raises(ValueError, match="text embedding holds 2"):
        F5TTSWrapper(model_cfg=ModelConfig(name="tiny", arch=ARCH),
                     ckpt_path=str(tmp_path / "model_1"), vocab_char_map=VOCAB,
                     compute_dtype="float32", device="cpu")


# ---- the socket processor changes its voice --------------------------------


def test_update_reference_switches_the_voice(tmp_path):
    wrapper, first = smoke_wrapper("cpu")
    proc = TTSStreamingProcessor(wrapper, ref_state=first, nfe_step=2, output_file=None,
                                 warm_up=False)
    budgets = (proc.max_chars, proc.few_chars, proc.min_chars)
    second_wav = tmp_path / "second.wav"
    write_wav(str(second_wav), _tone(310.0, 1.5), SR)
    proc.update_reference(str(second_wav), "a second and rather longer reference sentence")
    assert proc.ref is not first and proc.ref.n_frames > first.n_frames
    assert proc.ref.text == "a second and rather longer reference sentence. "
    assert (proc.max_chars, proc.few_chars, proc.min_chars) != budgets
    used, generate = [], wrapper.generate
    wrapper.generate = lambda text, **kw: (used.append(kw["ref"]), generate(text, **kw))[1]
    sent: list[bytes] = []
    proc.generate_stream("hello again.", sent.append)
    assert sent[-1] == b"END" and len(sent) > 1
    assert used and all(ref is proc.ref for ref in used)


# ---- an empty reference text is transcribed, or fails loudly ---------------


@pytest.fixture()
def no_cache():
    tutils._ref_audio_cache.clear()
    jutils._ref_audio_cache.clear()
    yield
    tutils._ref_audio_cache.clear()
    jutils._ref_audio_cache.clear()


def test_transcribe_override_is_called_once_per_clip(no_cache):
    wrapper, _ = smoke_wrapper("cpu")
    paths = []

    def fake_asr(path):
        paths.append(path)
        return "  xin chao  "

    for _ in range(2):
        ref = wrapper.preprocess_reference(ref_audio=_tone(), ref_sample_rate=SR, ref_text=" ",
                                           transcribe_fn=fake_asr)
        assert ref.text == "xin chao. "
    assert len(paths) == 1 and paths[0].endswith(".wav")
    # another clip is another key
    wrapper.preprocess_reference(ref_audio=_tone(250.0), ref_sample_rate=SR, ref_text="",
                                 transcribe_fn=fake_asr)
    assert len(paths) == 2
    # a given text never reaches the backend
    wrapper.preprocess_reference(ref_audio=_tone(400.0), ref_sample_rate=SR, ref_text="given",
                                 transcribe_fn=fake_asr)
    assert len(paths) == 2


def test_transcription_failures_raise_the_jax_messages(no_cache):
    wav = _tone()

    def broken(path):
        raise OSError("no model here")

    messages = {}
    for name, fn in (("port", tutils.transcribe_array_cached),
                     ("jax", jutils.transcribe_array_cached)):
        with pytest.raises(RuntimeError) as failed:
            fn(wav, SR, transcribe_fn=broken)
        with pytest.raises(RuntimeError) as empty:
            fn(wav, SR, transcribe_fn=lambda path: "   ")
        messages[name] = (str(failed.value), str(empty.value))
    assert messages["port"] == messages["jax"]
    assert "automatic transcription failed (OSError: no model here)" in messages["port"][0]
    assert "returned empty text" in messages["port"][1]
    assert tutils._ref_audio_cache == {}  # a failure is not cached


def test_empty_text_without_a_backend_raises(no_cache):
    wrapper, _ = smoke_wrapper("cpu")
    with pytest.raises(RuntimeError, match="automatic transcription failed .*pass ref_text"):
        wrapper.preprocess_reference(ref_audio=_tone(), ref_sample_rate=SR, ref_text="")
    with pytest.raises(RuntimeError, match="automatic transcription failed"):
        wrapper.preprocess_reference(ref_audio=_tone(), ref_sample_rate=SR, ref_text="",
                                     transcribe_fn=lambda path: 1 / 0)


# ---- warmup -----------------------------------------------------------------

BUCKETS = dict(duration_buckets=(64, 128), text_buckets=(32, 64, 128, 256))


def test_warmup_pairs_match_the_jax_wrapper():
    """The reference's frames overfill the 64-frame bucket, so one duration
    bucket is reachable; the text buckets run from the reference's own pinyin
    token count to that of a full chunk."""
    jw = JWrapper(model_cfg=JModelConfig(name="tiny", arch=JARCH), vocab_char_map=VOCAB,
                  nfe_step=1, compute_dtype="float32", **BUCKETS)
    tw = F5TTSWrapper(model_cfg=ModelConfig(name="tiny", arch=dataclasses.replace(ARCH, depth=2)),
                      vocab_char_map=VOCAB, nfe_step=1, compute_dtype="float32", device="cpu",
                      **BUCKETS)
    jref = jw.preprocess_reference(ref_audio=_tone(), ref_sample_rate=SR, ref_text=REF_TEXT)
    tref = tw.preprocess_reference(ref_audio=_tone(), ref_sample_rate=SR, ref_text=REF_TEXT)
    assert tref.n_frames == jref.n_frames and 64 <= tref.n_frames < 128
    want = jw.warmup(jref)
    got = tw.warmup(tref)
    assert got == want and len(got) >= 2 and all(bucket == 128 for bucket, _ in got)
    assert got == [(128, tb) for tb in sorted(tb for _, tb in got)]
    # the arguments narrow the loop as in the JAX wrapper
    assert tw.warmup(tref, nfe_step=1, buckets=(64, 128), text_buckets=(32,)) == [(128, 32)]
    assert tw.warmup(tref, buckets=(64,)) == []
    tw.ref = None
    with pytest.raises(RuntimeError, match="preprocess_reference"):
        tw.warmup()


def test_socket_server_main_resolves_the_device_and_its_dtype(monkeypatch):
    """`socket_server.main([..., "--device", "cpu"])` builds an fp32 wrapper
    on the CPU (the JAX server's dtype; it built a bf16 one before), the
    card's names give fp32 too (the JAX wrapper's default), `--device tpu`
    fails with the port's message, and
    `--smoke --device cpu` serves the tiny fp32 wrapper."""
    built, served = [], []

    def tiny_wrapper(**kwargs):
        built.append(kwargs)
        if torch.device(kwargs["device"]).type != "cpu":
            return None  # the card's wrapper is not built here
        cfg = ModelConfig(name="tiny", arch=ARCH)
        return F5TTSWrapper(model_cfg=cfg, vocab_char_map=VOCAB, nfe_step=2,
                            **{k: v for k, v in kwargs.items()
                               if k in ("device", "compute_dtype")})

    monkeypatch.setattr(socket_server, "F5TTSWrapper", tiny_wrapper)
    monkeypatch.setattr(socket_server, "TTSStreamingProcessor",
                        lambda wrapper, **kwargs: ("processor", wrapper))
    monkeypatch.setattr(socket_server, "start_server",
                        lambda host, port, processor: served.append(processor))
    for device, want in (("cpu", ("cpu", "float32")), ("cuda", ("cuda", "float32")),
                         ("cuda:1", ("cuda:1", "float32"))):
        socket_server.main(["--device", device, "--port", "0"])
        assert (str(built[-1]["device"]), built[-1]["compute_dtype"]) == want
    wrapper = served[0][1]
    assert wrapper.compute_dtype == "float32" and wrapper.device == torch.device("cpu")
    assert next(wrapper.transformer.parameters()).dtype == torch.float32
    for bad in ("tpu", "mps", "cuda:x"):
        with pytest.raises(ValueError, match="not supported by the PyTorch/CUDA port"):
            socket_server.main(["--device", bad])
    socket_server.main(["--smoke", "--device", "cpu", "--port", "0"])
    smoke = served[-1][1]
    assert smoke.compute_dtype == "float32" and smoke.device == torch.device("cpu")
