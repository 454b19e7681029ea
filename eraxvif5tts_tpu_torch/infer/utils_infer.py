"""Function-level inference API on the port's wrapper (port of
`eraxvif5tts_tpu/infer/utils_infer.py`, signature parity with the reference
`src/f5_tts/infer/utils_infer.py`).

The porcelain under the CLI, the API and the servers:
``preprocess_ref_audio_text`` (with its md5 transcription cache),
``infer_process``, ``infer_batch_process`` (``streaming=True`` yields chunks),
``load_model`` / ``load_vocoder``, ``remove_silence_for_generated_wav``,
``save_spectrogram`` and the module-level defaults
(`utils_infer.py:49-62`). Device work is the wrapper's; every builder here
puts it on ``cuda`` unless the caller passes ``device="cpu"``.

The JAX package's default transcription backend is a Whisper pipeline whose
weights have to be fetched; the port builds one only from a local model
directory (``initialize_asr_pipeline(path)``) or takes any
``(path) -> str`` callable (``initialize_asr_pipeline(pipe=...)`` or
``transcribe_fn``). Without one, an empty reference text fails loudly.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Generator, Optional

import numpy as np
import torch

from eraxvif5tts_tpu_torch.audio.io import read_wav, write_wav
from eraxvif5tts_tpu_torch.audio.silence import clip_reference_audio, split_on_silence
from eraxvif5tts_tpu_torch.infer.utils import cross_fade_concat
from eraxvif5tts_tpu_torch.text.chunk import chunk_text  # noqa: F401  (re-export parity)

# ----------------------------------------- defaults (`utils_infer.py:49-62`)
target_sample_rate = 24000
n_mel_channels = 100
hop_length = 256
win_length = 1024
n_fft = 1024
mel_spec_type = "vocos"
target_rms = 0.1
cross_fade_duration = 0.15
ode_method = "euler"
nfe_step = 32
cfg_strength = 2.0
sway_sampling_coef = -1.0
speed = 1.0
fix_duration = None
# -----------------------------------------

_ref_audio_cache: dict[str, str] = {}
_asr_pipe = None


def resolve_device(device: Optional[str]) -> torch.device:
    """The device of an entry point: ``None`` is the card (``cuda``);
    ``"cuda"``, ``"cuda:N"`` and ``"cpu"`` are taken as they are; anything
    else (``"tpu"`` among them) raises."""
    name = "cuda" if device is None else str(device)
    if name != "cpu" and name != "cuda" and not (
            name.startswith("cuda:") and name[5:].isdigit()):
        raise ValueError(f"device {device!r} is not supported by the PyTorch/CUDA port "
                         "(use 'cuda', 'cuda:N', 'cpu', or None for 'cuda')")
    return torch.device(name)


def compute_dtype_for(device: torch.device) -> str:
    """The serving dtype of the port's entry points on ``device``: fp32 on
    the card and on the CPU, the JAX wrapper's default, which every JAX
    entry point serves (none of them overrides it). bf16 stays a caller's
    choice: ``F5TTSWrapper(compute_dtype="bfloat16")``."""
    del device  # one dtype on every device, as in the JAX package
    return "float32"


def initialize_asr_pipeline(model_name: str = "openai/whisper-large-v3-turbo", pipe=None):
    """The transcription backend of :func:`transcribe`: ``pipe`` (any
    ``(path) -> str`` callable), else a Whisper pipeline built from the
    local model directory ``model_name`` on the CPU. A hub name would need a
    download, which the port does not make: it raises."""
    global _asr_pipe
    if pipe is not None:
        _asr_pipe = pipe
        return _asr_pipe
    if not os.path.isdir(model_name):
        raise NotImplementedError(
            f"the Whisper ASR backend {model_name!r} would need its weights fetched; "
            "pass a local model directory (initialize_asr_pipeline(path)), a "
            "callable (initialize_asr_pipeline(pipe=fn) or transcribe_fn=), or "
            "ref_text")
    from transformers import pipeline

    whisper = pipeline("automatic-speech-recognition", model=model_name, device="cpu")

    def run(path: str, language: Optional[str] = None) -> str:
        kwargs = {"task": "transcribe"}
        if language:
            kwargs["language"] = language
        return whisper(path, chunk_length_s=30, batch_size=128, generate_kwargs=kwargs,
                       return_timestamps=False)["text"]

    _asr_pipe = run
    return _asr_pipe


def transcribe(ref_audio: str, language: Optional[str] = None) -> str:
    if _asr_pipe is None:
        initialize_asr_pipeline()
    if language:
        return str(_asr_pipe(ref_audio, language)).strip()
    return str(_asr_pipe(ref_audio)).strip()


def transcribe_array_cached(wav: np.ndarray, sr: int, transcribe_fn=None) -> str:
    """md5-cached transcription of an in-memory waveform: the same reference
    clip is transcribed once per process. ``transcribe_fn(path) -> str``
    defaults to :func:`transcribe`. Raises a loud, actionable error when the
    backend fails or returns nothing — callers must never proceed with an
    empty reference text."""
    wav = np.asarray(wav, dtype=np.float32)
    key = hashlib.md5(wav.tobytes() + str(sr).encode()).hexdigest()
    if key in _ref_audio_cache:
        return _ref_audio_cache[key]
    if transcribe_fn is None:
        transcribe_fn = transcribe
    with tempfile.NamedTemporaryFile(delete=False, suffix=".wav") as f:
        write_wav(f.name, wav, sr)
        path = f.name
    try:
        text = transcribe_fn(path).strip()
    except Exception as e:  # noqa: BLE001 — any backend failure is actionable
        raise RuntimeError(
            "reference text was empty and automatic transcription failed "
            f"({type(e).__name__}: {e}) — pass ref_text explicitly, or make "
            "the Whisper ASR backend available (transformers + "
            "openai/whisper-large-v3-turbo weights; zero-egress hosts must "
            "provide a local model via initialize_asr_pipeline)") from e
    if not text:
        raise RuntimeError(
            "automatic transcription of the reference clip returned empty "
            "text — pass ref_text explicitly")
    _ref_audio_cache[key] = text
    return text


def load_vocoder(vocoder_name: str = "vocos", is_local: bool = False, local_path: str = "",
                 device: Optional[str] = None, vocoder_config=None, **_):
    """The decoder (``mel [b, n_mels, t] -> wave``), Vocos or BigVGAN, in eval
    mode on ``device`` (default ``cuda``): the weights of a reference ``.pt``
    (for BigVGAN a `bigvgan_generator.pt`, fresh or weight-normed) when
    ``is_local`` and ``local_path`` are given, else a seeded random
    initialisation (seed 0; BigVGAN the JAX package's draw,
    `utils_infer.py:105-129`). ``vocoder_config`` is BigVGAN's
    ``BigVGANConfig`` (default `bigvgan_v2_24khz_100band_256x`). Unlike the
    JAX function it returns the module alone: its parameters are inside it."""
    if vocoder_name == "bigvgan":
        from eraxvif5tts_tpu_torch.compression.convert import load_bigvgan
        from eraxvif5tts_tpu_torch.models.bigvgan import (
            BigVGAN,
            BigVGANConfig,
            random_state_dict,
        )

        dev = resolve_device(device)
        config = vocoder_config or BigVGANConfig()
        if is_local and local_path:
            return load_bigvgan(local_path, config).to(dev)
        vocoder = BigVGAN(config)
        vocoder.load_state_dict({k: torch.from_numpy(v) for k, v in random_state_dict(
            config, np.random.default_rng(0)).items()}, strict=True)
        return vocoder.to(dev).eval()
    if vocoder_name != "vocos":
        raise ValueError(f"unknown vocoder {vocoder_name!r} (vocos | bigvgan)")
    from eraxvif5tts_tpu_torch.compression.convert import reference_vocos_state_dict
    from eraxvif5tts_tpu_torch.models.vocos import Vocos

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        vocoder = Vocos()
    if is_local and local_path:
        vocoder.load_state_dict(reference_vocos_state_dict(local_path), strict=True)
    return vocoder.to(resolve_device(device)).eval()


def load_model(model_cls_name, model_cfg: dict, ckpt_path: str, vocab_file: str = "",
               use_ema: bool = True, device: Optional[str] = None, **_):
    """A wrapper from an arch dict and a checkpoint (reference
    `utils_infer.py:232-270`), on ``device`` (default ``cuda``)."""
    from eraxvif5tts_tpu_torch.configs import model_config_from_dict
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper

    backbone = model_cls_name if isinstance(model_cls_name, str) else "DiT"
    cfg = model_config_from_dict({"backbone": backbone, "arch": dict(model_cfg)})
    dev = resolve_device(device)
    return F5TTSWrapper(model_cfg=cfg, ckpt_path=ckpt_path, vocab_file=vocab_file or None,
                        use_ema=use_ema, device=dev, compute_dtype=compute_dtype_for(dev))


def preprocess_ref_audio_text(ref_audio_orig: str, ref_text: str, clip_short: bool = True,
                              show_info=print) -> tuple[str, str]:
    """Clip/trim the reference prompt to <=12 s, transcribe if no text given, fix
    trailing punctuation. Returns (processed wav path, ref text).
    Parity: `utils_infer.py:292-360`."""
    wav, sr = read_wav(ref_audio_orig)
    wav = wav.mean(axis=0)
    wav = clip_reference_audio(wav, sr, clip_short=clip_short)

    with tempfile.NamedTemporaryFile(delete=False, suffix=".wav") as f:
        write_wav(f.name, wav, sr)
        ref_audio = f.name

    if not ref_text.strip():
        with open(ref_audio, "rb") as audio_file:
            audio_hash = hashlib.md5(audio_file.read()).hexdigest()
        if audio_hash in _ref_audio_cache:
            show_info("Using cached reference text...")
            ref_text = _ref_audio_cache[audio_hash]
        else:
            show_info("No reference text provided, transcribing reference audio...")
            ref_text = transcribe(ref_audio)
            _ref_audio_cache[audio_hash] = ref_text
    else:
        show_info("Using custom reference text...")

    if not ref_text.endswith(". ") and not ref_text.endswith("。"):
        ref_text = ref_text + " " if ref_text.endswith(".") else ref_text + ". "
    return ref_audio, ref_text


def infer_process(
    ref_audio: str,
    ref_text: str,
    gen_text: str,
    model_obj,
    vocoder=None,
    show_info=print,
    progress=None,
    target_rms: float = target_rms,
    cross_fade_duration: float = cross_fade_duration,
    nfe_step: int = nfe_step,
    cfg_strength: float = cfg_strength,
    sway_sampling_coef: float = sway_sampling_coef,
    speed: float = speed,
    fix_duration=None,
    seed: Optional[int] = None,
    **_,
):
    """Chunk + synthesize + cross-fade. Returns (wave, sample_rate, spectrogram).
    Parity: `utils_infer.py:366-411` (the ``max_chars`` rule lives in the wrapper).
    """
    wav, sr = read_wav(ref_audio)
    ref_state = model_obj.preprocess_reference(
        ref_audio=wav.mean(axis=0), ref_sample_rate=sr, ref_text=ref_text,
        clip_short=False,
    )
    wave, spec = model_obj.generate(
        gen_text, ref=ref_state, nfe_step=nfe_step, cfg_strength=cfg_strength,
        speed=speed, sway_sampling_coef=sway_sampling_coef, fix_duration=fix_duration,
        cross_fade_duration=cross_fade_duration, seed=seed,
        return_numpy=True, return_spectrogram=True,
    )
    return wave, model_obj.target_sample_rate, spec


def infer_batch_process(
    ref_audio: tuple[np.ndarray, int],
    ref_text: str,
    gen_text_batches: list[str],
    model_obj,
    vocoder=None,
    progress=None,
    target_rms: float = target_rms,
    cross_fade_duration: float = cross_fade_duration,
    nfe_step: int = nfe_step,
    cfg_strength: float = cfg_strength,
    sway_sampling_coef: float = sway_sampling_coef,
    speed: float = speed,
    fix_duration=None,
    streaming: bool = False,
    chunk_size: int = 2048,
    seed: Optional[int] = None,
    **_,
) -> Generator:
    """Per-chunk synthesis; ``streaming=True`` yields ``(wave_piece, sr)`` tuples of
    ``chunk_size`` samples, else yields one ``(wave, sr, spectrogram)``.
    Parity: `utils_infer.py:417-563`."""
    audio, sr = ref_audio
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 2:
        audio = audio.mean(axis=0)
    ref_state = model_obj.preprocess_reference(
        ref_audio=audio, ref_sample_rate=sr, ref_text=ref_text, clip_short=False
    )
    sr_out = model_obj.target_sample_rate

    if streaming:
        for gen_text in gen_text_batches:
            local_speed = 0.3 if len(gen_text.encode("utf-8")) < 10 else speed
            wave = model_obj.generate(
                gen_text, ref=ref_state, nfe_step=nfe_step, cfg_strength=cfg_strength,
                speed=local_speed, sway_sampling_coef=sway_sampling_coef,
                fix_duration=fix_duration, seed=seed, return_numpy=True,
            )
            for j in range(0, len(wave), chunk_size):
                yield wave[j: j + chunk_size], sr_out
    else:
        waves, specs = [], []
        for gen_text in gen_text_batches:
            local_speed = 0.3 if len(gen_text.encode("utf-8")) < 10 else speed
            wave, spec = model_obj.generate(
                gen_text, ref=ref_state, nfe_step=nfe_step, cfg_strength=cfg_strength,
                speed=local_speed, sway_sampling_coef=sway_sampling_coef,
                fix_duration=fix_duration, seed=seed,
                return_numpy=True, return_spectrogram=True,
            )
            waves.append(wave)
            specs.append(spec)
        if waves:
            final = cross_fade_concat(waves, sr_out, cross_fade_duration)
            yield final, sr_out, np.concatenate(specs, axis=1) if specs else None
        else:
            yield None, sr_out, None


def remove_silence_for_generated_wav(filename: str) -> None:
    """Strip long silences from a generated wav in place (`utils_infer.py:569-578`)."""
    wav, sr = read_wav(filename)
    wav = wav.mean(axis=0)
    chunks = split_on_silence(wav, sr, min_silence_len=1000, silence_thresh=-50.0,
                              keep_silence=500, seek_step=10)
    merged = np.concatenate(chunks) if chunks else wav
    write_wav(filename, merged, sr)


def save_spectrogram(spectrogram: np.ndarray, path: str) -> None:
    """PNG spectrogram dump (`utils_infer.py:584-589`); matplotlib optional."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(12, 4))
        plt.imshow(spectrogram, origin="lower", aspect="auto")
        plt.colorbar()
        plt.savefig(path)
        plt.close()
    except ImportError:
        np.save(path + ".npy", spectrogram)
