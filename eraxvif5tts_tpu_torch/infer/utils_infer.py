"""Cached transcription of a reference clip whose text was not given.

The port's copy of ``transcribe_array_cached`` of
`eraxvif5tts_tpu/infer/utils_infer.py`, that function alone: the md5-keyed
cache, the temporary wav handed to the backend, and the two loud errors. The
JAX package's default backend (a Whisper pipeline, whose weights have to be
fetched) is not ported: the caller passes ``transcribe_fn(path) -> str``, and
without one the call fails with the JAX package's message.
"""

from __future__ import annotations

import hashlib
import tempfile

import numpy as np

from eraxvif5tts_tpu_torch.audio.io import write_wav

_ref_audio_cache: dict[str, str] = {}


def _no_backend(path: str) -> str:
    raise NotImplementedError("no transcribe_fn was given and the default Whisper backend "
                              "is not ported")


def transcribe_array_cached(wav: np.ndarray, sr: int, transcribe_fn=None) -> str:
    """md5-cached transcription of an in-memory waveform: the same reference
    clip is transcribed once per process. Raises a loud, actionable error
    when the backend fails or returns nothing — callers must never proceed
    with an empty reference text."""
    wav = np.asarray(wav, dtype=np.float32)
    key = hashlib.md5(wav.tobytes() + str(sr).encode()).hexdigest()
    if key in _ref_audio_cache:
        return _ref_audio_cache[key]
    if transcribe_fn is None:
        transcribe_fn = _no_backend
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
