"""WAV file IO on the stdlib ``wave`` module (PCM 16/24/32-bit + IEEE float32).

Waveforms are float32 numpy arrays in [-1, 1]; multi-channel files are returned as
``[channels, t]`` to mirror torchaudio's layout (reference loads with
``torchaudio.load``, `utils_infer.py:385`).
"""

from __future__ import annotations

import struct
import wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (waveform [channels, t] float32 in [-1, 1], sample_rate)."""
    try:
        with wave.open(path, "rb") as f:
            sr = f.getframerate()
            n_ch = f.getnchannels()
            width = f.getsampwidth()
            raw = f.readframes(f.getnframes())
        if width == 2:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif width == 4:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif width == 3:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            ints = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            data = ints.astype(np.float32) / float(1 << 23)
        elif width == 1:
            data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported sample width: {width}")
    except wave.Error:
        # stdlib wave rejects WAVE_FORMAT_IEEE_FLOAT; parse minimally ourselves.
        data, sr, n_ch = _read_float_wav(path)
    return data.reshape(-1, n_ch).T.copy(), sr


def _read_float_wav(path: str) -> tuple[np.ndarray, int, int]:
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError(f"{path!r} is not a WAV file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(blob):
        chunk_id = blob[pos : pos + 4]
        size = struct.unpack("<I", blob[pos + 4 : pos + 8])[0]
        body = blob[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path!r}: missing fmt/data chunk")
    audio_format, n_ch, sr, _, _, bits = fmt
    if audio_format == 3 and bits == 32:  # IEEE float
        arr = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif audio_format == 3 and bits == 64:
        arr = np.frombuffer(data, dtype="<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format {audio_format}/{bits}bit")
    return arr, sr, n_ch


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Write mono/multi-channel float waveform as 16-bit PCM."""
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[None, :]
    pcm = np.clip(wav, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(wav.shape[0])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.T.tobytes())
