"""Streaming-WAV helpers (reference `f5tts-fastapi-server.py:173-204`): the
port's copy of `eraxvif5tts_tpu/serving/wave_stream.py`."""

from __future__ import annotations

import struct

import numpy as np


def create_wave_header(sample_rate: int = 24000, bits_per_sample: int = 16,
                       channels: int = 1) -> bytes:
    """WAV header with unknown (max) data length, for chunked streaming."""
    byte_rate = sample_rate * channels * bits_per_sample // 8
    block_align = channels * bits_per_sample // 8
    # 0xFFFFFFFF sizes: players treat the stream as unbounded
    return b"".join([
        b"RIFF",
        struct.pack("<I", 0xFFFFFFFF),
        b"WAVE",
        b"fmt ",
        struct.pack("<IHHIIHH", 16, 1, channels, sample_rate, byte_rate,
                    block_align, bits_per_sample),
        b"data",
        struct.pack("<I", 0xFFFFFFFF),
    ])


def float_to_int16_bytes(wave: np.ndarray) -> bytes:
    pcm = np.clip(np.asarray(wave, dtype=np.float32), -1.0, 1.0)
    return (pcm * 32767.0).astype("<i2").tobytes()
