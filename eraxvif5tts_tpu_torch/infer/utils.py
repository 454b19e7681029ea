"""Inference helpers: duration buckets, cross-fading, RMS normalization.

A copy of `eraxvif5tts_tpu/infer/utils.py` (plain numpy; that package's
`infer/__init__` imports jax). The port keeps the same bucket ladder, so the
two wrappers pick the same shapes for the same request; every bucket is a
multiple of 64, the CUDA attention kernel's tile.
"""

from __future__ import annotations

import numpy as np

# The JAX package's bucket ladder: 64-steps through the common ref 5 s + gen
# 5-15 s range (padding waste <= 6 %), 128-steps to 2048, 256-steps to the
# 4096 cap. The bucket is the padded sequence length of a chunk, so the result
# depends on it (GRN and the text ConvNeXt see the padding): the port keeps
# the same ladder to give the same output as the JAX wrapper.
DURATION_BUCKETS = tuple(range(256, 1601, 64)) + tuple(range(1664, 2049, 128)) + (
    2304, 2560, 2816, 3072, 3328, 3584, 3840, 4096)
TEXT_BUCKETS = (64, 128, 256, 512, 1024, 2048)


def pick_bucket(n: int, buckets=DURATION_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def rms_of(wav: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(wav)))) if len(wav) else 0.0


def cross_fade_concat(waves: list[np.ndarray], sample_rate: int,
                      cross_fade_duration: float = 0.15) -> np.ndarray:
    """Equal-gain linear cross-fade merge (`utils_infer.py:519-556`)."""
    if not waves:
        return np.zeros(0, dtype=np.float32)
    if cross_fade_duration <= 0:
        return np.concatenate(waves)
    final = waves[0]
    for nxt in waves[1:]:
        n = int(cross_fade_duration * sample_rate)
        n = min(n, len(final), len(nxt))
        if n <= 0:
            final = np.concatenate([final, nxt])
            continue
        fade_out = np.linspace(1.0, 0.0, n)
        fade_in = np.linspace(0.0, 1.0, n)
        overlap = final[-n:] * fade_out + nxt[:n] * fade_in
        final = np.concatenate([final[:-n], overlap, nxt[n:]])
    return final


def byte_ratio_duration(
    ref_frames: int, ref_text: str, gen_text: str, speed: float, hop_length: int = 256,
    sample_rate: int = 24000, fix_duration: float | None = None,
) -> int:
    """Duration heuristic (`f5tts_wrapper.py:482-503`): prompt frames + UTF-8 byte
    ratio scaled by speed; or a fixed total duration in seconds."""
    if fix_duration is not None:
        return int(fix_duration * sample_rate / hop_length)
    ref_bytes = len(ref_text.encode("utf-8"))
    if ref_bytes == 0:
        # frames-per-byte is undefined without reference text; proceeding
        # silently yields garbage durations (the wrapper auto-transcribes or
        # errors before this point — direct callers get the same loud error)
        raise ValueError(
            "byte-ratio duration needs non-empty ref_text (pass fix_duration "
            "or a duration predictor, or let preprocess_reference transcribe "
            "the reference clip)")
    gen_bytes = len(gen_text.encode("utf-8"))
    return ref_frames + int(ref_frames / ref_bytes * gen_bytes / speed)
