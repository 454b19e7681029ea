"""Polyphase resampling (host-side, scipy)."""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import resample_poly


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Resample ``wav [..., t]`` from ``orig_sr`` to ``target_sr``."""
    if orig_sr == target_sr:
        return np.asarray(wav, dtype=np.float32)
    g = math.gcd(orig_sr, target_sr)
    out = resample_poly(np.asarray(wav, dtype=np.float64), target_sr // g, orig_sr // g, axis=-1)
    return out.astype(np.float32)
