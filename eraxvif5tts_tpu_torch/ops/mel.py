"""Mel filterbank construction (numpy, precomputed once; applied on-device as a matmul).

Reimplements from the published formulas the two filterbank flavors the reference
depends on through torchaudio / librosa (reference `src/f5_tts/model/modules.py:30-101`):

- ``variant="htk"``: torchaudio ``MelSpectrogram`` defaults — HTK mel scale
  (2595*log10(1+f/700)), no area normalization (``norm=None``). This is the "vocos"
  mel path.
- ``variant="slaney"``: librosa ``filters.mel`` defaults — Slaney mel scale (linear
  below 1 kHz, log above) with Slaney area normalization. This is the "bigvgan" path.

Both produce an ``[n_mels, n_fft//2 + 1]`` triangular filterbank.

A copy of `eraxvif5tts_tpu/ops/mel.py` (plain numpy; that package's
`ops/__init__` imports jax).
"""

from __future__ import annotations

import numpy as np


def _hz_to_mel_htk(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


# Slaney scale constants: 66.7 Hz/mel below the 1 kHz break, log-spaced above with
# 27 steps per factor 6.4.
_SLANEY_F_SP = 200.0 / 3.0
_SLANEY_MIN_LOG_HZ = 1000.0
_SLANEY_MIN_LOG_MEL = _SLANEY_MIN_LOG_HZ / _SLANEY_F_SP
_SLANEY_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel_slaney(f) -> np.ndarray:
    f = np.atleast_1d(np.asarray(f, dtype=np.float64))
    mel = f / _SLANEY_F_SP
    log_region = f >= _SLANEY_MIN_LOG_HZ
    mel[log_region] = (
        _SLANEY_MIN_LOG_MEL + np.log(f[log_region] / _SLANEY_MIN_LOG_HZ) / _SLANEY_LOGSTEP
    )
    return mel


def _mel_to_hz_slaney(m) -> np.ndarray:
    m = np.atleast_1d(np.asarray(m, dtype=np.float64))
    f = m * _SLANEY_F_SP
    log_region = m >= _SLANEY_MIN_LOG_MEL
    f[log_region] = _SLANEY_MIN_LOG_HZ * np.exp(_SLANEY_LOGSTEP * (m[log_region] - _SLANEY_MIN_LOG_MEL))
    return f


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    variant: str = "htk",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape ``[n_mels, n_fft // 2 + 1]``."""
    if fmax is None:
        fmax = sample_rate / 2.0

    if variant == "htk":
        hz_to_mel, mel_to_hz = _hz_to_mel_htk, _mel_to_hz_htk
        normalize = False
    elif variant == "slaney":
        hz_to_mel, mel_to_hz = _hz_to_mel_slaney, _mel_to_hz_slaney
        normalize = True
    else:
        raise ValueError(f"unknown mel variant: {variant!r}")

    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(hz_to_mel(np.array(fmin)), hz_to_mel(np.array(fmax)), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts).reshape(-1)

    # Triangles: rising edge from hz_pts[i] to hz_pts[i+1], falling to hz_pts[i+2].
    lower = (fft_freqs[None, :] - hz_pts[:-2, None]) / (hz_pts[1:-1] - hz_pts[:-2])[:, None]
    upper = (hz_pts[2:, None] - fft_freqs[None, :]) / (hz_pts[2:] - hz_pts[1:-1])[:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))

    if normalize:  # Slaney area normalization: 2 / bandwidth
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[:, None]

    return fb.astype(dtype)
