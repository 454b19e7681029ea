"""Griffin-Lim mel inversion: audio from a mel spectrogram with no trained
vocoder (the port's own copy of `eraxvif5tts_tpu/audio/griffin_lim.py`;
numpy only).

Inverts the model's log-mel output directly (mel filterbank pseudo-inverse,
then iterative phase recovery), so training smoke samples produce audible
(robotic but intelligible) speech without vocoder weights. Host-side:
diagnostic, not the serving path.

Inverse of the `vocos` mel variant (24 kHz, n_fft 1024, hop 256,
center=True, power=1, log-clamped at 1e-5 — reference `modules.py:75-101`).
"""

from __future__ import annotations

import numpy as np

from eraxvif5tts_tpu_torch.ops.mel import hann_window, mel_filterbank


def _stft_np(wav: np.ndarray, n_fft: int, hop: int, win: np.ndarray) -> np.ndarray:
    pad = n_fft // 2
    wav = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(wav) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wav[idx] * win[None, :]
    return np.fft.rfft(frames, axis=-1).T  # [n_fft//2+1, n_frames]


def _istft_np(spec: np.ndarray, n_fft: int, hop: int, win: np.ndarray) -> np.ndarray:
    frames = np.fft.irfft(spec.T, n=n_fft, axis=-1) * win[None, :]
    n_frames = frames.shape[0]
    out = np.zeros(n_fft + hop * (n_frames - 1), np.float64)
    norm = np.zeros_like(out)
    w2 = win.astype(np.float64) ** 2
    for i in range(n_frames):
        out[i * hop : i * hop + n_fft] += frames[i]
        norm[i * hop : i * hop + n_fft] += w2
    out = out / np.maximum(norm, 1e-8)
    pad = n_fft // 2
    return out[pad:-pad].astype(np.float32)


def griffin_lim_mel(
    log_mel: np.ndarray,
    n_iter: int = 48,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    sample_rate: int = 24000,
    variant: str = "htk",
    seed: int = 0,
) -> np.ndarray:
    """``log_mel [n_mels, n_frames]`` (natural-log, power=1) -> waveform [n]."""
    n_mels, n_frames = log_mel.shape
    fb = mel_filterbank(sample_rate, n_fft, n_mels, variant=variant)  # [n_mels, bins]
    mag_mel = np.exp(log_mel.astype(np.float64))
    # approximate inverse through the transpose, normalised by the
    # filterbank's column sums (the librosa-style pseudo-inverse)
    denom = np.maximum(fb.sum(axis=0, keepdims=True), 1e-8)  # [1, bins]
    lin = (fb / denom).T @ mag_mel  # [bins, n_frames]
    lin = np.maximum(lin, 1e-10)

    rng = np.random.default_rng(seed)
    win = hann_window(win_length).astype(np.float64)
    if win_length < n_fft:
        win = np.pad(win, ((n_fft - win_length) // 2,) * 2)
    phase = np.exp(2j * np.pi * rng.random(lin.shape))
    spec = lin * phase
    for _ in range(n_iter):
        wav = _istft_np(spec, n_fft, hop_length, win)
        re = _stft_np(wav, n_fft, hop_length, win)
        re = re[:, :n_frames]
        if re.shape[1] < n_frames:
            re = np.pad(re, ((0, 0), (0, n_frames - re.shape[1])))
        phase = re / np.maximum(np.abs(re), 1e-10)
        spec = lin * phase
    wav = _istft_np(spec, n_fft, hop_length, win)
    peak = np.abs(wav).max()
    if peak > 1.0:
        wav = wav / peak
    return wav.astype(np.float32)
