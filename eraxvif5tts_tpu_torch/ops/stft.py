"""Log-mel frontend and inverse STFT (parity: `eraxvif5tts_tpu/ops/stft.py`).

The JAX package writes the STFT as a strided convolution against a windowed
DFT basis for the TPU's matrix unit; here the forward transform is
``torch.stft`` and the inverse is ``torch.fft.irfft`` per frame followed by an
overlap-add (``F.fold``). Both keep the reference's semantics:

- mel: torchaudio ``MelSpectrogram(power=1, center=True, norm=None,
  mel_scale="htk")`` then ``log(clamp(mel, 1e-5))`` (the "vocos" variant);
- ISTFT: Hann synthesis window, division by the window envelope clamped at
  ``envelope_eps`` (so huge magnitudes stay finite), ``n_fft // 2`` trimmed
  from both ends when ``center``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from eraxvif5tts_tpu_torch.ops.mel import mel_filterbank


def _padded_window(win_length: int, n_fft: int, device) -> torch.Tensor:
    window = torch.hann_window(win_length, periodic=True, dtype=torch.float64)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        window = F.pad(window, (pad, n_fft - win_length - pad))
    return window.to(torch.float32).to(device)


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """``frames [b, n_frames, n_fft]`` -> ``[b, (n_frames - 1) * hop + n_fft]``."""
    b, n_frames, n_fft = frames.shape
    out_len = (n_frames - 1) * hop_length + n_fft
    out = F.fold(frames.transpose(1, 2), output_size=(1, out_len),
                 kernel_size=(1, n_fft), stride=(1, hop_length))
    return out.reshape(b, out_len)


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int = 1024,
          hop_length: int = 256, win_length: int = 1024, center: bool = True,
          envelope_eps: float = 1e-11) -> torch.Tensor:
    """``real/imag [b, n_bins, n_frames]`` float32 -> waveform
    ``[b, (n_frames - 1) * hop]`` (with ``center``)."""
    spec = torch.complex(real.float(), imag.float()).transpose(1, 2)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)  # [b, n_frames, n_fft]
    window = _padded_window(win_length, n_fft, real.device)
    wave = _overlap_add(frames * window, hop_length)
    n_frames = real.shape[-1]
    env = _overlap_add((window * window).expand(1, n_frames, n_fft), hop_length)
    wave = wave / torch.clamp(env, min=envelope_eps)
    if center:
        half = n_fft // 2
        wave = wave[:, half: wave.shape[1] - half]
    return wave


class MelSpectrogram:
    """Raw waveform ``[b, t]`` -> log-mel ``[b, n_mels, n_frames]`` float32
    (the "vocos" variant; the "bigvgan" one waits for the BigVGAN port)."""

    def __init__(self, n_fft: int = 1024, hop_length: int = 256,
                 win_length: int = 1024, n_mel_channels: int = 100,
                 target_sample_rate: int = 24000):
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_mel_channels = n_mel_channels
        self.target_sample_rate = target_sample_rate

    @functools.cached_property
    def _filterbank(self) -> np.ndarray:
        return mel_filterbank(self.target_sample_rate, self.n_fft,
                              self.n_mel_channels, variant="htk")

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        if wav.ndim == 3:
            wav = wav[:, 0, :]
        if wav.ndim != 2:
            raise ValueError(f"expected [b, t] waveform, got {tuple(wav.shape)}")
        window = _padded_window(self.win_length, self.n_fft, wav.device)
        spec = torch.stft(wav.float(), self.n_fft, hop_length=self.hop_length,
                          win_length=self.n_fft, window=window, center=True,
                          pad_mode="reflect", onesided=True, return_complex=True)
        mag = spec.abs()  # [b, n_bins, n_frames]
        fb = torch.from_numpy(self._filterbank).to(wav.device)
        mel = torch.einsum("mf,bfn->bmn", fb, mag)
        return torch.log(torch.clamp(mel, min=1e-5))
