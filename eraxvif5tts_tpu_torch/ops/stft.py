"""Log-mel frontend and inverse STFT (parity: `eraxvif5tts_tpu/ops/stft.py`).

The JAX package writes the STFT as a strided convolution against a windowed
DFT basis for the TPU's matrix unit; here the forward transform is
``torch.stft`` and the inverse is ``torch.fft.irfft`` per frame followed by an
overlap-add (``F.fold``). Both keep the reference's semantics:

- mel, the "vocos" variant: torchaudio ``MelSpectrogram(power=1,
  center=True, norm=None, mel_scale="htk")`` then ``log(clamp(mel, 1e-5))``;
- mel, the "bigvgan" variant: a reflect pad of ``(n_fft - hop) // 2`` on
  both sides and ``center=False``, magnitude ``sqrt(re^2 + im^2 + 1e-9)``,
  the Slaney filterbank, then the same log;
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


def padded_window(win_length: int, n_fft: int, device) -> torch.Tensor:
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
          envelope_eps: float = 1e-11, window: torch.Tensor | None = None) -> torch.Tensor:
    """``real/imag [b, n_bins, n_frames]`` float32 -> waveform
    ``[b, (n_frames - 1) * hop]`` (with ``center``). ``window``: the padded
    Hann window ``[n_fft]`` on real's device, made here when not given (a
    host-to-device copy, which a CUDA graph cannot capture)."""
    spec = torch.complex(real.float(), imag.float()).transpose(1, 2)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)  # [b, n_frames, n_fft]
    if window is None:
        window = padded_window(win_length, n_fft, real.device)
    wave = _overlap_add(frames * window, hop_length)
    n_frames = real.shape[-1]
    env = _overlap_add((window * window).expand(1, n_frames, n_fft), hop_length)
    wave = wave / torch.clamp(env, min=envelope_eps)
    if center:
        half = n_fft // 2
        wave = wave[:, half: wave.shape[1] - half]
    return wave


class MelSpectrogram:
    """Raw waveform ``[b, t]`` -> log-mel ``[b, n_mels, n_frames]`` float32,
    ``mel_spec_type`` "vocos" (``t // hop + 1`` frames) or "bigvgan"
    (``t // hop`` frames for ``t`` a multiple of ``hop``)."""

    def __init__(self, n_fft: int = 1024, hop_length: int = 256,
                 win_length: int = 1024, n_mel_channels: int = 100,
                 target_sample_rate: int = 24000, mel_spec_type: str = "vocos"):
        if mel_spec_type not in ("vocos", "bigvgan"):
            raise ValueError(f"unknown mel_spec_type: {mel_spec_type!r}")
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_mel_channels = n_mel_channels
        self.target_sample_rate = target_sample_rate
        self.mel_spec_type = mel_spec_type

    @functools.cached_property
    def _filterbank(self) -> np.ndarray:
        variant = "htk" if self.mel_spec_type == "vocos" else "slaney"
        return mel_filterbank(self.target_sample_rate, self.n_fft,
                              self.n_mel_channels, variant=variant)

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        if wav.ndim == 3:
            wav = wav[:, 0, :]
        if wav.ndim != 2:
            raise ValueError(f"expected [b, t] waveform, got {tuple(wav.shape)}")
        window = padded_window(self.win_length, self.n_fft, wav.device)
        wav = wav.float()
        center = self.mel_spec_type == "vocos"
        if not center:
            pad = (self.n_fft - self.hop_length) // 2
            wav = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
        spec = torch.stft(wav, self.n_fft, hop_length=self.hop_length,
                          win_length=self.n_fft, window=window, center=center,
                          pad_mode="reflect", onesided=True, return_complex=True)
        if center:
            mag = spec.abs()  # [b, n_bins, n_frames]
        else:
            mag = torch.sqrt(spec.real.square() + spec.imag.square() + 1e-9)
        fb = torch.from_numpy(self._filterbank).to(wav.device)
        mel = torch.einsum("mf,bfn->bmn", fb, mag)
        return torch.log(torch.clamp(mel, min=1e-5))
