"""Vocos vocoder, mel -> waveform (port of `eraxvif5tts_tpu/models/vocos.py`).

Public Vocos mel-24khz architecture: embed Conv1d(100 -> 512, k7), LayerNorm,
8 ConvNeXt blocks with layer scale, final LayerNorm, Linear(512 -> n_fft + 2)
giving log-magnitude and phase, then a centred ISTFT. Parameter names follow
the Vocos checkpoint (`compression/convert.py` ``vocos_rules``).

Parameters stay fp32; ``compute_dtype`` (the wrapper's: fp32 by default,
bf16 when asked) applies to the ConvNeXt stack, layernorm statistics are
fp32, and the ISTFT head runs fp32 (phase -> cos/sin is
precision-sensitive). In fp32 a call runs with TF32 off
(``models.modules.full_fp32``). The magnitude is clipped at 1e2
(`vocos.py:103-105`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eraxvif5tts_tpu_torch.models.modules import conv1d, full_fp32, layer_norm, linear
from eraxvif5tts_tpu_torch.ops.stft import istft, padded_window


class VocosConvNeXtBlock(nn.Module):
    """ConvNeXt-v1 block with layer scale (`vocos.py:29-60`)."""

    def __init__(self, dim: int, intermediate_dim: int, layer_scale_init: float):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        x = conv1d(x.transpose(1, 2), self.dwconv).transpose(1, 2)
        x = layer_norm(x, self.norm)
        x = linear(F.gelu(linear(x, self.pwconv1)), self.pwconv2)
        return residual + (self.gamma.to(x.dtype) * x).to(residual.dtype)


class VocosBackbone(nn.Module):
    def __init__(self, input_channels: int, dim: int, intermediate_dim: int,
                 num_layers: int):
        super().__init__()
        self.embed = nn.Conv1d(input_channels, dim, 7, padding=3)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.convnext = nn.ModuleList(
            [VocosConvNeXtBlock(dim, intermediate_dim, 1.0 / num_layers)
             for _ in range(num_layers)])
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, mel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = conv1d(mel.to(dtype), self.embed).transpose(1, 2)  # [b, n, dim]
        x = layer_norm(x, self.norm)
        for block in self.convnext:
            x = block(x)
        return layer_norm(x, self.final_layer_norm)


class ISTFTHead(nn.Module):
    def __init__(self, dim: int, n_fft: int, hop_length: int):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length
        self.out = nn.Linear(dim, n_fft + 2)
        # on the module's device, so that a call copies nothing from the host
        self.register_buffer("window", padded_window(n_fft, n_fft, "cpu"), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = linear(x, self.out).transpose(1, 2).float()  # [b, n_fft + 2, n]
        n_bins = self.n_fft // 2 + 1
        log_mag, phase = x[:, :n_bins], x[:, n_bins:]
        mag = torch.clamp(torch.exp(log_mag), max=1e2)
        return istft(mag * torch.cos(phase), mag * torch.sin(phase), self.n_fft,
                     self.hop_length, self.n_fft, center=True, window=self.window)


class Vocos(nn.Module):
    """Mel ``[b, n_mels, n]`` -> waveform ``[b, (n - 1) * hop]`` float32."""

    def __init__(self, input_channels: int = 100, dim: int = 512,
                 intermediate_dim: int = 1536, num_layers: int = 8, n_fft: int = 1024,
                 hop_length: int = 256, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.backbone = VocosBackbone(input_channels, dim, intermediate_dim, num_layers)
        self.head = ISTFTHead(dim, n_fft, hop_length)

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype

    @full_fp32
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(mel, self.compute_dtype))
