"""BigVGAN generator: the alternative vocoder (port of
`eraxvif5tts_tpu/models/bigvgan.py`).

Architecture (BigVGAN, arXiv:2206.04658, v2 configuration):

    conv_pre(k7) -> [ConvTranspose(up_i) -> mean of AMPBlocks(k in {3,7,11})] x 6
    -> anti-aliased snake activation -> conv_post(k7) -> clamp/tanh

- **Snake / SnakeBeta**: ``x + (1/beta) sin^2(alpha x)`` with per-channel
  (log-scale) alpha / beta;
- **anti-aliased activation** (``Activation1d``): 2x upsampling through a
  kaiser-windowed sinc low-pass, the nonlinearity, 2x filtered downsampling;
- **AMPBlock1**: pairs of (activation -> dilated conv, activation -> conv)
  with residuals, dilations (1, 3, 5).

Tensors are ``[b, c, t]``, PyTorch's convolution layout (the JAX package
works in ``[b, t, c]``). The module's state dict is the reference checkpoint's
key layout with weight norm fused (``conv_pre.weight``, ``ups.{i}.0.weight``
in ConvTranspose1d's ``[in, out, k]``, ``resblocks.{j}.convs1.{m}.weight``,
``resblocks.{j}.activations.{m}.act.alpha``, ``activation_post.act.beta``,
...); the reference's per-activation filter buffers are not part of it (the
filter is one constant, kept as a non-persistent buffer).
`compression/convert.py` ``bigvgan_state_dict_from_reference`` reads a
reference checkpoint (fresh or weight-normed) into it, and
``bigvgan_state_dict_from_jax`` the JAX package's parameter tree.

BigVGAN computes in fp32 on every device, as in the JAX wrapper, whatever
the backbone's serving dtype: its parameters stay fp32 and its input is cast
to fp32. Its convolutions run with TF32 off (``models.modules.fp32_convolutions``,
which keeps the process-wide cuDNN flag safe under concurrent callers).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eraxvif5tts_tpu_torch.models.modules import fp32_convolutions


@dataclass(frozen=True)
class BigVGANConfig:
    """Defaults = `bigvgan_v2_24khz_100band_256x` (hop 256, 24 kHz, 100 mels)."""

    num_mels: int = 100
    upsample_initial_channel: int = 1536
    upsample_rates: tuple = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: tuple = (8, 8, 4, 4, 4, 4)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"  # "snake" | "snakebeta"
    snake_logscale: bool = True
    use_tanh_at_final: bool = False  # v2: clamp(-1, 1); v1 base: tanh
    use_bias_at_final: bool = False
    sample_rate: int = 24000


BIGVGAN_BASE_24KHZ = BigVGANConfig(
    upsample_initial_channel=512, activation="snake",
    use_tanh_at_final=True, use_bias_at_final=True,
)


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """The kaiser-windowed sinc low-pass of the alias-free activation."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt = filt / filt.sum()
    return filt.astype(np.float32)


def _depthwise(filt: torch.Tensor, channels: int) -> torch.Tensor:
    return filt[None, None].expand(channels, 1, -1)


def upsample2x(x: torch.Tensor, filt: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    """Alias-free 2x upsampling of ``x [b, c, t]`` (UpSample1d): replicate pad,
    a depthwise transposed convolution with the filter, the edges cut."""
    k = filt.shape[0]
    pad = k // ratio - 1
    pad_left = pad * ratio + (k - ratio) // 2
    pad_right = pad * ratio + (k - ratio + 1) // 2
    x = F.pad(x, (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(x, _depthwise(filt, x.shape[1]), stride=ratio,
                                   groups=x.shape[1])
    return y[..., pad_left:y.shape[-1] - pad_right]


def lowpass_downsample2x(x: torch.Tensor, filt: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    """DownSample1d / LowPassFilter1d: replicate pad, then a strided depthwise
    convolution with the filter."""
    k = filt.shape[0]
    x = F.pad(x, (k // 2 - int(k % 2 == 0), k // 2), mode="replicate")
    return F.conv1d(x, _depthwise(filt, x.shape[1]), stride=ratio, groups=x.shape[1])


def snake(x: torch.Tensor, alpha: torch.Tensor, logscale: bool) -> torch.Tensor:
    a = (alpha.exp() if logscale else alpha)[None, :, None]
    return x + (1.0 / (a + 1e-9)) * torch.sin(a * x).square()


def snakebeta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
              logscale: bool) -> torch.Tensor:
    a = (alpha.exp() if logscale else alpha)[None, :, None]
    b = (beta.exp() if logscale else beta)[None, :, None]
    return x + (1.0 / (b + 1e-9)) * torch.sin(a * x).square()


class Snake(nn.Module):
    """The per-channel parameters of Snake (``alpha``) or SnakeBeta (``alpha``,
    ``beta``), zero-initialised (log scale: 1)."""

    def __init__(self, channels: int, with_beta: bool):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels)) if with_beta else None


class Activation1d(nn.Module):
    """Anti-aliased activation: 2x up -> snake(beta) -> 2x down (``act`` holds
    the parameters, under the reference's key)."""

    def __init__(self, channels: int, config: BigVGANConfig):
        super().__init__()
        self.config = config
        self.act = Snake(channels, config.activation == "snakebeta")

    def forward(self, x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
        x = upsample2x(x, filt)
        if self.act.beta is not None:
            x = snakebeta(x, self.act.alpha, self.act.beta, self.config.snake_logscale)
        else:
            x = snake(x, self.act.alpha, self.config.snake_logscale)
        return lowpass_downsample2x(x, filt)


class AMPBlock(nn.Module):
    """AMPBlock1: per dilation d, activation -> conv(k, d) -> activation ->
    conv(k) with a residual."""

    def __init__(self, channels: int, kernel_size: int, dilations: tuple,
                 config: BigVGANConfig):
        super().__init__()
        self.convs1 = nn.ModuleList(
            [nn.Conv1d(channels, channels, kernel_size, dilation=d,
                       padding=d * (kernel_size - 1) // 2) for d in dilations])
        self.convs2 = nn.ModuleList(
            [nn.Conv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2)
             for _ in dilations])
        self.activations = nn.ModuleList(
            [Activation1d(channels, config) for _ in range(2 * len(dilations))])

    def forward(self, x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
        for m, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            xt = c1(self.activations[2 * m](x, filt))
            xt = c2(self.activations[2 * m + 1](xt, filt))
            x = x + xt
        return x


class BigVGAN(nn.Module):
    """``mel [b, num_mels, t]`` -> wave ``[b, t * prod(upsample_rates)]``
    float32 (`bigvgan.py:176-223`)."""

    def __init__(self, config: BigVGANConfig | None = None):
        super().__init__()
        cfg = self.config = config or BigVGANConfig()
        ch = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            cin, cout = ch // (2 ** i), ch // (2 ** (i + 1))
            self.ups.append(nn.ModuleList(
                [nn.ConvTranspose1d(cin, cout, k, stride=u, padding=(k - u) // 2)]))
            for kr, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(AMPBlock(cout, kr, dil, cfg))
        final = ch // (2 ** len(cfg.upsample_rates))
        self.activation_post = Activation1d(final, cfg)
        self.conv_post = nn.Conv1d(final, 1, 7, padding=3, bias=cfg.use_bias_at_final)
        self.register_buffer("filter", torch.from_numpy(kaiser_sinc_filter1d(0.25, 0.3, 12)),
                             persistent=False)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        n_k = len(cfg.resblock_kernel_sizes)
        filt = self.filter
        with fp32_convolutions():
            x = self.conv_pre(mel.float())
            for i, up in enumerate(self.ups):
                x = up[0](x)
                acc = None
                for j in range(n_k):
                    y = self.resblocks[i * n_k + j](x, filt)
                    acc = y if acc is None else acc + y
                x = acc / n_k
            x = self.conv_post(self.activation_post(x, filt))
        wave = x[:, 0]
        if cfg.use_tanh_at_final:
            return torch.tanh(wave)
        return torch.clamp(wave, -1.0, 1.0)


def random_state_dict(config: BigVGANConfig, rng: np.random.Generator) -> dict[str, np.ndarray]:
    """A reference-layout state dict of random weights, the same draw as the
    JAX package's ``BigVGAN.init_random_params`` (convolutions N(0, 0.02),
    biases and snake parameters 0), as numpy arrays."""
    cfg = config
    sd: dict[str, np.ndarray] = {}

    def conv(prefix, cin, cout, k, bias=True):
        sd[f"{prefix}.weight"] = rng.standard_normal((cout, cin, k)).astype(np.float32) * 0.02
        if bias:
            sd[f"{prefix}.bias"] = np.zeros(cout, np.float32)

    def act(prefix, c):
        sd[f"{prefix}.act.alpha"] = np.zeros(c, np.float32)
        if cfg.activation == "snakebeta":
            sd[f"{prefix}.act.beta"] = np.zeros(c, np.float32)

    ch = cfg.upsample_initial_channel
    conv("conv_pre", cfg.num_mels, ch, 7)
    n_k = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        cout, cin = ch // (2 ** (i + 1)), ch // (2 ** i)
        sd[f"ups.{i}.0.weight"] = rng.standard_normal((cin, cout, k)).astype(np.float32) * 0.02
        sd[f"ups.{i}.0.bias"] = np.zeros(cout, np.float32)
        for j, kr in enumerate(cfg.resblock_kernel_sizes):
            base = f"resblocks.{i * n_k + j}"
            dil = cfg.resblock_dilation_sizes[j]
            for m in range(len(dil)):
                conv(f"{base}.convs1.{m}", cout, cout, kr)
                conv(f"{base}.convs2.{m}", cout, cout, kr)
            for m in range(2 * len(dil)):
                act(f"{base}.activations.{m}", cout)
    final_c = ch // (2 ** len(cfg.upsample_rates))
    act("activation_post", final_c)
    conv("conv_post", final_c, 1, 7, bias=cfg.use_bias_at_final)
    return sd
