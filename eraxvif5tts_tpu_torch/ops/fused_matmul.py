"""AdaLN-modulated projection: the DiT block's feed-forward input projection.

Port of `ln_mod_matmul` from `eraxvif5tts_tpu/ops/fused_matmul.py` (Pallas body
`_ln_mod_kernel`; the module's other kernel, `matmul_gate_res`, is on no model
path and waits in ROADMAP.md). :func:`ln_mod_matmul` launches the CUDA kernel
`csrc/ln_mod_matmul.cu` for CUDA tensors and runs
:func:`ln_mod_matmul_reference`, the plain PyTorch version, for CPU tensors.

Semantics, per batch row: ``act((LN(x) * (1 + scale) + shift) @ weight.T + bias)``
with a scale-free layernorm over K (fp32 statistics, eps 1e-6), the modulated
activation cast to x's dtype before the product, fp32 accumulation, and the
tanh-GELU in fp32 before the output cast. ``weight`` is ``[N, K]``, the
``nn.Linear`` layout (the JAX function takes its transpose ``[K, N]``).

This is the bf16 serving path: on the card the kernel takes bf16 only,
contiguous and 16-byte aligned, ``K % 32 == 0`` and ``N % 128 == 0``, any M.
Anything else on a CUDA tensor raises; there is no fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

K_TILE = 32
N_TILE = 128
EPS = 1e-6


def ln_mod_matmul_reference(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                            weight: torch.Tensor, bias: torch.Tensor,
                            activation: Optional[str] = "gelu_tanh") -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's cast points."""
    xf = x.float()
    centered = xf - xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((centered * centered).mean(dim=-1, keepdim=True) + EPS)
    normed = (centered * (rstd * (1.0 + scale.float()[:, None, :]))
              + shift.float()[:, None, :]).to(x.dtype)
    acc = torch.matmul(normed.float(), weight.float().t()) + bias.float()
    if activation == "gelu_tanh":
        acc = torch.nn.functional.gelu(acc, approximate="tanh")
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return acc.to(x.dtype)


def _check_cuda_args(x, scale, shift, weight, bias, activation) -> None:
    if activation not in (None, "gelu_tanh"):
        raise ValueError(f"unknown activation {activation!r}")
    if x.ndim != 3:
        raise ValueError(f"ln_mod_matmul: x must be [B, M, K], got {tuple(x.shape)}")
    b, _, k = x.shape
    n = weight.shape[0]
    shapes = {"scale": (scale, (b, k)), "shift": (shift, (b, k)),
              "weight": (weight, (n, k)), "bias": (bias, (n,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"ln_mod_matmul: {name} must be {want}, got {tuple(t.shape)}")
    for name, t in (("x", x), ("scale", scale), ("shift", shift),
                    ("weight", weight), ("bias", bias)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"ln_mod_matmul: {name} must be bfloat16, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"ln_mod_matmul: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"ln_mod_matmul: {name} must be contiguous and 16-byte aligned")
    if k % K_TILE or n % N_TILE:
        raise ValueError(f"ln_mod_matmul: K must be a multiple of {K_TILE} and N of "
                         f"{N_TILE}, got K={k}, N={n}")


def ln_mod_matmul(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor,
                  activation: Optional[str] = "gelu_tanh") -> torch.Tensor:
    """``act((LN(x) * (1 + scale) + shift) @ weight.T + bias)``.

    x ``[B, M, K]``; scale/shift ``[B, K]``; weight ``[N, K]``; bias ``[N]``.
    CPU tensors take :func:`ln_mod_matmul_reference`; CUDA tensors launch the
    kernel (counted in ``ln_mod_matmul.launches``) or raise."""
    if x.device.type == "cpu":
        return ln_mod_matmul_reference(x, scale, shift, weight, bias, activation)
    if x.device.type != "cuda":
        raise ValueError(f"ln_mod_matmul: unsupported device {x.device}")
    _check_cuda_args(x, scale, shift, weight, bias, activation)
    from eraxvif5tts_tpu_torch.ops import _cuda

    b, m, k = x.shape
    n = weight.shape[0]
    out = torch.empty((b, m, n), dtype=x.dtype, device=x.device)
    stats = torch.empty((b * m, 2), dtype=torch.float32, device=x.device)
    lib = _cuda.kernels().lib
    with torch.cuda.device(x.device):
        code = lib.erax_ln_mod_matmul(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), out.data_ptr(), stats.data_ptr(), b, m, k, n,
            int(activation == "gelu_tanh"), EPS, _cuda.stream_ptr(x.device))
    _cuda.check(code, "ln_mod_matmul")
    ln_mod_matmul.launches += 1
    return out


ln_mod_matmul.launches = 0
