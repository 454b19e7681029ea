"""The fused projections of a transformer block: the normalised, modulated
feed-forward input projection and the gated residual projection.

Port of `eraxvif5tts_tpu/ops/fused_matmul.py`, both of its Pallas kernels:

- :func:`ln_mod_matmul` (Pallas body `_ln_mod_kernel`) launches the CUDA
  kernel `csrc/ln_mod_matmul.cu`: per batch row,
  ``act((norm(x) * (1 + scale) + shift) @ weight.T + bias)`` with a
  scale-free norm over K in fp32, the modulated activation cast to x's dtype
  before the product, fp32 accumulation, and the tanh-GELU in fp32 before the
  output cast. ``norm="ln"`` (eps 1e-6) is the layernorm of the DiT block's
  AdaLN; ``norm="rms"`` (eps 1e-12) is the UNetT's x_transformers RMSNorm,
  ``x * rsqrt(mean(x^2) + eps)`` with no mean subtraction, whose gain the
  caller folds into ``scale = g - 1``. It is the bf16 serving FF input
  projection of both backbones.
- :func:`matmul_gate_res` (Pallas body `_gate_res_kernel`) launches
  `csrc/matmul_gate_res.cu`: ``res + gate * (h @ weight.T + bias)``, the
  product in h's dtype with fp32 accumulation, bias, gate and residual in
  fp32, rows ``>= lens[b]`` left as ``res`` with ``mask_rows``. As in the JAX
  package, no model calls it (its hardware ablation measured XLA's own
  epilogue fusion faster); it is held against its plain version on the card.

Each runs its plain PyTorch version (``*_reference``) for CPU tensors.
``weight`` is ``[N, K]``, the ``nn.Linear`` layout (the JAX functions take its
transpose ``[K, N]``). On the card both kernels take bf16 only, contiguous and
16-byte aligned, ``K % 32 == 0`` and ``N % 128 == 0``, any M (and ``lens``
int32 on the device). Anything else on a CUDA tensor raises; there is no
fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

K_TILE = 32
N_TILE = 128
EPS = {"ln": 1e-6, "rms": 1e-12}  # each norm's eps in the JAX package's models
_NORM_CODES = {"ln": 0, "rms": 1}  # the kernel's `norm` argument


def ln_mod_matmul_reference(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                            weight: torch.Tensor, bias: torch.Tensor,
                            activation: Optional[str] = "gelu_tanh", norm: str = "ln",
                            eps: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's cast points; ``eps``
    defaults to ``EPS[norm]``."""
    if norm not in _NORM_CODES:
        raise ValueError(f"unknown norm {norm!r} (ln | rms)")
    eps = EPS[norm] if eps is None else eps
    xf = x.float()
    centered = xf - xf.mean(dim=-1, keepdim=True) if norm == "ln" else xf
    rstd = torch.rsqrt((centered * centered).mean(dim=-1, keepdim=True) + eps)
    normed = (centered * (rstd * (1.0 + scale.float()[:, None, :]))
              + shift.float()[:, None, :]).to(x.dtype)
    acc = torch.matmul(normed.float(), weight.float().t()) + bias.float()
    if activation == "gelu_tanh":
        acc = torch.nn.functional.gelu(acc, approximate="tanh")
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return acc.to(x.dtype)


def _check_bf16_operands(fn: str, x: torch.Tensor, shapes: dict) -> tuple[int, int]:
    """The kernels' common domain: x ``[B, M, K]`` and each named tensor of
    ``shapes`` (name -> (tensor, shape)) bf16 on x's device, contiguous and
    16-byte aligned, ``K % K_TILE == 0``; returns (K, N) with N the first
    dim of ``weight``."""
    if x.ndim != 3:
        raise ValueError(f"{fn}: x must be [B, M, K], got {tuple(x.shape)}")
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{fn}: {name} must be {want}, got {tuple(t.shape)}")
    for name, t in (("x", x), *((name, t) for name, (t, _) in shapes.items())):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{fn}: {name} must be bfloat16, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")
    k, n = x.shape[-1], shapes["weight"][0].shape[0]
    if k % K_TILE or n % N_TILE:
        raise ValueError(f"{fn}: K must be a multiple of {K_TILE} and N of "
                         f"{N_TILE}, got K={k}, N={n}")
    return k, n


def _check_cuda_args(x, scale, shift, weight, bias, activation, norm, eps) -> None:
    if activation not in (None, "gelu_tanh"):
        raise ValueError(f"unknown activation {activation!r}")
    if norm not in _NORM_CODES:
        raise ValueError(f"unknown norm {norm!r} (ln | rms)")
    if not eps > 0.0:
        raise ValueError(f"ln_mod_matmul: eps must be positive, got {eps}")
    b, k = (x.shape[0], x.shape[-1]) if x.ndim == 3 else (0, 0)
    n = weight.shape[0]
    _check_bf16_operands("ln_mod_matmul", x, {
        "scale": (scale, (b, k)), "shift": (shift, (b, k)),
        "weight": (weight, (n, k)), "bias": (bias, (n,))})


def ln_mod_matmul(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor,
                  activation: Optional[str] = "gelu_tanh", norm: str = "ln",
                  eps: Optional[float] = None) -> torch.Tensor:
    """``act((norm(x) * (1 + scale) + shift) @ weight.T + bias)`` with
    ``norm`` the scale-free layernorm (``"ln"``) or RMS norm (``"rms"``) over
    K; ``eps`` defaults to ``EPS[norm]``.

    x ``[B, M, K]``; scale/shift ``[B, K]``; weight ``[N, K]``; bias ``[N]``.
    CPU tensors take :func:`ln_mod_matmul_reference`; CUDA tensors launch the
    kernel or raise. ``ln_mod_matmul.launches`` counts every launch and
    ``ln_mod_matmul.launches_by_norm[norm]`` those of each mode."""
    if x.device.type == "cpu":
        return ln_mod_matmul_reference(x, scale, shift, weight, bias, activation, norm, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_mod_matmul: unsupported device {x.device}")
    eps = EPS.get(norm) if eps is None else eps
    _check_cuda_args(x, scale, shift, weight, bias, activation, norm, eps)
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
            int(activation == "gelu_tanh"), _NORM_CODES[norm], eps,
            _cuda.stream_ptr(x.device))
    _cuda.check(code, "ln_mod_matmul")
    ln_mod_matmul.launches += 1
    ln_mod_matmul.launches_by_norm[norm] += 1
    return out


ln_mod_matmul.launches = 0
ln_mod_matmul.launches_by_norm = {"ln": 0, "rms": 0}


def matmul_gate_res_reference(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                              gate: torch.Tensor, res: torch.Tensor,
                              lens: Optional[torch.Tensor] = None,
                              mask_rows: bool = False) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's cast points."""
    acc = torch.matmul(h.float(), weight.float().t()) + bias.float()
    update = gate.float()[:, None, :] * acc
    if mask_rows:
        rows = torch.arange(h.shape[1], device=h.device)[None, :, None]
        update = torch.where(rows < lens[:, None, None], update, 0.0)
    return (res.float() + update).to(h.dtype)


def _check_gate_res_args(h, weight, bias, gate, res, lens, mask_rows) -> None:
    b, m, k = h.shape if h.ndim == 3 else (0, 0, 0)
    n = weight.shape[0]
    _check_bf16_operands("matmul_gate_res", h, {
        "weight": (weight, (n, k)), "bias": (bias, (n,)), "gate": (gate, (b, n)),
        "res": (res, (b, m, n))})
    if mask_rows and (lens is None or lens.shape != (b,) or lens.dtype != torch.int32
                      or lens.device != h.device):
        raise ValueError(f"matmul_gate_res: mask_rows needs lens, an int32 [{b}] tensor on "
                         f"{h.device}")


def matmul_gate_res(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    gate: torch.Tensor, res: torch.Tensor,
                    lens: Optional[torch.Tensor] = None,
                    mask_rows: bool = False) -> torch.Tensor:
    """``res + gate * (h @ weight.T + bias)``, rows ``>= lens[b]`` left as
    ``res`` when ``mask_rows``.

    h ``[B, M, K]``; weight ``[N, K]``; bias ``[N]``; gate ``[B, N]``; res
    ``[B, M, N]``; lens ``[B]`` int32 (required iff mask_rows). CPU tensors
    take :func:`matmul_gate_res_reference`; CUDA tensors launch the kernel
    (counted in ``matmul_gate_res.launches``) or raise."""
    if h.device.type == "cpu":
        return matmul_gate_res_reference(h, weight, bias, gate, res, lens, mask_rows)
    if h.device.type != "cuda":
        raise ValueError(f"matmul_gate_res: unsupported device {h.device}")
    _check_gate_res_args(h, weight, bias, gate, res, lens, mask_rows)
    from eraxvif5tts_tpu_torch.ops import _cuda

    b, m, k = h.shape
    n = weight.shape[0]
    out = torch.empty_like(res)
    lib = _cuda.kernels().lib
    with torch.cuda.device(h.device):
        code = lib.erax_matmul_gate_res(
            h.data_ptr(), weight.data_ptr(), bias.data_ptr(), gate.data_ptr(),
            res.data_ptr(), lens.data_ptr() if mask_rows else None, out.data_ptr(),
            b, m, k, n, int(mask_rows), _cuda.stream_ptr(h.device))
    _cuda.check(code, "matmul_gate_res")
    matmul_gate_res.launches += 1
    return out


matmul_gate_res.launches = 0
