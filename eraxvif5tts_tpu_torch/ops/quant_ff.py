"""One-kernel int8 W8A8 feed-forward: quantize -> GEMM -> GELU -> requantize
-> GEMM (opt-in, ``ERAX_INT8_FF=1``).

Port of `eraxvif5tts_tpu/ops/quant_ff.py` (`int8_ff_fused`, Pallas body
`_kernel`). :func:`int8_ff` launches the CUDA kernel `csrc/int8_ff.cu` for
CUDA tensors and runs :func:`int8_ff_reference`, the plain PyTorch version,
for CPU tensors. Semantics, per row of ``x [B, M, K]``:

    x_q, a_scale = quantize_rows(x)                      # fp32, per row
    h   = gelu_tanh(int32(x_q @ w1^T) * (a_scale * s1) + b1)   # fp32 hidden
    h_q, h_scale = quantize_rows(h)
    out = int32(h_q @ w2^T) * (h_scale * s2) + b2        # then x's dtype

with the weights in the ``nn.Linear`` layout (``w1 [N, K]``, ``w2 [K2, N]``
int8; the JAX function takes their transposes), fp32 scales and biases. The
hidden state stays fp32 (the unfused ``QuantLinear`` chain rounds it to bf16
before the GELU).

Gate: :func:`use_int8_ff` reads ``ERAX_INT8_FF`` at call time, as the JAX gate
does. The JAX gate's TPU and VMEM conditions are not ported: the kernel takes
every M. On the card it takes bf16 x, ``K % 64 == 0``, ``N`` and ``K2``
multiples of 512, and a 16-row block's working set within the card's shared
memory; anything else on a CUDA tensor raises. There is no fallback.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from eraxvif5tts_tpu_torch.ops.quant import int_mm, quantize_rows

ROWS = 16          # rows of x per thread block
K_TILE = 64        # the kernel's K step (both GEMMs)
COL_TILE = 512     # columns of one GEMM pass across the block's 8 warps
ROW_PAD = 64       # int8 shared rows padded by 64 bytes (bank-conflict free)
HIDDEN_PAD = 8     # fp32 shared hidden rows padded by 8 values
SMEM_LIMIT = 232448  # dynamic shared memory a block may opt in to (H100)
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def use_int8_ff() -> bool:
    """The dispatch gate: ``ERAX_INT8_FF=1`` (opt-in, read at call time)."""
    return os.environ.get("ERAX_INT8_FF") == "1"


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-GELU written out in the JAX kernel's order of operations."""
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)))


def hidden_codes(x: torch.Tensor, w1_q: torch.Tensor, s1: torch.Tensor,
                 b1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version's first half: the int8 codes of the fp32 hidden state
    ``[B, M, N]`` and their per-row scales."""
    x_q, a_scale = quantize_rows(x.float())
    h = int_mm(x_q, w1_q).float() * (a_scale * s1.float()) + b1.float()
    return quantize_rows(gelu_tanh(h))


def int8_ff_reference(x: torch.Tensor, w1_q: torch.Tensor, s1: torch.Tensor,
                      b1: torch.Tensor, w2_q: torch.Tensor, s2: torch.Tensor,
                      b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version with the kernel's cast points; returns x's dtype."""
    h_q, h_scale = hidden_codes(x, w1_q, s1, b1)
    out = int_mm(h_q, w2_q).float() * (h_scale * s2.float()) + b2.float()
    return out.to(x.dtype)


def smem_bytes(k: int, n: int) -> int:
    """Dynamic shared memory of one block: x_q and h_q int8 rows, the fp32
    hidden rows, the two row-scale vectors."""
    return ROWS * ((k + ROW_PAD) + 4 * (n + HIDDEN_PAD) + (n + ROW_PAD) + 8)


def _check_cuda_args(x, w1_q, s1, b1, w2_q, s2, b2) -> None:
    if x.ndim != 3:
        raise ValueError(f"int8_ff: x must be [B, M, K], got {tuple(x.shape)}")
    k = x.shape[-1]
    n, k2 = w1_q.shape[0], w2_q.shape[0]
    shapes = {"w1_q": (w1_q, (n, k)), "w2_q": (w2_q, (k2, n)), "s1": (s1, (n,)),
              "b1": (b1, (n,)), "s2": (s2, (k2,)), "b2": (b2, (k2,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"int8_ff: {name} must be {want}, got {tuple(t.shape)}")
    dtypes = {"x": (x, torch.bfloat16), "w1_q": (w1_q, torch.int8), "w2_q": (w2_q, torch.int8),
              "s1": (s1, torch.float32), "b1": (b1, torch.float32),
              "s2": (s2, torch.float32), "b2": (b2, torch.float32)}
    for name, (t, want) in dtypes.items():
        if t.dtype != want:
            raise TypeError(f"int8_ff: {name} must be {want}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"int8_ff: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_ff: {name} must be contiguous and 16-byte aligned")
    if k % K_TILE or n % COL_TILE or k2 % COL_TILE:
        raise ValueError(f"int8_ff: K must be a multiple of {K_TILE} and N, K2 of "
                         f"{COL_TILE}, got K={k}, N={n}, K2={k2}")
    if smem_bytes(k, n) > SMEM_LIMIT:
        raise ValueError(f"int8_ff: a {ROWS}-row block needs {smem_bytes(k, n)} bytes of "
                         f"shared memory at K={k}, N={n}, beyond {SMEM_LIMIT}")


def int8_ff(x: torch.Tensor, w1_q: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
            w2_q: torch.Tensor, s2: torch.Tensor, b2: torch.Tensor,
            h_codes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 feed-forward of ``x [B, M, K]`` -> ``[B, M, K2]`` in x's dtype.

    CPU tensors take :func:`int8_ff_reference`; CUDA tensors launch the kernel
    (counted in ``int8_ff.launches``) or raise. ``h_codes``, an int8
    ``[B, M, N]`` tensor on x's device, receives the hidden state's codes
    (the kernel's requantization, for checks against :func:`hidden_codes`)."""
    if x.device.type == "cpu":
        if h_codes is not None:
            h_codes.copy_(hidden_codes(x, w1_q, s1, b1)[0])
        return int8_ff_reference(x, w1_q, s1, b1, w2_q, s2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"int8_ff: unsupported device {x.device}")
    _check_cuda_args(x, w1_q, s1, b1, w2_q, s2, b2)
    b, m, k = x.shape
    n, k2 = w1_q.shape[0], w2_q.shape[0]
    if h_codes is not None and (h_codes.shape != (b, m, n) or h_codes.dtype != torch.int8
                                or h_codes.device != x.device
                                or not h_codes.is_contiguous()):
        raise ValueError(f"int8_ff: h_codes must be a contiguous int8 {(b, m, n)} tensor on "
                         f"{x.device}")
    from eraxvif5tts_tpu_torch.ops import _cuda

    out = torch.empty((b, m, k2), dtype=x.dtype, device=x.device)
    lib = _cuda.kernels().lib
    with torch.cuda.device(x.device):
        code = lib.erax_int8_ff(
            x.data_ptr(), w1_q.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2_q.data_ptr(),
            s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            h_codes.data_ptr() if h_codes is not None else None, b * m, k, n, k2,
            smem_bytes(k, n), _cuda.stream_ptr(x.device))
    _cuda.check(code, "int8_ff")
    int8_ff.launches += 1
    return out


int8_ff.launches = 0
