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

On the card a pre-pass writes the codes of x, then one thread-block cluster
of ``C = N / 512`` CTAs takes each 64-row tile, split along N: int8 ``wgmma``
fed by TMA, the hidden rows' maxima exchanged through distributed shared
memory, the hidden codes kept in the cluster's shared memory and read by
GEMM 2 across the cluster.
:func:`int8_ff_geometry` states its tiles, cluster, shared memory and tensor
maps in plain Python; a card test holds the built constants to it
(:func:`kernel_int8_ff_geometry`).

Gate: :func:`use_int8_ff` reads ``ERAX_INT8_FF`` at call time, as the JAX gate
does. The JAX gate's TPU and VMEM conditions are not ported: the kernel takes
every M. On the card it takes bf16 x and the domain of
:func:`int8_ff_geometry` (every preset's widths: K = K2 = 768 or 1024, N =
``ff_mult`` 2 or 4 times that); anything else on a CUDA tensor raises. There
is no fallback.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from eraxvif5tts_tpu_torch.ops.quant import int_mm, quantize_rows

TILE_ROWS = 64     # rows of x a tile: one cluster, one m64 product
SLAB = 512         # hidden columns a CTA of the cluster
WG_COLUMNS = 256   # of which each of its two consumer warpgroups takes (m64n256k32)
K_TILE = 128       # bytes of K (of N in GEMM 2) a ring stage: one 128-byte swizzled row
STAGES = 2
THREADS = 384      # two consumer warpgroups and the producer's
MAX_K = 1024       # the pre-pass holds a row of x in registers
MAX_CLUSTER = 8    # the portable cluster size
GEMM2_COLUMNS = (64, 128)  # GEMM 2's output columns a warpgroup: m64n64k32, m64n128k32
RING = STAGES * (TILE_ROWS * K_TILE + SLAB * K_TILE)  # GEMM 1's ring; GEMM 2 recuts it
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


def int8_ff_geometry(k: int, n: int, k2: int) -> dict:
    """How kernel 5 covers ``x [R, K] -> [R, K2]`` through ``N`` hidden
    columns, or ValueError outside its domain:

    - ``K % 128 == 0`` and ``K <= 1024`` (a ring stage is 128 bytes of K; the
      pre-pass holds a row in registers);
    - ``N % 512 == 0`` with ``cluster = N / 512 <= 8`` (a CTA's slab, the
      portable cluster size);
    - ``K2 = 2 * cluster * gemm2_columns`` with ``gemm2_columns`` 64 or 128
      (GEMM 2's output columns a consumer warpgroup).

    Every preset's FF is inside: (K, N, K2) = (768, 1536, 768),
    (768, 3072, 768), (1024, 2048, 1024), (1024, 4096, 1024).

    - ``tile_rows``: rows a cluster takes; ``slab``: hidden columns a CTA
      (``wg_columns`` a consumer warpgroup); ``out_columns``: output columns
      a CTA, ``gemm2_columns`` a warpgroup;
    - ``stages``, ``threads``, ``shared_bytes``: GEMM 1's ring depth, the
      block and its dynamic shared memory (1024 bytes of alignment slack, the
      ring of an A tile [64, 128] and 512 w1 rows of 128 bytes a stage, the
      CTA's hidden codes [64, 512], the row maxima, the barriers of both
      rings); ``gemm2_stages``: the same ring bytes cut into stages of an A
      tile and the CTA's ``2 * gemm2_columns`` w2 rows;
    - ``steps``: ring stages of GEMM 1 and of GEMM 2;
    - ``xq_map`` / ``w1_map`` / ``w2_map``: the TMA maps of the 8-bit
      matrices, innermost dimension first (``dims`` in elements, ``box`` the
      tile one load brings); rows of x past R read as zeros."""
    cluster = n // SLAB if n % SLAB == 0 else 0
    if (k < K_TILE or k % K_TILE or k > MAX_K or not 1 <= cluster <= MAX_CLUSTER
            or k2 % (2 * cluster) or k2 // (2 * cluster) not in GEMM2_COLUMNS):
        raise ValueError(
            f"int8_ff: the kernel takes K % {K_TILE} == 0 and K <= {MAX_K}, N % {SLAB} == 0 "
            f"with N / {SLAB} <= {MAX_CLUSTER} (the cluster), and K2 = 2 x cluster x "
            f"{' or '.join(map(str, GEMM2_COLUMNS))}; got K={k}, N={n}, K2={k2}")
    gemm2 = k2 // (2 * cluster)
    max_stages2 = RING // (TILE_ROWS * K_TILE + 2 * min(GEMM2_COLUMNS) * K_TILE)
    shared = (1024 + RING + TILE_ROWS * SLAB + 3 * TILE_ROWS * 4
              + 2 * (STAGES + max_stages2) * 8)
    return dict(tile_rows=TILE_ROWS, slab=SLAB, wg_columns=WG_COLUMNS, cluster=cluster,
                out_columns=k2 // cluster, gemm2_columns=gemm2,
                gemm2_stages=RING // (TILE_ROWS * K_TILE + 2 * gemm2 * K_TILE),
                k_tile=K_TILE, stages=STAGES,
                threads=THREADS, shared_bytes=shared, steps=(k // K_TILE, n // K_TILE),
                xq_map=dict(dims=(k, "R"), box=(K_TILE, TILE_ROWS)),
                w1_map=dict(dims=(k, n), box=(K_TILE, WG_COLUMNS)),
                w2_map=dict(dims=(n, k2), box=(K_TILE, 2 * gemm2)))


def int8_ff_grid(rows: int, n: int) -> int:
    """CTAs of a launch over ``rows`` rows: a cluster of N / 512 a 64-row tile."""
    return -(-rows // TILE_ROWS) * (n // SLAB)


def kernel_int8_ff_geometry(k: int, n: int, k2: int) -> dict:
    """The constants the built kernel reports and its cluster for this shape
    (needs the card's build): they must equal :func:`int8_ff_geometry`'s."""
    import ctypes

    from eraxvif5tts_tpu_torch.ops import _cuda

    out = (ctypes.c_int * 11)()
    _cuda.kernels().lib.erax_int8_ff_geometry(k, n, k2, out)
    return dict(tile_rows=out[0], slab=out[1], wg_columns=out[2], k_tile=out[3],
                stages=out[4], threads=out[5], shared_bytes=out[6], max_k=out[7],
                cluster=out[8], gemm2_columns=out[9], gemm2_stages=out[10])


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
    if 0 in x.shape:
        raise ValueError(f"int8_ff: x must not be empty, got {tuple(x.shape)}")
    int8_ff_geometry(k, n, k2)


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
    # the pre-pass's output: the codes of x and its row scales
    x_codes = torch.empty((b * m, k), dtype=torch.int8, device=x.device)
    x_scales = torch.empty((b * m,), dtype=torch.float32, device=x.device)
    lib = _cuda.kernels().lib
    with torch.cuda.device(x.device):
        code = lib.erax_int8_ff(
            x.data_ptr(), w1_q.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2_q.data_ptr(),
            s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            h_codes.data_ptr() if h_codes is not None else None, x_codes.data_ptr(),
            x_scales.data_ptr(), b * m, k, n, k2, _cuda.stream_ptr(x.device))
    _cuda.check(code, "int8_ff")
    _cuda.count(int8_ff, "launches")
    return out


int8_ff.launches = 0
