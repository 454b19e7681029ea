"""The fused projections of a transformer block: the normalised, modulated
feed-forward input projection and the gated residual projection.

Port of `eraxvif5tts_tpu/ops/fused_matmul.py`, both of its Pallas kernels:

- :func:`ln_mod_matmul` (Pallas body `_ln_mod_kernel`) launches the CUDA
  kernel `csrc/ln_mod_matmul.cu` (a small row-statistics kernel, then the
  GEMM): per batch row,
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
transpose ``[K, N]``). Both kernels are instances of one persistent
``wgmma`` + TMA GEMM (`csrc/wgmma_gemm.cuh`), whose tiles, schedule, shared
memory and tensor maps :func:`gemm_geometry` states in plain Python; the
fragment and address maps its threads use are mirrored below it, for the CPU
tests to walk. On the card both kernels take bf16 only, contiguous and
16-byte aligned, ``K % 64 == 0`` and ``N % 128 == 0``, any M (and ``lens``
int32 on the device); :func:`ln_mod_matmul` also wants ``K <= 2048`` (a
batch row's scale and shift stay in shared memory). Anything else on a CUDA
tensor raises; there is no fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from eraxvif5tts_tpu_torch.ops.train_attention import swizzled_offset

K_TILE = 64       # columns of K a ring stage (one 128-byte swizzled row)
N_TILE = 128      # columns an accumulator: wgmma m64n128k16
M_TILE = 128      # rows an output tile: 64 a consumer warpgroup
GEMM_STAGES = 4
GEMM_THREADS = 384  # two consumer warpgroups and the producer's
GEMM_MAX_NORM_K = 2048  # ln_mod_matmul: scale and shift rows must fit their buffers
SMS = 132         # streaming multiprocessors of an H100
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
EPS = {"ln": 1e-6, "rms": 1e-12}  # each norm's eps in the JAX package's models
_NORM_CODES = {"ln": 0, "rms": 1}  # the kernel's `norm` argument


def use_fused_serving(dtype: torch.dtype) -> bool:
    """The serving blocks' fusion gate, the JAX package's dtype rule
    (`eraxvif5tts_tpu/ops/fused_matmul.py:134-156`, `dit_block_fusion_ok`):
    only a bf16 block runs its norm + modulate + FF input projection as
    :func:`ln_mod_matmul`; an fp32 block takes the unfused branch. The DiT's
    ``FeedForward`` and the UNetT both ask it."""
    return dtype == torch.bfloat16


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
    if k % K_TILE or n % N_TILE or n == 0 or 0 in x.shape:
        raise ValueError(f"{fn}: K must be a multiple of {K_TILE} and N of "
                         f"{N_TILE}, no dimension empty, got x {tuple(x.shape)}, N={n}")
    return k, n


def gemm_nacc(b: int, m: int, n: int, sms: int = SMS) -> int:
    """Accumulators a consumer warpgroup, i.e. tile columns / 128 (the mirror
    of ``gemm_pick_nacc`` in `csrc/wgmma_gemm.cuh`): 256-column tiles
    normalise each x tile half as often and win a tie; 128-column tiles are
    taken where N is no multiple of 256 or where their waves cover fewer
    columns in all."""
    if n % (2 * N_TILE):
        return 1
    rows = b * -(-m // M_TILE)
    wide_cost = -(-(rows * (n // (2 * N_TILE))) // sms) * 2
    narrow_cost = -(-(rows * (n // N_TILE)) // sms)
    return 1 if narrow_cost < wide_cost else 2


def gemm_geometry(b: int, m: int, k: int, n: int, sms: int = SMS) -> dict:
    """How the GEMM core covers ``out [b, m, n] = epilogue(A [b, m, k] W [n, k]^T)``
    on a card with ``sms`` multiprocessors:

    - ``tile``: (rows, columns) of an output tile, ``nacc`` accumulators of
      128 columns a warpgroup; ``warpgroups``: the (first row, rows) of the
      tile each consumer warpgroup owns;
    - ``grid``: persistent blocks; block i walks ``tiles[i::grid]``, and
      ``waves`` is the most tiles one block takes. ``tiles`` lists
      ``(column panel, batch row, row tile)`` in the order of the walk: every
      row tile under one weight panel before the next panel, no tile across
      two batch rows;
    - ``stages``, ``threads``, ``shared_bytes``: the ring's depth, the block
      and its dynamic shared memory (1024 bytes of alignment slack, the ring
      of an A tile and two 128-row W tiles a stage, two scale / shift
      buffers, the barriers);
    - ``a_map`` / ``w_map``: the TMA maps, innermost dimension first:
      ``dims`` in elements, ``strides`` in bytes (of all but the innermost),
      ``box`` the tile one load brings. M is a dimension of its own in A's
      map, so rows past M read as zeros, never as the next batch row's."""
    if k % K_TILE or n % N_TILE or min(b, m, k, n) < 1:
        raise ValueError(f"gemm_geometry: K must be a multiple of {K_TILE} and N of {N_TILE}, "
                         f"got b={b}, m={m}, k={k}, n={n}")
    nacc = gemm_nacc(b, m, n, sms)
    tiles_m, panels = -(-m // M_TILE), n // (nacc * N_TILE)
    tiles = [(ni, bi, mi) for ni in range(panels) for bi in range(b) for mi in range(tiles_m)]
    grid = min(len(tiles), sms)
    stage = M_TILE * K_TILE * 2 + 2 * N_TILE * K_TILE * 2
    shared = (1024 + GEMM_STAGES * stage + 2 * (2 * GEMM_MAX_NORM_K * 2)
              + (2 * GEMM_STAGES + 4) * 8)
    return dict(tile=(M_TILE, nacc * N_TILE), nacc=nacc, k_tile=K_TILE,
                warpgroups=[(0, 64), (64, 64)], grid=grid, tiles=tiles,
                waves=-(-len(tiles) // grid), stages=GEMM_STAGES, threads=GEMM_THREADS,
                shared_bytes=shared,
                a_map=dict(dims=(k, m, b), strides=(k * 2, m * k * 2), box=(K_TILE, M_TILE, 1)),
                w_map=dict(dims=(k, n), strides=(k * 2,), box=(K_TILE, N_TILE)))


def kernel_gemm_geometry(b: int, m: int, n: int) -> dict:
    """The constants the built GEMM core reports, and its choice for this
    shape on the current device (needs the card's build): they must equal
    :func:`gemm_geometry`'s with ``sms`` the device's."""
    import ctypes

    from eraxvif5tts_tpu_torch.ops import _cuda

    out = (ctypes.c_int * 10)()
    _cuda.kernels().lib.erax_gemm_geometry(b, m, n, out)
    return dict(tile_rows=out[0], acc_columns=out[1], k_tile=out[2], stages=out[3],
                threads=out[4], shared_bytes=out[5], max_norm_k=out[6], nacc=out[7],
                grid=out[8], sms=out[9])


def a_fragment_reads(warp: int, lane: int, kk: int) -> tuple[int, list]:
    """The normalising A path of one thread (warp 0-3 of its warpgroup) for
    k16 step ``kk`` of a stage (``gemm_norm_fragments``): the byte offset,
    inside the warpgroup's swizzled ``[64, 64]`` x tile, of the 16-byte row
    it hands ``ldmatrix.x4`` (through ``swizzled_offset``, the map TMA writes
    a tile of 128-byte rows by), and the four ``(row, first column)`` pairs it
    receives, in the order of the ``wgmma`` A fragment's registers. Lane l
    addresses row ``l % 8`` of matrix ``l // 8``; matrix j is rows
    ``8 (j % 2)..`` and chunk ``2 kk + j // 2`` of the warp's 16 rows; a lane
    receives row ``l // 4``, columns ``2 (l % 4)`` and + 1 of each matrix."""
    mat = lane // 8
    address = swizzled_offset(16 * warp + 8 * (mat % 2) + lane % 8, 8 * (2 * kk + mat // 2))
    g, t = divmod(lane, 4)
    received = [(16 * warp + 8 * (j % 2) + g, 16 * kk + 8 * (j // 2) + 2 * t) for j in range(4)]
    return address, received


def accumulator_element(warp: int, lane: int, i: int) -> tuple[int, int]:
    """(row, column), inside a warpgroup's ``[64, 128]`` accumulator tile, of
    register ``i`` (0-63) of a thread: ``d[4 c + e]`` is row
    ``16 warp + g + 8 (e // 2)``, column ``8 c + 2 t + e % 2`` with
    ``lane = 4 g + t``."""
    g, t = divmod(lane, 4)
    c, e = divmod(i, 4)
    return 16 * warp + g + 8 * (e // 2), 8 * c + 2 * t + e % 2


def quad_transpose(values: list) -> list:
    """The epilogue's exchange among the four lanes of a quad
    (``gemm_quad_transpose``), on ``values[t][c]`` = what lane t holds for
    column group c: two rounds of ``shfl.xor`` (1, then 2), each lane keeping
    half of its registers and swapping the other half. Returns ``out[t][i]``,
    which the kernel takes to be what lane i held for group t."""
    a = [list(v) for v in values]
    for xor, pairs in ((1, ((0, 1), (2, 3))), (2, ((0, 2), (1, 3)))):
        sent = [[a[t][hi] if not t & xor else a[t][lo] for lo, hi in pairs] for t in range(4)]
        for t in range(4):
            for (lo, hi), got in zip(pairs, sent[t ^ xor]):
                a[t][lo if t & xor else hi] = got
    return a


def epilogue_chunks(warp: int, lane: int) -> list:
    """The ``(row, first column, sources)`` of each 16-byte store a thread's
    epilogue makes for one ``[64, 128]`` accumulator: for column block cb
    (32 columns) and row half r, 8 neighbouring columns from ``8 t`` on,
    ``sources[2 i + e]`` = (lane, register) the value came from: lane
    ``4 g + i``'s register ``4 (4 cb + t) + 2 r + e``."""
    g, t = divmod(lane, 4)
    return [(16 * warp + g + 8 * r, 32 * cb + 8 * t,
             [(4 * g + i, 4 * (4 * cb + t) + 2 * r + e) for i in range(4) for e in range(2)])
            for cb in range(N_TILE // 32) for r in range(2)]


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
    if k > GEMM_MAX_NORM_K:
        raise ValueError(f"ln_mod_matmul: K must be at most {GEMM_MAX_NORM_K}, got K={k}")


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
    _cuda.count(ln_mod_matmul, "launches", ("launches_by_norm", norm))
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
    _cuda.count(matmul_gate_res, "launches")
    return out


matmul_gate_res.launches = 0
