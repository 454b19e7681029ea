"""Flash attention for training, with position-hash attention dropout.

Port of `eraxvif5tts_tpu/ops/train_attention.py` (`train_attention`, whose
Pallas kernels are `_fwd_kernel`, `_dq_kernel` and `_dkv_kernel` under a
custom_vjp). :func:`train_attention` runs, for CUDA tensors, a
``torch.autograd.Function`` whose forward launches the forward kernel of
`csrc/train_attention.cu` (bf16) or `csrc/train_attention_fp32.cu` (fp32)
and whose backward launches the same source's dq and dk/dv kernels; for
CPU tensors it runs :func:`train_attention_reference`, the plain
PyTorch version of the same semantics, differentiated by autograd:

- logits and softmax in fp32, keys at positions ``>= lens[b]`` set to the
  finite -1e30 (a sample with ``lens = 0`` averages every key, never NaN);
- attention dropout as SDPA does it: the softmax normaliser takes the
  undropped weights, the values the dropped ones scaled by ``1 / keep``; the
  backward takes the dropped weights for dv and the undropped P in
  ``ds = P * (dP_dropped - D)``;
- the keep bit of element (q, k) of head (b, h) is
  ``fmix32((q * n + k) ^ salt(seed, b, h)) < keep * 2^32`` (all mod 2^32), a
  function of absolute positions alone: the backward kernels regenerate it
  with their own tiling and no mask is stored.

Kernel domain: q, k, v all bf16 or all fp32, contiguous and 16-byte aligned
``[b, n, h, d]`` (the layout a ``Linear`` output views to) with d in
``HEAD_DIMS`` (64 or 128, the JAX package's Pallas domain, each built as an
instantiation of its own) or ``LIBRARY_HEAD_DIM`` (256: the dropout-free
training role of the JAX package's library flash kernel, kernel 6, in both
dtypes), ``n % 64 == 0``, ``n <= MAX_N`` = 2048 + 4096,
the serving attention's bound: the
DiT's training buckets and the MMDiT's joint sequence (text bucket plus mel
bucket: 1024 + 4096 under the training buckets, 2048 + 4096 under the
serving ones) in either dtype. Nothing in the kernels depends on that bound:
grids and the TMA maps take n as it comes, the LSE / D rows and every
offset into ``[b, n, h, d]`` are 64-bit (b = 9, n = 6144, h = 16 is 5.7e7
elements a tensor, inside 32 bits all the same), the fp32 kernels' shared
memory does not depend on n, and the keep bit's counter ``q * n + k`` stays
below 6144^2 = 3.8e7 < 2^32, so the hash takes it unwrapped as before.
Mixed dtypes, fp16 and anything else on a CUDA tensor raise; there is no
fallback. bf16 runs `csrc/train_attention.cu` (wgmma, tiles read by TMA;
:func:`forward_geometry` and :func:`backward_geometry` state their grid,
tiles, ring and shared memory, and the tensor map they build), fp32 runs
`csrc/train_attention_fp32.cu`: every product of the forward (the core of
`csrc/fp32_forward.cuh`, which kernel 1's fp32 mode shares), dq and dk/dv
on the tensor cores, ``mma.sync`` TF32 in 3xTF32 (each operand split into
two TF32 parts, three products each), to fp32 accuracy whatever torch's
TF32 flags say; :func:`forward_geometry_fp32` and
:func:`backward_geometry_fp32` state their grid, ring and shared memory.
The JAX package's TPU gates (``can_use_train_kernel``: n % 128, fp32 only up to
n = 3072) and calibrated backward blocks are TPU VMEM limits and are not
ported: above n = 3072 the JAX package draws its fp32 attention dropout
with ``jax.random`` (its chunked path), where the port keeps the position
hash: the same distribution, another random stream, the same function at
dropout 0.

Integer arithmetic: torch has no uint32 ``>>`` on the CPU, so the hash runs in
int64 holding 32-bit values, masked to 32 bits after every multiply (a wrapped
64-bit product keeps its low 32 bits exact).
"""

from __future__ import annotations

import math

import torch

from eraxvif5tts_tpu_torch.infer.utils import DURATION_BUCKETS, TEXT_BUCKETS

_NEG = -1e30
MAX_N = TEXT_BUCKETS[-1] + DURATION_BUCKETS[-1]  # the MMDiT's longest joint sequence
TILE = 64
HEAD_DIM = 64             # the default head dim of the geometry functions
# the head dims every mode of the kernels is built for (`csrc/`): fused rotary
# takes these alone (the JAX package's Pallas gates)
HEAD_DIMS = (64, 128)
# the JAX package's library flash kernel's further head dim (kernel 6,
# `eraxvif5tts_tpu/ops/attention.py:202`): the forward without rotary and the
# training kernels take it too, in bf16 and fp32
LIBRARY_HEAD_DIM = 256
KERNEL_HEAD_DIMS = (*HEAD_DIMS, LIBRARY_HEAD_DIM)
PANEL = 64                # bf16 columns of one 128-byte swizzle atom: a [64, d] tile is d / 64
M32 = 0xFFFFFFFF
# the backward kernels (`csrc/train_attention.cu`: BwdShape<d>, ...); the
# constants are d = 64's (and d = 128's), BWD_SHAPES each d's
BWD_ROWS = 128      # rows a block owns: two consumer warpgroups of TILE rows
BWD_STAGES = 4      # ring of TMA stages, two [TILE, d] bf16 tiles each
BWD_THREADS = 384   # two consumer warpgroups and the producer's
BWD_REGISTERS = (40, 232)  # setmaxnreg: the producer's warpgroup, each consumer's
# d -> (rows a block, ring stages, parts the head's columns are split into
# between the two consumer warpgroups): at d = 256 dk/dv's two [64, 256]
# accumulators would be 256 registers a thread, so both warpgroups take the
# block's 64 rows and 128 columns each (the score tiles computed by both)
BWD_SHAPES = {64: (128, 4, 1), 128: (128, 4, 1), 256: (64, 2, 2)}
# the forward core (`csrc/flash_forward.cuh`: FwdShape<d>), which the serving
# attention instantiates too; the constants are d = 64's, FWD_SHAPES each d's
# d -> (rows a block, setmaxnreg of the producer's warpgroup, of each consumer,
# ring stages, keys a K / V tile): at d = 128 a consumer's O accumulator is 64
# fp32 registers a thread, which three consumer warpgroups at 144 registers do
# not hold; two at 208 do, beside a [64, 128] score tile of 128-key tiles
# (whose last hangs 64 keys over n where n % 128 == 64), three stages of
# [128, 128] K and V tiles, the rotating producer warps at 88; at d = 256 O
# is 128, two at 232 with a [64, 256] tile of 32,768 bytes leave room for two
# stages of 64 keys
FWD_SHAPES = {64: (192, 72, 144, 4, 64), 128: (128, 88, 208, 3, 128), 256: (128, 40, 232, 2, 64)}
# the consumers' schedule by d without rotary: one product at a time (d = 64),
# or tile i + 1's score product in flight with tile i's P V and its softmax
# under the latter; with rotary one product at a time at every d (the
# rotators bound it, and a tile's P V then runs while the next K is rotated)
FWD_OVERLAP = {64: False, 128: True, 256: True}
FWD_ROWS = FWD_SHAPES[64][0]  # query rows a block owns: three consumer warpgroups of TILE rows
FWD_STAGES = FWD_SHAPES[64][3]  # ring of TMA stages, a K and a V tile each
FWD_THREADS = 128 * (FWD_ROWS // TILE + 1)  # the consumer warpgroups and the producer's
FWD_ROTATORS = 96   # threads of the producer's warps 1-3, which rotate tiles (rotary)
SHARED_LIMIT = 232448  # bytes of shared memory a block may use on an H100
SM_SHARED = 233472     # bytes of shared memory an SM has; the card keeps 1 KB of it a block
# the fp32 kernels, the forward core and dq, dk/dv alike (`csrc/fp32_tile.cuh`:
# kRows, kThreads, Fp32Shape<d>); FP32_STRIDE is d = 64's, d + 4 in general
FP32_ROWS = 64      # rows a block owns
FP32_THREADS = 128  # four warps, each 16 rows: one m16 tile of the 3xTF32 mma
FP32_STAGES = 2     # the forward's cp.async ring, each stage the streamed tiles of one step
FP32_STRIDE = 68    # floats a shared tile row: 64 padded by 4
# the fp32 dq and dk/dv kernels' ring: two stages at d = 64 (the four-warp
# kernels, whose warps keep their fixed operands in registers); at d = 128 and
# 256 (the pairs of warps) the split stages of the streamed tiles, each tile
# coming raw into a room of its own first: two stages in turn at d = 128 (one
# barrier a tile), one at d = 256, where the fixed tiles leave room for no more
FP32_BWD_STAGES = {64: 2, 128: 2, 256: 1}
# padded [64, d] fp32 tiles of the fixed operands (dq: Q and dO; dk/dv: K and
# V) in shared memory: none where each warp keeps its own in registers (d =
# 64: both fp32, split at each use; d = 128: the pair's warp its one, split
# once), two at d = 256 (fp32, split at each use)
FP32_FIXED_TILES = {64: 0, 128: 0, 256: 2}
# the fp32 forwards at d = 128 and 256 (`csrc/fp32_forward.cuh` forward_sets):
# eight warps in FP32_SETS sets of four that share a block's 64 rows and walk
# alternate key tiles of FP32_SET_KEYS[d] keys, one stage a set, split once;
# Q's rows in shared memory, split once there at d = 128 (FP32_Q_SPLIT)
FP32_SETS = 2
FP32_SET_KEYS = {128: 32, 256: 16}
FP32_Q_SPLIT = {128: True, 256: False}
# the fp32 dq and dk/dv kernels at d = 128 and 256 (`csrc/train_attention_fp32.cu`):
# eight warps, FP32_WIDE_THREADS threads, in four pairs of 16 rows, one block
# an SM; streamed tiles of FP32_PAIR_TILES[d] rows (dq's keys, dk/dv's
# queries) split once a block; dq's pair computes S and dP and trades them,
# each warp then holding half of dQ's columns; dk/dv's splits by output
# (warps 0-3 dV, 4-7 dK)
FP32_PAIR_TILES = {128: (32, 16), 256: (16, 16)}
FP32_WIDE_THREADS = 256


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on an int64 tensor of 32-bit values."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def fmix32_int(h: int) -> int:
    """:func:`fmix32` of one Python integer (mod 2^32)."""
    h &= M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def keep_threshold(keep: float) -> int:
    """The keep bit's uint32 threshold, computed as the JAX package does (a
    double product, truncated): ``min(int(keep * 2^32), 2^32 - 1)``."""
    return min(int(keep * 2**32), 2**32 - 1)


def attention_seed(key_words) -> int:
    """The kernel seed from a dropout key's two 32-bit words, as
    `train_attention.py:434-440` derives it from ``jax.random.key_data``:
    ``fmix32(w0) ^ fmix32(w1 + 0x9E3779B9)``."""
    w0, w1 = (int(w) & M32 for w in key_words)
    return fmix32_int(w0) ^ fmix32_int(w1 + 0x9E3779B9)


def dropout_keep_mask(seed: int, b_idx: int, h_idx: int, q0: int, k0: int, bq: int,
                      bk: int, n: int, keep: float, device=None) -> torch.Tensor:
    """Boolean keep mask ``[bq, bk]`` for the absolute positions
    ``(q0 + i, k0 + j)`` of head ``(b_idx, h_idx)`` (`train_attention.py:57-75`)."""
    qpos = q0 + torch.arange(bq, dtype=torch.int64, device=device)
    kpos = k0 + torch.arange(bk, dtype=torch.int64, device=device)
    ctr = (qpos[:, None] * n + kpos[None, :]) & M32
    salt = (int(seed) * 0x9E3779B9 + int(b_idx) * 0x7FEB352D
            + int(h_idx) * 0x846CA68B) & M32
    return fmix32(ctr ^ salt) < keep_threshold(keep)


def train_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              lens: torch.Tensor | None = None, dropout_rate: float = 0.0,
                              seed: int = 0, batch_offset: int = 0,
                              head_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version (dense: materialises the ``[b, h, n, n]`` fp32
    logits and the keep mask), differentiable by autograd. Mirrors the JAX
    package's ``dense_reference`` plus key masking by ``lens [b]``.
    ``batch_offset`` / ``head_offset`` are the batch and head index of
    ``q[0]``'s head 0 in the dropout salt, so that a slice of a batch (data
    parallel) or of the heads (tensor parallel) gets the masks it has in the
    whole.

    P is rounded to v's dtype for the PV product, as the kernels round it,
    while its gradient passes that rounding in fp32, as the kernels' backward
    keeps dP in fp32 (an autograd cast would round dP to v's dtype)."""
    b, n, h, d = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    if lens is not None:
        valid = torch.arange(n, device=q.device)[None, :] < lens[:, None]
        s = torch.where(valid[:, None, None, :], s, torch.tensor(_NEG, device=q.device))
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        keep = 1.0 - dropout_rate
        km = torch.stack([torch.stack([dropout_keep_mask(seed, batch_offset + bi,
                                                         head_offset + hi, 0, 0,
                                                         n, n, n, keep, q.device)
                                       for hi in range(h)]) for bi in range(b)])
        p = torch.where(km, p * (1.0 / keep), torch.tensor(0.0, device=q.device))
    p = p + (p.to(v.dtype).float() - p).detach()
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _rows_cover(n: int, rows: int) -> list:
    """Per block along n, the ``(first row, rows)`` of each of its warpgroups:
    rows go out in units of ``TILE``, so the last block has only the
    warpgroups whose rows lie inside the sample and no tile hangs over its
    end."""
    return [[(r, TILE) for r in range(i * rows, min((i + 1) * rows, n), TILE)]
            for i in range(-(-n // rows))]


def _check_head_dim(d: int, dims: tuple[int, ...] = KERNEL_HEAD_DIMS) -> None:
    if d not in dims:
        raise ValueError(f"the attention kernels are built for head dims {dims}, got {d}")


def _rows_map(b: int, n: int, h: int, d: int = HEAD_DIM) -> dict:
    """The TMA map of a ``[b, n, h, d]`` bf16 tensor, innermost dimension
    first: ``dims`` in elements, ``strides`` in bytes (of all but the
    innermost), ``box`` the ``[TILE, 64]`` panel one load brings (a 128-byte
    row: the widest the 128-byte swizzle takes) and ``panels`` the column of
    each load of a ``[TILE, d]`` tile, whose panels lie one after the other
    in shared memory. n is a dimension of its own, apart from b, so rows past
    n read as zeros, never as the next sample's."""
    return dict(dims=(d, h, n, b), strides=(d * 2, h * d * 2, n * h * d * 2),
                box=(PANEL, 1, TILE, 1), panels=tuple(range(0, d, PANEL)))


def forward_geometry(b: int, n: int, h: int, d: int = HEAD_DIM) -> dict:
    """How the forward core covers ``[b, n, h, d]`` (the training forward and
    the serving attention alike), in :func:`backward_geometry`'s terms:
    ``ceil(n / rows)`` blocks a (sample, head) with ``rows`` from
    ``FWD_SHAPES`` (192 at d = 64, 128 at d = 128 and 256); the block's Q
    tiles (one a consumer warpgroup, ``[tile, d]``), a ring of ``stages``
    stages (four; three at d = 128, two at d = 256) of a K and a V tile of
    ``key_tile`` keys (64; 128 at d = 128, each of its panels 128 rows, two
    TMA boxes), and five barriers a stage (a full and an empty one for its K
    tile and for its V tile apart, and K's rotated one) plus two for Q (1024
    bytes of alignment slack in front). ``registers``: the producer warpgroup's and
    each consumer's ``setmaxnreg`` counts; ``overlap``: the consumers'
    schedule without rotary (``FWD_OVERLAP``); the key tiles a sample walks:
    :func:`forward_key_tiles`."""
    _check_head_dim(d)
    rows, producer, consumer, stages, keys = FWD_SHAPES[d]
    tile_bytes = TILE * d * 2
    shared = (1024 + (rows // TILE) * tile_bytes + stages * 2 * keys * d * 2
              + (5 * stages + 2) * 8)
    return dict(grid=(-(-n // rows), h, b), threads=128 * (rows // TILE + 1), rows=rows,
                tile=TILE, key_tile=keys, stages=stages, shared_bytes=shared,
                registers=(producer, consumer), overlap=FWD_OVERLAP[d],
                warpgroups=_rows_cover(n, rows), tensor_map=_rows_map(b, n, h, d))


def forward_key_tiles(n: int, length: int, d: int) -> list[tuple[int, int, bool]]:
    """The key tiles the forward core walks for a sample of ``length``
    valid keys (<= 0: none, every key below n averaged), as ``(first key,
    keys, masked)``: tiles of ``FWD_SHAPES[d]``'s key tile up to the last
    that holds a key that counts (the valid ones, or every key below n when
    none is valid), the last perhaps hanging over n (TMA reads zero rows
    there). Only the last is ``masked``: its softmax gives the keys at or
    past that limit the logit -1e30 and the weight 0. A sample with no valid
    key takes its logits at scale 0: every weight 1, the LSE log n."""
    keys = FWD_SHAPES[d][4]
    lim = min(length, n) if length > 0 else n
    count = -(-lim // keys)
    return [(i * keys, keys, i == count - 1) for i in range(count)]


def swizzled_offset(row: int, col: int, d: int = HEAD_DIM) -> int:
    """Byte offset of bf16 element ``(row, col)`` in a ``[TILE, d]`` tile as
    TMA writes it with the 128-byte swizzle, one ``[TILE, 64]`` panel of
    8192 bytes after the other (columns ``64 p ..`` in panel ``p``): the
    16-byte chunk ``c`` of a panel's row lands at chunk ``c ^ (row % 8)`` of
    that row (the mirror of ``swizzled_chunk_offset`` in
    `csrc/wgmma_tile.cuh`). The serving attention rotates a tile in place
    through this map: an interleaved pair (columns 2 i, 2 i + 1) is 4 bytes
    and never leaves its chunk."""
    panel, col = divmod(col, PANEL)
    assert panel < d // PANEL, (col, d)
    return (panel * TILE * PANEL * 2 + row * 128 + (((col // 8) ^ (row % 8)) << 4)
            + (col % 8) * 2)


def rotator_chunks(rid: int, d: int = HEAD_DIM) -> list[tuple[int, int]]:
    """The ``(row, chunk)`` pairs of a ``[TILE, d]`` tile that rotating
    thread ``rid`` of ``FWD_ROTATORS`` takes (`csrc/flash_forward.cuh`
    ``rotate_tile``): chunk index ``rid + 96 j`` of the ``TILE * d / 8``
    chunks, row by row, whose eight cos / sin entries lie at offset
    ``8 * index`` of the tile's ``[64, d]`` table rows."""
    per_row = d // 8
    return [(ci // per_row, ci % per_row) for ci in range(rid, TILE * per_row, FWD_ROTATORS)]


FORWARD_BUILT = ("rows", "stages", "threads", "shared_bytes", "key_tile", "overlap")


def kernel_forward_geometry(d: int = HEAD_DIM) -> dict:
    """The constants the built forward kernels report for head dim ``d``
    (needs the card's build; ``FORWARD_BUILT``): they must equal
    :func:`forward_geometry`'s."""
    return _kernel_geometry("erax_flash_forward_geometry", d, FORWARD_BUILT)


def backward_geometry(b: int, n: int, h: int, d: int = HEAD_DIM) -> dict:
    """How the dq and dk/dv kernels cover ``[b, n, h, d]`` (both alike; dq
    over query rows, dk/dv over keys):

    - ``grid``: ``ceil(n / rows)`` blocks a (sample, head), ``h``, ``b``,
      with ``rows`` from ``BWD_SHAPES`` (128; 64 at d = 256);
    - ``warpgroups``: per block along n, the ``(first row, rows)`` each of
      its warpgroups owns. Rows go out in units of ``TILE``: for
      ``n % 128 == 64`` the last block has one warpgroup, and no tile hangs
      over the end of a sample. At d = 256 both warpgroups own the block's
      64 rows, each the ``columns`` (first, count) of its part of the head:
      the score tiles are computed by both;
    - ``stages`` and ``shared_bytes``: the ring's depth and the dynamic
      shared memory of a block (1024 bytes of alignment slack, the block's
      own tiles (two a 64 rows), the ring, 64 LSE + 64 D values a stage, the
      barriers);
    - ``tensor_map``: the TMA map of each of q, k, v, dO, innermost
      dimension first: ``dims`` in elements, ``strides`` in bytes (of all but
      the innermost), ``box`` the panel one load brings and ``panels`` the
      column of each (:func:`_rows_map`). n is a dimension of its own, apart
      from b, so rows past n read as zeros, never as the next sample's;
    - ``registers``: the producer warpgroup's and each consumer's
      ``setmaxnreg`` counts (at d = 128 dk/dv's two ``[64, 128]``
      accumulators are 128 of a consumer's 232)."""
    _check_head_dim(d)
    rows, stages, parts = BWD_SHAPES[d]
    tile_bytes = TILE * d * 2
    shared = (1024 + 2 * (rows // TILE) * tile_bytes
              + stages * (2 * tile_bytes + 2 * TILE * 4) + (2 * stages + 1) * 8)
    cover = _rows_cover(n, rows)
    width = d // parts
    return dict(grid=(-(-n // rows), h, b), threads=BWD_THREADS, rows=rows, tile=TILE,
                stages=stages, shared_bytes=shared, registers=BWD_REGISTERS,
                warpgroups=[[wg for wg in block for _ in range(parts)] for block in cover],
                columns=[(width * p, width) for p in range(parts)],
                tensor_map=_rows_map(b, n, h, d))


def _kernel_geometry(entry: str, d: int,
                     names: tuple[str, ...] = ("rows", "stages", "threads", "shared_bytes")
                     ) -> dict:
    """The constants a built kernel's geometry entry point writes for head
    dim ``d``, by name; an entry point refuses (returns non-zero for) a head
    dim it has no instantiation of."""
    import ctypes

    from eraxvif5tts_tpu_torch.ops import _cuda

    out = (ctypes.c_int * len(names))()
    if getattr(_cuda.kernels().lib, entry)(d, out) != 0:
        raise ValueError(f"{entry}: no kernel built for head dim {d}")
    return dict(zip(names, out))


def kernel_backward_geometry(d: int = HEAD_DIM) -> dict:
    """The constants the built backward kernels report for head dim ``d``
    (needs the card's build): they must equal :func:`backward_geometry`'s."""
    return _kernel_geometry("erax_train_attention_bwd_geometry", d)


def _fp32_geometry(b: int, n: int, h: int, d: int, dims: tuple[int, ...],
                   sets: int = 1) -> dict:
    _check_head_dim(d, dims)
    threads = sets * FP32_THREADS
    return dict(grid=(n // FP32_ROWS, h, b), threads=threads, rows=FP32_ROWS, tile=TILE,
                warps=threads // 32, stages=FP32_STAGES, stride=d + 4,
                blocks=[(r, FP32_ROWS) for r in range(0, n, FP32_ROWS)])


def _per_sm(shared: int) -> int:
    """Blocks an SM that ``shared`` dynamic bytes a block allow."""
    return SM_SHARED // (shared + 1024)


def forward_geometry_fp32(b: int, n: int, h: int, d: int = HEAD_DIM) -> dict:
    """How the fp32 forward covers ``[b, n, h, d]`` (kernel 4a's fp32 mode
    and kernel 1's alike, kernel 6's fp32 roles at d = 256): ``n / 64``
    blocks a (sample, head), each owning the 64 query rows of ``blocks``.

    At d = 64 (`csrc/fp32_forward.cuh` ``forward_core``): four warps of 16
    rows that keep their Q rows split in registers; the block walks key
    tiles of 64 (``key_tile``) that a ring of ``stages`` stages of padded
    ``[64, d]`` fp32 tiles (``stride`` = d + 4 floats a row) brings, split
    into TF32 big parts in place and small parts in two more tiles; two
    blocks an SM.

    At d = 128 and 256 (``forward_sets``): ``sets`` = 2 sets of four warps
    (``threads`` 256, eight warps an SM), warp w of each set owning rows 16 w
    .. 16 w + 15; set s walks key tiles s, s + 2, ... of ``key_tile`` keys
    (32 at d = 128, 16 at 256), each through one stage of its own
    (``stages`` = 1 a set): a K and a V tile, split once into big and small
    parts by the set's own threads. Q's 64 rows take one padded tile of
    shared memory, split once into a second at d = 128 (``q_split``); at
    d = 256 it stays fp32 and the warps split its A fragments at each use.
    The sets' (m, l, O) merge at the end in the ring's room. One block an
    SM. ``blocks_per_sm`` is what shared memory allows, and what the
    kernels' launch bounds ask of the registers."""
    if d == 64:
        tile = FP32_ROWS * (d + 4) * 4
        shared = (FP32_STAGES * 2 + 2) * tile
        return dict(_fp32_geometry(b, n, h, d, HEAD_DIMS), shared_bytes=shared,
                    blocks_per_sm=_per_sm(shared), key_tile=TILE, sets=1, q_split=True)
    _check_head_dim(d)
    row = (d + 4) * 4
    keys = FP32_SET_KEYS[d]
    q_tiles = 2 if FP32_Q_SPLIT[d] else 1
    shared = q_tiles * FP32_ROWS * row + FP32_SETS * 4 * keys * row
    return dict(_fp32_geometry(b, n, h, d, KERNEL_HEAD_DIMS, FP32_SETS), stages=1,
                shared_bytes=shared, blocks_per_sm=_per_sm(shared), key_tile=keys,
                sets=FP32_SETS, q_split=FP32_Q_SPLIT[d])


def set_key_tiles(n: int, length: int, d: int) -> list[list[int]]:
    """The key tiles each set of the fp32 forward at d = 128 or 256 walks for
    a sample of ``length`` valid keys (<= 0: none, every key averaged):
    the tiles of ``FP32_SET_KEYS[d]`` keys that hold a valid key, set s
    taking tiles s, s + 2, ... (``forward_sets``' loop)."""
    keys = FP32_SET_KEYS[d]
    tiles = n // keys if length <= 0 else -(-min(length, n) // keys)
    return [list(range(s, tiles, FP32_SETS)) for s in range(FP32_SETS)]


def backward_geometry_fp32(b: int, n: int, h: int, d: int = HEAD_DIM) -> dict:
    """How the fp32 dq and dk/dv kernels cover ``[b, n, h, d]`` (dq over
    query rows, dk/dv over keys; both ``n / 64`` blocks a (sample, head) of
    64 rows, in groups of 16 rows a warp): the fixed operands (dq's Q and dO,
    dk/dv's K and V) stay in registers at d = 64 and 128 and in two padded
    fp32 tiles of shared memory at d = 256 (``fixed_tiles``,
    ``FP32_FIXED_TILES``); the streamed ones (dq's K and V; dk/dv's Q and dO,
    with that query tile's LSE and D values at d = 64) come as padded
    ``[dq_tile, d]`` and ``[dkv_tile, d]`` fp32 tiles through a ring of
    ``bwd_stages`` stages (``FP32_BWD_STAGES``), split into TF32 big and
    small parts once a block. ``dq_warps`` and ``dkv_warps``: each warp's
    first row, and what it holds (dq: its first column of dQ and how many;
    dk/dv: dK, dV or both).

    At d = 64: four warps of 16 rows, 64-row tiles, each warp all of its
    rows' outputs, split in place (small parts beside). At d = 128 and 256
    eight warps (``FP32_WIDE_THREADS``) in four pairs of 16 rows, one block
    an SM (its launch bounds), tiles of ``FP32_PAIR_TILES[d]`` rows (dq's,
    dk/dv's), each tile's streamed operands coming raw (unpadded) into a room
    of their own, ``dq_raw_bytes`` / ``dkv_raw_bytes``, under the work of the
    tile before, and split from there. In dq warp w < 4 computes S = Q K^T
    and w + 4 dP = dO V^T for the same rows; they trade halves of them and
    their halves of dS through ``score_slot_bytes`` of shared memory and
    hold dQ's columns 0 .. d / 2 - 1 and d / 2 .. d - 1. In dk/dv warp w < 4
    holds dV and w + 4 dK of the same 16 keys, the first handing P to the
    second through ``p_slot_bytes``; the tile's LSE and D are read from
    global memory. At one stage (d = 256) the slots lie in room a tile no
    longer needs (dq's in V's parts, dk/dv's in the raw room); at two (d =
    128) in a room of their own (``own_slots``). ``blocks_per_sm`` as
    :func:`forward_geometry_fp32`'s."""
    geo = _fp32_geometry(b, n, h, d, KERNEL_HEAD_DIMS)
    tile = FP32_ROWS * (d + 4) * 4
    stages, fixed = FP32_BWD_STAGES[d], FP32_FIXED_TILES[d]
    extra = {}
    if d in FP32_PAIR_TILES:
        (dq_rows, dkv_rows), threads, half = FP32_PAIR_TILES[d], FP32_WIDE_THREADS, d // 2
        own = stages == 2
        extra = dict(dq_raw_bytes=2 * dq_rows * d * 4, dkv_raw_bytes=2 * dkv_rows * d * 4,
                     own_slots=own, score_slot_bytes=4 * 2 * 16 * dq_rows * 4,
                     p_slot_bytes=4 * 16 * dkv_rows * 4)

        def ring(rows: int) -> int:
            # the fixed tiles, the stages of two streamed tiles' big and small
            # parts (padded [rows, d] each) and the raw room
            return fixed * tile + stages * 4 * rows * (d + 4) * 4 + 2 * rows * d * 4

        dq_shared = ring(dq_rows) + own * extra["score_slot_bytes"]
        dkv_shared = ring(dkv_rows) + own * extra["p_slot_bytes"]
        dq_warps = [(16 * (w % 4), half * (w // 4), half) for w in range(threads // 32)]
        dkv_warps = [(16 * (w % 4), ("dV",) if w < 4 else ("dK",)) for w in range(threads // 32)]
        per_sm = 1  # launch bounds (256, 1): eight warps of up to 255 registers fill the SM
    else:
        dq_rows = dkv_rows = TILE
        threads = FP32_THREADS
        dq_shared = (stages * 2 + 2) * tile
        dkv_shared = stages * (2 * tile + 2 * FP32_ROWS * 4) + 2 * tile
        dq_warps = [(16 * w, 0, d) for w in range(threads // 32)]
        dkv_warps = [(16 * w, ("dK", "dV")) for w in range(threads // 32)]
        per_sm = min(_per_sm(dq_shared), _per_sm(dkv_shared))
    return dict(geo, bwd_stages=stages, dq_tile=dq_rows, dkv_tile=dkv_rows, fixed_tiles=fixed,
                dq_threads=threads, dkv_threads=threads, dq_warps=dq_warps,
                dkv_warps=dkv_warps, dq_shared_bytes=dq_shared, dkv_shared_bytes=dkv_shared,
                blocks_per_sm=per_sm, **extra)


FP32_FORWARD_BUILT = ("rows", "threads", "stages", "shared_bytes", "sets", "key_tile")
FP32_BACKWARD_BUILT = ("bwd_rows", "dq_threads", "dkv_threads", "bwd_stages", "dq_tile", "dkv_tile",
                       "dq_shared_bytes", "dkv_shared_bytes")


def kernel_geometry_fp32(d: int = HEAD_DIM) -> dict:
    """The constants the built fp32 kernels report for head dim ``d`` (needs
    the card's build): the forward's ``rows``, ``threads``, ``stages``,
    ``shared_bytes``, ``sets`` and ``key_tile`` must equal
    :func:`forward_geometry_fp32`'s, the ``bwd_``
    ones :func:`backward_geometry_fp32`'s (``bwd_rows`` its ``rows``)."""
    return _kernel_geometry("erax_train_attention_fp32_geometry", d,
                            FP32_FORWARD_BUILT + FP32_BACKWARD_BUILT)


def _check_cuda_args(q, k, v, lens) -> None:
    if not (q.shape == k.shape == v.shape) or q.ndim != 4:
        raise ValueError(f"train_attention: q, k, v must share one [b, n, h, d] shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _LAUNCHERS:
        raise TypeError(f"train_attention: q must be bfloat16 or float32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"train_attention: {name} is {t.dtype}, q {q.dtype}: q, k and v "
                            "must share one dtype, bfloat16 or float32")
        if t.device != q.device:
            raise ValueError(f"train_attention: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"train_attention: {name} must be contiguous and 16-byte aligned")
    b, n, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"train_attention: the kernels take head dims {KERNEL_HEAD_DIMS}, got {d}")
    if n % TILE or not 0 < n <= MAX_N:
        raise ValueError(f"train_attention: n must be a multiple of {TILE} in "
                         f"[{TILE}, {MAX_N}], got {n}")
    if lens.shape != (b,) or lens.device != q.device or lens.dtype.is_floating_point:
        raise ValueError(f"train_attention: lens must be an integer [b] tensor on {q.device}, "
                         f"got {lens.dtype} {tuple(lens.shape)} on {lens.device}")


def _dropout_args(dropout_rate: float, seed: int, batch_offset: int = 0,
                  head_offset: int = 0) -> tuple[int, int, float, int, int, int]:
    """(seed, threshold, inv_keep, on, batch offset, head offset) for the
    kernels' C interface."""
    if dropout_rate <= 0.0:
        return 0, 0, 1.0, 0, 0, 0
    keep = 1.0 - dropout_rate
    return (int(seed) & M32, keep_threshold(keep), 1.0 / keep, 1, int(batch_offset) & M32,
            int(head_offset) & M32)


def _entry_dtype(entry: str, dtype: torch.dtype, *tensors) -> None:
    """A launcher reads its tensors as ``dtype``: refuse any other."""
    if any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{entry} takes {dtype} q, k, v, got "
                        f"{', '.join(str(t.dtype) for t in tensors)}")


def _forward(entry: str, dtype: torch.dtype, q, k, v, lens, dropout_rate: float,
             seed: int, offsets: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    from eraxvif5tts_tpu_torch.ops import _cuda

    _entry_dtype(entry, dtype, q, k, v)
    b, n, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = getattr(_cuda.kernels().lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, n, h, d, 1.0 / math.sqrt(d),
            *_dropout_args(dropout_rate, seed, *offsets),
            _cuda.stream_ptr(q.device))
    _cuda.check(code, entry)
    return out, lse


def flash_forward(q, k, v, lens, dropout_rate: float = 0.0, seed: int = 0,
                  offsets: tuple[int, int] = (0, 0)) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the bf16 forward kernel on checked CUDA arguments: (O ``[b, n,
    h, d]`` bf16, LSE ``[b, h, n]`` fp32). ``offsets``: the global (sample,
    head) of ``q[0]``'s head 0 in the keep bit's salt (a rank's slice of a
    batch or of the heads). Counted in ``flash_forward.launches``."""
    from eraxvif5tts_tpu_torch.ops import _cuda

    result = _forward("erax_train_attention_fwd", torch.bfloat16, q, k, v, lens,
                      dropout_rate, seed, offsets)
    _cuda.count(flash_forward, "launches", ("launches_by_head_dim", q.shape[-1]))
    return result


def flash_forward_fp32(q, k, v, lens, dropout_rate: float = 0.0, seed: int = 0,
                       offsets: tuple[int, int] = (0, 0)) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the fp32 forward kernel: (O ``[b, n, h, d]`` fp32, LSE ``[b, h,
    n]`` fp32). Counted in ``flash_forward_fp32.launches``."""
    from eraxvif5tts_tpu_torch.ops import _cuda

    result = _forward("erax_train_attention_fp32_fwd", torch.float32, q, k, v, lens,
                      dropout_rate, seed, offsets)
    _cuda.count(flash_forward_fp32, "launches", ("launches_by_head_dim", q.shape[-1]))
    return result


def _check_backward_args(dout, lse, dd, dtype: torch.dtype = torch.bfloat16) -> None:
    """The backward kernels read dO (in q's ``dtype``), LSE and D (fp32) by
    TMA, bulk copies (bf16) or 16-byte copies (fp32: `cp.async`)."""
    for name, t, want in (("dout", dout, dtype), ("lse", lse, torch.float32),
                          ("dd", dd, torch.float32)):
        if t.dtype != want or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"train_attention backward: {name} must be {want}, contiguous "
                             "and 16-byte aligned")


def _dq(entry: str, dtype: torch.dtype, q, k, v, lens, lse, dd, dout,
        dropout_rate: float, seed: int, offsets: tuple[int, int]) -> torch.Tensor:
    from eraxvif5tts_tpu_torch.ops import _cuda

    _entry_dtype(entry, dtype, q, k, v)
    b, n, h, d = q.shape
    _check_backward_args(dout, lse, dd, q.dtype)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = getattr(_cuda.kernels().lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), lens.data_ptr(), dq.data_ptr(), b, n, h, d, 1.0 / math.sqrt(d),
            *_dropout_args(dropout_rate, seed, *offsets), _cuda.stream_ptr(q.device))
    _cuda.check(code, entry)
    return dq


def _dkv(entry: str, dtype: torch.dtype, q, k, v, lens, lse, dd, dout,
         dropout_rate: float, seed: int,
         offsets: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    from eraxvif5tts_tpu_torch.ops import _cuda

    _entry_dtype(entry, dtype, q, k, v)
    b, n, h, d = q.shape
    _check_backward_args(dout, lse, dd, q.dtype)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        code = getattr(_cuda.kernels().lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), lens.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, h, d,
            1.0 / math.sqrt(d), *_dropout_args(dropout_rate, seed, *offsets),
            _cuda.stream_ptr(q.device))
    _cuda.check(code, entry)
    return dk, dv


def flash_dq(q, k, v, lens, lse, dd, dout, dropout_rate: float = 0.0,
             seed: int = 0, offsets: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Launch the bf16 dq kernel: dq ``[b, n, h, d]`` bf16 from the forward's
    LSE, ``dd = rowsum(dO * O)`` ``[b, h, n]`` fp32 and ``dout``; ``offsets``
    as :func:`flash_forward`'s. Counted in ``flash_dq.launches``."""
    from eraxvif5tts_tpu_torch.ops import _cuda

    dq = _dq("erax_train_attention_dq", torch.bfloat16, q, k, v, lens, lse, dd, dout,
             dropout_rate, seed, offsets)
    _cuda.count(flash_dq, "launches", ("launches_by_head_dim", q.shape[-1]))
    return dq


def flash_dkv(q, k, v, lens, lse, dd, dout, dropout_rate: float = 0.0, seed: int = 0,
              offsets: tuple[int, int] = (0, 0)) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the bf16 dk/dv kernel (arguments as :func:`flash_dq`). Counted
    in ``flash_dkv.launches``."""
    from eraxvif5tts_tpu_torch.ops import _cuda

    result = _dkv("erax_train_attention_dkv", torch.bfloat16, q, k, v, lens, lse, dd, dout,
                  dropout_rate, seed, offsets)
    _cuda.count(flash_dkv, "launches", ("launches_by_head_dim", q.shape[-1]))
    return result


def flash_dq_fp32(q, k, v, lens, lse, dd, dout, dropout_rate: float = 0.0,
                  seed: int = 0, offsets: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Launch the fp32 dq kernel (arguments as :func:`flash_dq`, all fp32).
    Counted in ``flash_dq_fp32.launches``."""
    from eraxvif5tts_tpu_torch.ops import _cuda

    dq = _dq("erax_train_attention_fp32_dq", torch.float32, q, k, v, lens, lse, dd, dout,
             dropout_rate, seed, offsets)
    _cuda.count(flash_dq_fp32, "launches", ("launches_by_head_dim", q.shape[-1]))
    return dq


def flash_dkv_fp32(q, k, v, lens, lse, dd, dout, dropout_rate: float = 0.0, seed: int = 0,
                   offsets: tuple[int, int] = (0, 0)) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the fp32 dk/dv kernel (arguments as :func:`flash_dq`, all
    fp32). Counted in ``flash_dkv_fp32.launches``."""
    from eraxvif5tts_tpu_torch.ops import _cuda

    result = _dkv("erax_train_attention_fp32_dkv", torch.float32, q, k, v, lens, lse, dd,
                  dout, dropout_rate, seed, offsets)
    _cuda.count(flash_dkv_fp32, "launches", ("launches_by_head_dim", q.shape[-1]))
    return result


# each launcher's count, and the same by head dim (which instantiation ran)
for _launcher in (flash_forward, flash_dq, flash_dkv, flash_forward_fp32, flash_dq_fp32,
                  flash_dkv_fp32):
    _launcher.launches = 0
    _launcher.launches_by_head_dim = dict.fromkeys(KERNEL_HEAD_DIMS, 0)
del _launcher
# the forward, dq and dk/dv launchers of q's dtype
_LAUNCHERS = {torch.bfloat16: (flash_forward, flash_dq, flash_dkv),
              torch.float32: (flash_forward_fp32, flash_dq_fp32, flash_dkv_fp32)}


def row_dot(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in fp32, ``[b, h, n]`` like the LSE (plain torch, as
    the JAX package leaves it to XLA, `train_attention.py:328`)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class _TrainAttention(torch.autograd.Function):
    """Forward kernel; backward = D in plain torch, then the dq and dk/dv
    kernels (the JAX custom_vjp, `train_attention.py:261-390`), the bf16 or
    the fp32 ones by q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, lens, dropout_rate, seed, offsets):
        out, lse = _LAUNCHERS[q.dtype][0](q, k, v, lens, dropout_rate, seed, offsets)
        ctx.save_for_backward(q, k, v, lens, out, lse)
        ctx.dropout = (dropout_rate, seed, offsets)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lens, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.data_ptr() % 16:  # TMA reads it: 16-byte aligned like q, k, v
            dout = dout.clone()
        dd = row_dot(dout, out)
        _, dq_kernel, dkv_kernel = _LAUNCHERS[q.dtype]
        dq = dq_kernel(q, k, v, lens, lse, dd, dout, *ctx.dropout)
        dk, dv = dkv_kernel(q, k, v, lens, lse, dd, dout, *ctx.dropout)
        return dq, dk, dv, None, None, None, None


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: torch.Tensor | None = None, dropout_rate: float = 0.0,
                    seed: int = 0, batch_offset: int = 0, head_offset: int = 0) -> torch.Tensor:
    """Differentiable softmax attention ``[b, n, h, d] -> [b, n, h, d]`` with
    position-hash attention dropout. ``key_valid [b, n]`` must be a
    contiguous prefix mask; ``seed`` is the kernel seed
    (:func:`attention_seed` of the dropout key's words); ``batch_offset`` /
    ``head_offset`` the global sample and head of ``q``'s first (a rank's
    slice of the batch or of the heads keeps the bits of the whole).

    CPU tensors take :func:`train_attention_reference`; CUDA tensors run the
    kernels of their dtype (bf16: :func:`flash_forward`, then :func:`flash_dq`
    and :func:`flash_dkv` in the backward; fp32: the ``_fp32`` launchers) or
    raise. Setting
    ``train_attention.plain = True`` sends every call to the plain version,
    on any device: a whole model's kernels can then be compared with it."""
    b, n = q.shape[:2]
    lens = None if key_valid is None else key_valid.sum(dim=-1, dtype=torch.int32)
    if q.device.type == "cpu" or train_attention.plain:
        return train_attention_reference(q, k, v, lens, dropout_rate, seed, batch_offset,
                                         head_offset)
    if q.device.type != "cuda":
        raise ValueError(f"train_attention: unsupported device {q.device}")
    if lens is None:
        lens = torch.full((b,), n, dtype=torch.int32, device=q.device)
    _check_cuda_args(q, k, v, lens)
    return _TrainAttention.apply(q, k, v, lens.contiguous(), dropout_rate, seed,
                                 (batch_offset, head_offset))


train_attention.plain = False
