"""Masked softmax attention with fused rotary: the serving loop's attention.

Port of `eraxvif5tts_tpu/ops/serving_attention.py` (`serving_attention`, whose
Pallas body is `_headloop_kernel`). :func:`serving_attention` launches a CUDA
kernel for CUDA tensors, chosen by the inputs' dtype, and runs
:func:`serving_attention_reference`, the plain PyTorch version of the same
semantics, for CPU tensors:

- rotary (``rope [n, d]`` angles, interleaved pairs) on q and k in fp32, cast
  back to the input dtype before QK^T;
- logits and softmax in fp32, keys at positions ``>= lens[b]`` set to the
  finite -1e30 (a sample with ``lens = 0`` averages every key, never NaN);
- P cast to v's dtype, PV accumulated in fp32, output in q's dtype.

Kernel domain: bf16 or fp32 (q, k and v of one dtype), contiguous and
16-byte aligned ``[b, n, h, d]`` with d in ``HEAD_DIMS`` (64 or 128, the
JAX package's Pallas domain) or, without rotary, ``LIBRARY_HEAD_DIM`` (256:
the serving role of the JAX package's library flash kernel, kernel 6, which
it runs on q and k rotated outside it), ``n % 64 == 0``,
``64 <= n <= 6144``.
The bound is the longest sequence a served model gives it: the MMDiT's
joint text + mel sequence at the largest text and duration buckets
(2048 + 4096); the DiT and the UNetT stop at 4096. Anything else on a CUDA
tensor raises; there is no fallback.

- bf16: `csrc/serving_attention.cu`, the forward core of
  `csrc/flash_forward.cuh` (`ops/train_attention.py` ``forward_geometry``
  states its launch for each d: 192 query rows a block at d = 64, 128 at
  d = 128 and 256, a ``[64, d]`` tile being d / 64 128-byte-swizzled
  panels, K and V tiles of 128 keys at d = 128 and 64 elsewhere) on
  ``wgmma`` and TMA. Nothing in it depends on n beyond
  its tiles: the K / V ring's shared memory is fixed, the grid and the
  tensor map's dimensions grow with n and row offsets are 64-bit. Its online
  softmax rounds the unnormalised P to bf16 where the TPU kernel rounds the
  normalised P: the two agree to bf16 rounding of the output (the card-side
  check in `chip_smoke.py` states its tolerance).
- fp32 (the JAX package's default serving dtype):
  `csrc/serving_attention_fp32.cu`, the fp32 forward core of
  `csrc/fp32_forward.cuh`, which kernel 4a's fp32 mode shares
  (:func:`forward_geometry_fp32` states its launch): every product on the
  tensor cores, ``mma.sync`` TF32 in 3xTF32 (each operand split into two
  TF32 parts, three products each, a fresh accumulator a key tile), 64
  query rows a block: at d = 64 four warps, two blocks an SM, over key
  tiles of 64 that a ``cp.async`` ring brings; at d = 128 and 256 eight
  warps in two sets that walk alternate key tiles (32 and 16 keys) and
  merge their softmax states at the end, one block an SM, Q in shared
  memory; K and V split once a block; an online softmax with ``expf``. It keeps fp32's accuracy whatever
  torch's TF32 flags say, and agrees with the plain version to the
  reordering of fp32 sums.

Both read fp32 cos / sin tables ``[n, d]``, which :func:`rope_tables` makes
once per angle table, whatever d is, and keeps, so a call in the Euler loop
does no host work for them (nor for the ``lens=None`` vector). Several threads may call it at once
(the HTTP server runs up to four generations on one wrapper): the two caches
change under a lock, the launch counters through ``_cuda.count``. A call
under CUDA graph capture must find its tables and lengths cached already (the
wrapper runs each step once before it captures it): the graph keeps the
cached tensors it reads (``_cuda.hold``).
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict

import torch

from eraxvif5tts_tpu_torch.ops import train_attention
from eraxvif5tts_tpu_torch.ops.rotary import rotate_half

_NEG = -1e30
MAX_N = train_attention.MAX_N  # the MMDiT's longest joint sequence, kernel 4's bound too
TILE = 64
HEAD_DIMS = train_attention.HEAD_DIMS  # the head dims of every mode, fused rotary included
LIBRARY_HEAD_DIM = train_attention.LIBRARY_HEAD_DIM  # without rotary only (kernel 6's)
KERNEL_HEAD_DIMS = train_attention.KERNEL_HEAD_DIMS
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _rotate(x: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotary of ``x [b, n, h, d]`` in fp32, back to x.dtype."""
    x32 = x.float()
    cos = rope.cos().float()[None, :, None, :]
    sin = rope.sin().float()[None, :, None, :]
    return (x32 * cos + rotate_half(x32) * sin).to(x.dtype)


def serving_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                lens: torch.Tensor | None = None,
                                rope: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's semantics (materialises the
    ``[b, h, n, n]`` fp32 logits)."""
    b, n, h, d = q.shape
    if rope is not None:
        q, k = _rotate(q, rope), _rotate(k, rope)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    if lens is not None:
        valid = torch.arange(n, device=q.device)[None, :] < lens[:, None]
        s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def forward_geometry_fp32(b: int, n: int, h: int, d: int = train_attention.HEAD_DIM) -> dict:
    """How the fp32 kernel covers ``[b, n, h, d]``: the fp32 forward core's
    launch (`ops/train_attention.py` ``forward_geometry_fp32``), over this
    kernel's domain, ``64 <= n <= MAX_N``, ``n % 64 == 0``, d in
    ``KERNEL_HEAD_DIMS`` (128 and 256 on the two-set core); others raise."""
    if n % TILE or not 0 < n <= MAX_N:
        raise ValueError(f"serving_attention: n must be a multiple of {TILE} in "
                         f"[{TILE}, {MAX_N}], got {n}")
    return train_attention.forward_geometry_fp32(b, n, h, d)


def kernel_geometry_fp32(d: int = train_attention.HEAD_DIM) -> dict:
    """The constants the built fp32 kernel reports for head dim ``d`` (needs
    the card's build): they must equal :func:`forward_geometry_fp32`'s
    ``FP32_FORWARD_BUILT`` values (rows, threads, stages, shared bytes, sets,
    keys a tile)."""
    return train_attention._kernel_geometry("erax_serving_attention_fp32_geometry", d,
                                            train_attention.FP32_FORWARD_BUILT)


def _check_cuda_args(q, k, v, lens, rope) -> None:
    if not (q.shape == k.shape == v.shape) or q.ndim != 4:
        raise ValueError(f"serving_attention: q, k, v must share one [b, n, h, d] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"serving_attention: q must be bfloat16 or float32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"serving_attention: {name} is {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"serving_attention: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"serving_attention: {name} must be contiguous and "
                             "16-byte aligned")
    b, n, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"serving_attention: the kernels take head dims {KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    if rope is not None and d not in HEAD_DIMS:
        raise ValueError(f"serving_attention: fused rotary takes head dims {HEAD_DIMS}, got {d} "
                         "(the JAX package rotates q and k outside the attention there)")
    if n % TILE or not 0 < n <= MAX_N:
        raise ValueError(f"serving_attention: n must be a multiple of {TILE} in "
                         f"[{TILE}, {MAX_N}], got {n}")
    if lens is not None and (lens.shape != (b,) or lens.device != q.device
                             or lens.dtype.is_floating_point):
        raise ValueError(f"serving_attention: lens must be an integer [b] tensor on "
                         f"{q.device}, got {lens.dtype} {tuple(lens.shape)} on {lens.device}")
    if rope is not None and (rope.shape != (n, d) or rope.device != q.device):
        raise ValueError(f"serving_attention: rope must be [n, d] = {(n, d)} on "
                         f"{q.device}, got {tuple(rope.shape)} on {rope.device}")


# What the kernel reads beside q, k, v, kept across calls: per angle table its
# fp32 cos / sin tables, per (b, n, device) the lengths of ``lens=None``.
# ``_LOCK`` guards both: between one thread's lookup and its ``move_to_end``
# another thread's eviction could drop the key.
_TABLES: OrderedDict = OrderedDict()     # id(rope) -> (rope, cos, sin)
_FULL_LENS: OrderedDict = OrderedDict()  # (b, n, device) -> int32 [b]
_CACHE_SIZE = 32
_LOCK = threading.Lock()


def _remember(cache: OrderedDict, key, value):
    cache[key] = value
    if len(cache) > _CACHE_SIZE:
        cache.popitem(last=False)
    return value


def rope_tables(rope: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The contiguous fp32 ``cos`` and ``sin`` ``[n, d]`` of the angles
    ``rope``, made once per angle table: the cache is keyed by the tensor
    itself (and holds it, so its identity cannot pass to another table) and
    takes it as immutable, as the models keep theirs per length."""
    with _LOCK:
        hit = _TABLES.get(id(rope))
        if hit is not None and hit[0] is rope:
            _TABLES.move_to_end(id(rope))
            return hit[1], hit[2]
    rope32 = rope.float()
    cos, sin = rope32.cos().contiguous(), rope32.sin().contiguous()
    with _LOCK:
        _remember(_TABLES, id(rope), (rope, cos, sin))
    return cos, sin


def _full_lens(b: int, n: int, device: torch.device) -> torch.Tensor:
    """``lens`` of a call without a mask: every key valid."""
    key = (b, n, device)
    with _LOCK:
        hit = _FULL_LENS.get(key)
        if hit is None:
            hit = _remember(_FULL_LENS, key,
                            torch.full((b,), n, dtype=torch.int32, device=device))
    return hit


def serving_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lens: torch.Tensor | None = None,
                      rope: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax attention ``[b, n, h, d] -> [b, n, h, d]`` with key masking by
    per-sample valid length (``lens [b]``) and fused rotary (``rope [n, d]``).

    CPU tensors take :func:`serving_attention_reference`; CUDA tensors launch
    the kernel of their dtype or raise. The bf16 kernel's launches are
    counted in ``serving_attention.launches`` and, with and without fused
    rotary, ``serving_attention.launches_by_rope[rope is not None]``, by
    head dim in ``serving_attention.launches_by_head_dim[d]``; the fp32
    kernel's apart, in ``serving_attention.launches_fp32_by_rope`` and
    ``launches_fp32_by_head_dim``."""
    if q.device.type == "cpu":
        return serving_attention_reference(q, k, v, lens, rope)
    if q.device.type != "cuda":
        raise ValueError(f"serving_attention: unsupported device {q.device}")
    _check_cuda_args(q, k, v, lens, rope)
    from eraxvif5tts_tpu_torch.ops import _cuda

    b, n, h, d = q.shape
    lens_i = (_full_lens(b, n, q.device) if lens is None
              else lens.to(torch.int32).contiguous())
    cos, sin = rope_tables(rope) if rope is not None else (None, None)
    out = torch.empty_like(q)
    lib = _cuda.kernels().lib
    fp32 = q.dtype == torch.float32
    launch = lib.erax_serving_attention_fp32 if fp32 else lib.erax_serving_attention
    with torch.cuda.device(q.device):
        code = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens_i.data_ptr(),
            cos.data_ptr() if cos is not None else None,
            sin.data_ptr() if sin is not None else None,
            out.data_ptr(), b, n, h, d, int(rope is not None), 1.0 / math.sqrt(d),
            _cuda.stream_ptr(q.device))
    _cuda.check(code, "serving_attention")
    # a CUDA graph captured here reads the cached tables (and lengths) by
    # address: it holds them, as the caches above may drop them
    _cuda.hold(cos, sin, lens_i if lens is None else None)
    if fp32:
        _cuda.count(serving_attention, ("launches_fp32_by_rope", rope is not None),
                    ("launches_fp32_by_head_dim", d))
    else:
        _cuda.count(serving_attention, "launches", ("launches_by_rope", rope is not None),
                    ("launches_by_head_dim", d))
    return out


serving_attention.launches = 0
serving_attention.launches_by_rope = {True: 0, False: 0}
serving_attention.launches_fp32_by_rope = {True: 0, False: 0}
serving_attention.launches_by_head_dim = dict.fromkeys(KERNEL_HEAD_DIMS, 0)
serving_attention.launches_fp32_by_head_dim = dict.fromkeys(KERNEL_HEAD_DIMS, 0)
