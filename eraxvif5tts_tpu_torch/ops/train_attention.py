"""Flash attention for training, with position-hash attention dropout.

Port of `eraxvif5tts_tpu/ops/train_attention.py` (`train_attention`, whose
Pallas kernels are `_fwd_kernel`, `_dq_kernel` and `_dkv_kernel` under a
custom_vjp). :func:`train_attention` runs, for CUDA tensors, a
``torch.autograd.Function`` whose forward launches the forward kernel of
`csrc/train_attention.cu` and whose backward launches its dq and dk/dv
kernels; for CPU tensors it runs :func:`train_attention_reference`, the plain
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

Kernel domain: bf16, contiguous and 16-byte aligned ``[b, n, h, 64]`` (the
layout a ``Linear`` output views to), ``n % 64 == 0``, ``n <= 4096``.
Anything else on a CUDA tensor raises; there is no fallback. The JAX
package's TPU gates (``can_use_train_kernel``: n % 128, fp32 only up to
n = 3072) and calibrated backward blocks are TPU VMEM limits and are not
ported.

Integer arithmetic: torch has no uint32 ``>>`` on the CPU, so the hash runs in
int64 holding 32-bit values, masked to 32 bits after every multiply (a wrapped
64-bit product keeps its low 32 bits exact).
"""

from __future__ import annotations

import math

import torch

_NEG = -1e30
MAX_N = 4096
TILE = 64
HEAD_DIM = 64
M32 = 0xFFFFFFFF


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
                              seed: int = 0, batch_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version (dense: materialises the ``[b, h, n, n]`` fp32
    logits and the keep mask), differentiable by autograd. Mirrors the JAX
    package's ``dense_reference`` plus key masking by ``lens [b]``.
    ``batch_offset`` is the batch index of ``q[0]`` in the dropout salt, so
    that a slice of a batch gets the masks it has in the whole batch.

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
        km = torch.stack([torch.stack([dropout_keep_mask(seed, batch_offset + bi, hi, 0, 0,
                                                         n, n, n, keep, q.device)
                                       for hi in range(h)]) for bi in range(b)])
        p = torch.where(km, p * (1.0 / keep), torch.tensor(0.0, device=q.device))
    p = p + (p.to(v.dtype).float() - p).detach()
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _check_cuda_args(q, k, v, lens) -> None:
    if not (q.shape == k.shape == v.shape) or q.ndim != 4:
        raise ValueError(f"train_attention: q, k, v must share one [b, n, h, d] shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"train_attention: {name} must be bfloat16, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"train_attention: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"train_attention: {name} must be contiguous and 16-byte aligned")
    b, n, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"train_attention: head dim must be {HEAD_DIM}, got {d}")
    if n % TILE or not 0 < n <= MAX_N:
        raise ValueError(f"train_attention: n must be a multiple of {TILE} in "
                         f"[{TILE}, {MAX_N}], got {n}")
    if lens.shape != (b,) or lens.device != q.device or lens.dtype.is_floating_point:
        raise ValueError(f"train_attention: lens must be an integer [b] tensor on {q.device}, "
                         f"got {lens.dtype} {tuple(lens.shape)} on {lens.device}")


def _dropout_args(dropout_rate: float, seed: int) -> tuple[int, int, float, int]:
    """(seed, threshold, inv_keep, on) for the kernels' C interface."""
    if dropout_rate <= 0.0:
        return 0, 0, 1.0, 0
    keep = 1.0 - dropout_rate
    return int(seed) & M32, keep_threshold(keep), 1.0 / keep, 1


def flash_forward(q, k, v, lens, dropout_rate: float = 0.0,
                  seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on checked CUDA arguments: (O ``[b, n, h, d]``
    bf16, LSE ``[b, h, n]`` fp32). Counted in ``flash_forward.launches``."""
    from eraxvif5tts_tpu_torch.ops import _cuda

    b, n, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = _cuda.kernels().lib.erax_train_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, n, h, 1.0 / math.sqrt(d), *_dropout_args(dropout_rate, seed),
            _cuda.stream_ptr(q.device))
    _cuda.check(code, "train_attention forward")
    flash_forward.launches += 1
    return out, lse


def flash_dq(q, k, v, lens, lse, dd, dout, dropout_rate: float = 0.0,
             seed: int = 0) -> torch.Tensor:
    """Launch the dq kernel: dq ``[b, n, h, d]`` bf16 from the forward's LSE,
    ``dd = rowsum(dO * O)`` ``[b, h, n]`` fp32 and ``dout``. Counted in
    ``flash_dq.launches``."""
    from eraxvif5tts_tpu_torch.ops import _cuda

    b, n, h, d = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = _cuda.kernels().lib.erax_train_attention_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), lens.data_ptr(), dq.data_ptr(), b, n, h, 1.0 / math.sqrt(d),
            *_dropout_args(dropout_rate, seed), _cuda.stream_ptr(q.device))
    _cuda.check(code, "train_attention dq")
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, lens, lse, dd, dout, dropout_rate: float = 0.0,
              seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel (arguments as :func:`flash_dq`). Counted in
    ``flash_dkv.launches``."""
    from eraxvif5tts_tpu_torch.ops import _cuda

    b, n, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        code = _cuda.kernels().lib.erax_train_attention_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), lens.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, h,
            1.0 / math.sqrt(d), *_dropout_args(dropout_rate, seed), _cuda.stream_ptr(q.device))
    _cuda.check(code, "train_attention dk/dv")
    flash_dkv.launches += 1
    return dk, dv


flash_forward.launches = flash_dq.launches = flash_dkv.launches = 0


def row_dot(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in fp32, ``[b, h, n]`` like the LSE (plain torch, as
    the JAX package leaves it to XLA, `train_attention.py:328`)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class _TrainAttention(torch.autograd.Function):
    """Forward kernel; backward = D in plain torch, then the dq and dk/dv
    kernels (the JAX custom_vjp, `train_attention.py:261-390`)."""

    @staticmethod
    def forward(ctx, q, k, v, lens, dropout_rate, seed):
        out, lse = flash_forward(q, k, v, lens, dropout_rate, seed)
        ctx.save_for_backward(q, k, v, lens, out, lse)
        ctx.dropout = (dropout_rate, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lens, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        dd = row_dot(dout, out)
        dq = flash_dq(q, k, v, lens, lse, dd, dout, *ctx.dropout)
        dk, dv = flash_dkv(q, k, v, lens, lse, dd, dout, *ctx.dropout)
        return dq, dk, dv, None, None, None


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: torch.Tensor | None = None, dropout_rate: float = 0.0,
                    seed: int = 0) -> torch.Tensor:
    """Differentiable softmax attention ``[b, n, h, d] -> [b, n, h, d]`` with
    position-hash attention dropout. ``key_valid [b, n]`` must be a
    contiguous prefix mask; ``seed`` is the kernel seed
    (:func:`attention_seed` of the dropout key's words).

    CPU tensors take :func:`train_attention_reference`; CUDA tensors run the
    kernels (:func:`flash_forward`, then :func:`flash_dq` and
    :func:`flash_dkv` in the backward) or raise. Setting
    ``train_attention.plain = True`` sends every call to the plain version,
    on any device: a whole model's kernels can then be compared with it."""
    b, n = q.shape[:2]
    lens = None if key_valid is None else key_valid.sum(dim=-1, dtype=torch.int32)
    if q.device.type == "cpu" or train_attention.plain:
        return train_attention_reference(q, k, v, lens, dropout_rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"train_attention: unsupported device {q.device}")
    if lens is None:
        lens = torch.full((b,), n, dtype=torch.int32, device=q.device)
    _check_cuda_args(q, k, v, lens)
    return _TrainAttention.apply(q, k, v, lens.contiguous(), dropout_rate, seed)


train_attention.plain = False
