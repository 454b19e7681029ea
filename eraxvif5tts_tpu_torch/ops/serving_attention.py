"""Masked softmax attention with fused rotary: the serving loop's attention.

Port of `eraxvif5tts_tpu/ops/serving_attention.py` (`serving_attention`, whose
Pallas body is `_headloop_kernel`). :func:`serving_attention` launches the
CUDA kernel `csrc/serving_attention.cu` for CUDA tensors and runs
:func:`serving_attention_reference`, the plain PyTorch version of the same
semantics, for CPU tensors:

- rotary (``rope [n, d]`` angles, interleaved pairs) on q and k in fp32, cast
  back to the input dtype before QK^T;
- logits and softmax in fp32, keys at positions ``>= lens[b]`` set to the
  finite -1e30 (a sample with ``lens = 0`` averages every key, never NaN);
- P cast to v's dtype, PV accumulated in fp32, output in q's dtype.

Kernel domain: bf16, contiguous and 16-byte aligned ``[b, n, h, 64]``,
``n % 64 == 0``, ``n <= 4096``. Anything else on a CUDA tensor raises; there
is no fallback. The kernel's online softmax rounds the unnormalised P to bf16 where the TPU
kernel rounds the normalised P: the two agree to bf16 rounding of the output
(the card-side check in `chip_smoke.py` states its tolerance).
"""

from __future__ import annotations

import math

import torch

from eraxvif5tts_tpu_torch.ops.rotary import rotate_half

_NEG = -1e30
MAX_N = 4096
TILE = 64
HEAD_DIM = 64


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


def _check_cuda_args(q, k, v, lens, rope) -> None:
    if not (q.shape == k.shape == v.shape) or q.ndim != 4:
        raise ValueError(f"serving_attention: q, k, v must share one [b, n, h, d] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"serving_attention: {name} must be bfloat16, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"serving_attention: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"serving_attention: {name} must be contiguous and "
                             "16-byte aligned")
    b, n, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"serving_attention: head dim must be {HEAD_DIM}, got {d}")
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


def serving_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lens: torch.Tensor | None = None,
                      rope: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax attention ``[b, n, h, d] -> [b, n, h, d]`` with key masking by
    per-sample valid length (``lens [b]``) and fused rotary (``rope [n, d]``).

    CPU tensors take :func:`serving_attention_reference`; CUDA tensors launch
    the kernel or raise. ``serving_attention.launches`` counts every launch
    and ``serving_attention.launches_by_rope[rope is not None]`` those with
    and without fused rotary."""
    if q.device.type == "cpu":
        return serving_attention_reference(q, k, v, lens, rope)
    if q.device.type != "cuda":
        raise ValueError(f"serving_attention: unsupported device {q.device}")
    _check_cuda_args(q, k, v, lens, rope)
    from eraxvif5tts_tpu_torch.ops import _cuda

    b, n, h, d = q.shape
    lens_i = (torch.full((b,), n, dtype=torch.int32, device=q.device) if lens is None
              else lens.to(torch.int32).contiguous())
    cos = sin = None
    if rope is not None:
        rope32 = rope.float()
        cos, sin = rope32.cos().contiguous(), rope32.sin().contiguous()
    out = torch.empty_like(q)
    lib = _cuda.kernels().lib
    with torch.cuda.device(q.device):
        code = lib.erax_serving_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens_i.data_ptr(),
            cos.data_ptr() if cos is not None else None,
            sin.data_ptr() if sin is not None else None,
            out.data_ptr(), b, n, h, int(rope is not None), 1.0 / math.sqrt(d),
            _cuda.stream_ptr(q.device))
    _cuda.check(code, "serving_attention")
    serving_attention.launches += 1
    serving_attention.launches_by_rope[rope is not None] += 1
    return out


serving_attention.launches = 0
serving_attention.launches_by_rope = {True: 0, False: 0}
