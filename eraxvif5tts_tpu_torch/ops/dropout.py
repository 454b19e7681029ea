"""Position-hash dropout (port of `eraxvif5tts_tpu/ops/dropout.py`).

The elementwise counterpart of the attention-weight dropout in
`ops/train_attention.py`: element ``i`` of the flattened tensor is kept where
``fmix32(i ^ salt) < keep * 2^32``, the salt made from the dropout key's two
32-bit words by two independent fmix rounds. The mask is deterministic in
(key, element position), so an activation-checkpoint recompute reproduces it
exactly. Plain torch on every device (the JAX package leaves it to XLA too);
the hash runs in int64 holding 32-bit values, as in `ops/train_attention.py`.
"""

from __future__ import annotations

import math

import torch

from eraxvif5tts_tpu_torch.ops.train_attention import M32, fmix32, fmix32_int, keep_threshold


def dropout_salt(key_words) -> int:
    """``fmix32(w0 * 0x9E3779B9) ^ fmix32(w1 + 0x7FEB352D)`` (mod 2^32) of a
    dropout key's two 32-bit words (`dropout.py:29-33`)."""
    w0, w1 = (int(w) & M32 for w in key_words)
    return fmix32_int(w0 * 0x9E3779B9) ^ fmix32_int(w1 + 0x7FEB352D)


def element_index(shape, device, batch_offset: int = 0, col_offset: int = 0,
                  cols: int | None = None) -> torch.Tensor:
    """The flat index (mod 2^32, int64) each element of a ``shape`` tensor
    has in the whole tensor it is a block of: ``shape`` is ``[b, ..., c]``,
    its rows start at row ``batch_offset`` and its columns at column
    ``col_offset`` of a whole that is ``cols`` wide (``c`` when None). With
    no offsets it is ``arange(numel)``."""
    cols = shape[-1] if cols is None else cols
    mid = math.prod(shape[1:-1])
    rows = torch.arange(shape[0] * mid, dtype=torch.int64, device=device) + batch_offset * mid
    col = torch.arange(shape[-1], dtype=torch.int64, device=device) + col_offset
    return (rows[:, None] * cols + col[None, :]).view(shape) & M32


def hash_dropout(x: torch.Tensor, rate: float, key_words, batch_offset: int = 0,
                 col_offset: int = 0, cols: int | None = None) -> torch.Tensor:
    """Dropout with keep probability ``1 - rate``: kept elements divided by
    the keep probability (in x's dtype), the others zero. ``key_words`` are
    the two 32-bit words of the dropout key (``jax.random.key_data`` in the
    tests, a draw from the step's generator in training). A rank that holds
    a block of the whole tensor (rows of the batch, columns of a sharded
    projection) passes its place in it (:func:`element_index`) and keeps the
    bits the whole tensor has there."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    idx = element_index(tuple(x.shape), x.device, batch_offset, col_offset, cols)
    kept = fmix32(idx ^ dropout_salt(key_words)) < keep_threshold(keep)
    return torch.where(kept, x / torch.tensor(keep, dtype=x.dtype, device=x.device),
                       torch.zeros((), dtype=x.dtype, device=x.device))
