"""Rotary position embeddings, interleaved pairs (parity:
`eraxvif5tts_tpu/ops/rotary.py`).

Angles ``theta^(-2i/d)`` per position, each frequency repeated for an adjacent
(even, odd) lane pair; rotation ``(x0, x1) -> (x0 cos - x1 sin, x1 cos + x0 sin)``.
"""

from __future__ import annotations

import numpy as np
import torch


def rotary_freqs(seq_len: int, dim: int, theta: float = 10000.0,
                 device=None) -> torch.Tensor:
    """Per-position angles ``[seq_len, dim]`` float32, each frequency twice."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    t = np.arange(seq_len, dtype=np.float64)
    freqs = np.repeat(t[:, None] * inv_freq[None, :], 2, axis=-1)
    return torch.tensor(freqs, dtype=torch.float32, device=device)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Adjacent-pair rotation: (x0, x1) -> (-x1, x0)."""
    pairs = x.unflatten(-1, (-1, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)


def apply_rotary(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [..., n, d]`` by angles ``freqs [n, rot_dim]`` (rot_dim <= d),
    with cos/sin cast to ``x.dtype`` as the reference's unfused path does."""
    rot_dim = freqs.shape[-1]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    cos = freqs.cos().to(x.dtype)
    sin = freqs.sin().to(x.dtype)
    x_rot = x_rot * cos + rotate_half(x_rot) * sin
    if x_pass.shape[-1] == 0:
        return x_rot
    return torch.cat([x_rot, x_pass], dim=-1)


def apply_rotary_heads(x: torch.Tensor, freqs: torch.Tensor,
                       heads: int | None = None) -> torch.Tensor:
    """Rotate the first ``heads`` heads (all when None) of ``x [b, n, h, d]``
    by ``freqs [n, rot_dim]`` with :func:`apply_rotary`; the other heads pass
    through (the reference's ``pe_attn_head``, `models/modules.py:386-390`)."""
    if heads is None or heads >= x.shape[2]:
        return apply_rotary(x, freqs[:, None])
    return torch.cat([apply_rotary(x[:, :, :heads], freqs[:, None]), x[:, :, heads:]], dim=2)


def abs_pos_embedding_table(dim: int, max_pos: int = 4096,
                            theta: float = 10000.0) -> np.ndarray:
    """``concat(cos(t f), sin(t f))`` table ``[max_pos, dim]`` float32, with
    frequencies over the first half of ``dim``."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))
    angles = np.outer(np.arange(max_pos, dtype=np.float64), freqs)
    return np.concatenate([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)
