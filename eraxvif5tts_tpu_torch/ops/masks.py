"""Length and span masks (parity: `eraxvif5tts_tpu/ops/masks.py`).

All return boolean masks marking VALID positions, with static widths. The
random draw of :func:`mask_from_frac_lengths` is an argument.
"""

from __future__ import annotations

import torch


def lens_to_mask(lens: torch.Tensor, length: int) -> torch.Tensor:
    """``[b] -> [b, length]`` bool; True where position < lens."""
    seq = torch.arange(length, device=lens.device)
    return seq[None, :] < lens[:, None]


def mask_from_start_end(start: torch.Tensor, end: torch.Tensor, length: int) -> torch.Tensor:
    """``[b] x [b] -> [b, length]`` bool; True where start <= position < end."""
    seq = torch.arange(length, device=start.device)
    return (seq[None, :] >= start[:, None]) & (seq[None, :] < end[:, None])


def mask_from_frac_lengths(lens: torch.Tensor, frac_lengths: torch.Tensor, length: int,
                           rand: torch.Tensor) -> torch.Tensor:
    """A span of ``frac * len`` frames inside each sample, starting at
    ``rand * (len - span)`` (``rand [b]`` uniform in [0, 1); `masks.py:23-31`)."""
    span = (frac_lengths * lens).to(torch.int32)
    max_start = lens - span
    start = (max_start * rand).to(torch.int32).clamp(min=0)
    return mask_from_start_end(start, start + span, length)
