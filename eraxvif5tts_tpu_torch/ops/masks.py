"""Length masks (parity: `eraxvif5tts_tpu/ops/masks.py`)."""

from __future__ import annotations

import torch


def lens_to_mask(lens: torch.Tensor, length: int) -> torch.Tensor:
    """``[b] -> [b, length]`` bool; True where position < lens."""
    seq = torch.arange(length, device=lens.device)
    return seq[None, :] < lens[:, None]
