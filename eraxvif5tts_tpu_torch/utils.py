"""Misc utilities (the port's own copy of `eraxvif5tts_tpu/utils.py`)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 0) -> None:
    """Seed the host-side generators (reference `model/utils.py:18-25`): Python,
    numpy and torch (its CPU and every CUDA device's default generator). The
    port's own randomness takes explicit ``torch.Generator``s."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def exists(v) -> bool:
    return v is not None


def default(v, d):
    return v if v is not None else d
