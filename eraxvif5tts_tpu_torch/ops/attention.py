"""Attention dispatch (port of `dot_product_attention` in
`eraxvif5tts_tpu/ops/attention.py`).

The JAX package chooses between its serving kernel, a library flash kernel
and XLA attention by platform and shape. The port has one serving path: the
key-validity mask, which must be a contiguous prefix (``lens_to_mask``), is
reduced to per-sample lengths and handed to
:func:`~eraxvif5tts_tpu_torch.ops.serving_attention.serving_attention`,
which launches the CUDA kernel for CUDA tensors (or raises) and runs its plain
version for CPU tensors.
"""

from __future__ import annotations

import torch

from eraxvif5tts_tpu_torch.ops.serving_attention import serving_attention


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_valid: torch.Tensor | None = None,
                          rope: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax attention over ``q/k/v [b, n, h, d]``; ``key_valid [b, n]`` is a
    contiguous-prefix mask of valid keys; ``rope [n, d]`` rotary angles are
    applied to q and k inside the kernel."""
    lens = None
    if key_valid is not None:
        lens = key_valid.sum(dim=-1, dtype=torch.int32)
    return serving_attention(q, k, v, lens, rope=rope)
