"""Attention dispatch (port of `dot_product_attention` in
`eraxvif5tts_tpu/ops/attention.py`).

The JAX package chooses between its serving kernel, a library flash kernel,
its training kernel and XLA attention by platform, shape and mode. The port
has one path per mode, each reducing the key-validity mask (a contiguous
prefix, ``lens_to_mask``) to per-sample lengths inside its kernel wrapper,
which launches the CUDA kernel for CUDA tensors (or raises) and runs its plain
version for CPU tensors:

- serving (no gradient, rotary fused):
  :func:`~eraxvif5tts_tpu_torch.ops.serving_attention.serving_attention`;
- training: :func:`~eraxvif5tts_tpu_torch.ops.train_attention.train_attention`,
  which ``models.modules.Attention`` calls directly, with attention dropout
  (`models/modules.py:395-418`) or, at dropout 0, with keep = 1 (the
  dropout-free training role of the library flash kernel, `:419-426`). The
  JAX package's CPU-only ``chunked_dot_product_attention``
  exists because its kernel needs a TPU; the port's plain version runs on the
  CPU and is not ported.
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

