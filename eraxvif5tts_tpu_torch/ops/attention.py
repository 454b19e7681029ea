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

Which of them runs on the card is decided by the head dim alone, before any
launch (:func:`head_dim_route`), never on an error:

- d in ``HEAD_DIMS`` (64, 128): the kernels, always; the JAX package's
  Pallas kernels take the same (`ops/attention.py:156`,
  `ops/serving_attention.py:179`, `ops/train_attention.py:404`);
- d = 256 (``LIBRARY_HEAD_DIM``): the JAX package runs its library flash
  kernel there (kernel 6, `ops/attention.py:202`), serving with q and k
  rotated outside it (its serving kernel's gate excludes d = 256,
  `ops/attention.py:156`, so `models/modules.py:378-392` does not fuse
  rotary) and training at dropout 0 through its forward and backward. The
  port's kernels take the same roles in bf16 and fp32: serving with
  ``rope=None`` (the models rotate outside, :func:`rotary_fused`) and
  training. At dropout > 0 the kernels keep their position-hash keep bit,
  where the JAX package's TPU path draws Bernoulli bits in its chunked XLA
  attention (`can_use_train_kernel` refuses d = 256): the same distribution
  in another stream, the same function at dropout 0;
- any other d (``tools/bench.py --smoke``'s 32, say): the JAX package runs
  no Pallas kernel there but XLA's attention (`ops/attention.py:206-212`),
  and work that JAX leaves to XLA is plain torch in the port: the plain
  versions run on the card, counted in ``plain_attention.calls``.
"""

from __future__ import annotations

import torch

from eraxvif5tts_tpu_torch.ops.serving_attention import (
    serving_attention,
    serving_attention_reference,
)
from eraxvif5tts_tpu_torch.ops.train_attention import (
    KERNEL_HEAD_DIMS,
    LIBRARY_HEAD_DIM,
    train_attention_reference,
)


def head_dim_route(d: int, device) -> str:
    """How attention with head dim ``d`` runs on ``device``, in every dtype
    and mode: ``"kernel"`` (the attention wrappers: on a CUDA tensor their
    kernels, on a CPU tensor their plain versions, as for every d) or
    ``"plain"`` (the plain versions on the card, where the JAX package runs
    XLA's attention)."""
    if torch.device(device).type == "cpu" or d in KERNEL_HEAD_DIMS:
        return "kernel"
    return "plain"


def rotary_fused(d: int) -> bool:
    """Whether serving at head dim ``d`` fuses rotary into the attention.
    Not at d = 256: the JAX package's serving kernel, which alone fuses it,
    refuses d = 256 (`ops/attention.py:156`), so its models rotate q and k
    outside the attention there, with cos and sin in the compute dtype
    (`models/modules.py:378-392`), and kernel 6 takes ``rope=None``."""
    return d != LIBRARY_HEAD_DIM


def plain_attention(reference, *args, **kwargs) -> torch.Tensor:
    """The plain version ``reference`` on the card, for a head dim that no
    kernel takes (:func:`head_dim_route`): one call counted in
    ``plain_attention.calls`` (a CUDA graph replay counts the calls it
    captured)."""
    from eraxvif5tts_tpu_torch.ops import _cuda

    _cuda.count(plain_attention, "calls")
    return reference(*args, **kwargs)


plain_attention.calls = 0


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_valid: torch.Tensor | None = None,
                          rope: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax attention over ``q/k/v [b, n, h, d]``; ``key_valid [b, n]`` is a
    contiguous-prefix mask of valid keys; ``rope [n, d]`` rotary angles are
    applied to q and k inside the kernel. Routed by head dim
    (:func:`head_dim_route`)."""
    lens = None
    if key_valid is not None:
        lens = key_valid.sum(dim=-1, dtype=torch.int32)
    if head_dim_route(q.shape[-1], q.device) == "plain":
        return plain_attention(serving_attention_reference, q, k, v, lens, rope)
    return serving_attention(q, k, v, lens, rope=rope)


def plain_train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_valid: torch.Tensor | None = None, dropout_rate: float = 0.0,
                          seed: int = 0, batch_offset: int = 0,
                          head_offset: int = 0) -> torch.Tensor:
    """:func:`~eraxvif5tts_tpu_torch.ops.train_attention.train_attention`'s
    arguments and semantics through its plain version, for the head dims
    :func:`head_dim_route` sends to ``"plain"``."""
    lens = None if key_valid is None else key_valid.sum(dim=-1, dtype=torch.int32)
    return plain_attention(train_attention_reference, q, k, v, lens, dropout_rate, seed,
                           batch_offset, head_offset)
