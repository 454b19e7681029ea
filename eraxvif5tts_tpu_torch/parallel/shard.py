"""A rank's place in the whole, as the model's modules see it (Megatron-style
tensor parallelism on local shards, data parallelism on local rows).

A :class:`ShardContext` is shared by every :class:`~eraxvif5tts_tpu_torch.
models.modules.Attention` and :class:`~eraxvif5tts_tpu_torch.models.modules.
FeedForward` of a model put on a mesh (``parallel.mesh.shard_model``). It
carries:

- the ``model`` axis (its group, this rank's index and the axis size): a
  module whose projections are split over it holds ``heads / n_model``
  heads (q, k, v column shards), ``N / n_model`` feed-forward columns, and
  the row shards of ``to_out`` and ``project_out``. The input of a column
  shard enters through :func:`enter`, an identity whose backward sums the
  input gradient over the axis; the row shards' partial products leave
  through :func:`leave`, a sum over the axis (in fp32) whose backward is an
  identity; the bias is added once, after the sum;
- ``batch_offset``: the row of the global batch where this rank's rows
  start (data parallel). The dropout of every site hashes global
  coordinates: the rows from ``batch_offset``, the heads from the rank's
  first head, the feed-forward columns from its first column, so a sharded
  step keeps and drops the elements the one-device step does.

Without a context (``shard = None``, every model off a mesh) nothing here
runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass
class ShardContext:
    """The model axis (``group`` None when it has one rank) and the data
    row offset of one rank; shared, and mutated by the trainer per step."""

    group: Optional[object] = None
    rank: int = 0
    size: int = 1
    batch_offset: int = 0

    def __deepcopy__(self, memo):  # a copied module keeps its rank's context
        return self


class _Enter(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        dtype = grad.dtype
        grad = grad.float().contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.to(dtype), None


class _Leave(torch.autograd.Function):
    """Sum over the model axis in fp32 forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        out = x.float().contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def split(shard: Optional[ShardContext]) -> bool:
    """Whether a module with this context is split over a model axis."""
    return shard is not None and shard.size > 1


def enter(x: torch.Tensor, shard: Optional[ShardContext]) -> torch.Tensor:
    """The input of a column-split projection (replicated over the axis)."""
    return _Enter.apply(x, shard.group) if split(shard) else x


def leave(partial: torch.Tensor, bias: Optional[torch.Tensor],
          shard: Optional[ShardContext]) -> torch.Tensor:
    """A row-split projection's output: the sum of the ranks' partial
    products, then the bias once, in the partials' dtype."""
    out = _Leave.apply(partial, shard.group)
    if bias is not None:
        out = out + bias.float()
    return out.to(partial.dtype)


def batch_offset(shard: Optional[ShardContext]) -> int:
    return 0 if shard is None else shard.batch_offset
