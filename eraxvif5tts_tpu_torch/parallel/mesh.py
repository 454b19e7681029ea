"""Device mesh, sharding rules, ZeRO-1 partitions and the collectives of
multi-device training and serving (port of `eraxvif5tts_tpu/parallel/mesh.py`).

As in the JAX package, the mesh is 2-D, ``(data, model)``: pure data
parallelism is ``model = 1``; ``model > 1`` splits the DiT's attention
q / k / v and feed-forward input projections by columns and their output
projections by rows (:func:`param_sharding_rules`, the JAX ``_TP_RULES``
carried through the key map of `compression/convert.py`), everything else
replicated. What differs is the runtime: JAX runs all of it from one
controller under GSPMD, the port runs one process per device
(``torch.distributed``), each holding its local shards and rows:

- :func:`make_mesh` returns a ``DeviceMesh`` over the processes of the
  default group, initialised from the ``torchrun`` environment when there
  is none (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``; the
  card is ``cuda:LOCAL_RANK``), with an explicit backend: ``nccl`` for
  ``cuda``, ``gloo`` for ``cpu`` unless the caller names one;
- :func:`shard_model` cuts a model's parameters to the rank's shards and
  hands its attention and feed-forward modules the rank's
  :class:`~eraxvif5tts_tpu_torch.parallel.shard.ShardContext`;
- :func:`zero1_chunk` is a rank's part of a parameter-shaped tensor under
  ZeRO-1 (AdamW moments and the EMA partitioned over ``data``);
- :func:`local_rows` pads a global batch to a multiple of ``data`` (rows
  with ``lens = 0``, the JAX trainer's ``_pad_batch``) and takes the rank's.

Only the DiT is split. The JAX rules name no UNetT leaf (its paths are
``attn_N/...``, ``ff_N/...``), so the UNetT runs replicated on every model
rank in both packages. They do name the MMDiT's audio-stream q / k / v and
``to_out`` but none of its text stream's (``to_q_c``, ``ff_x``, ...), and
no int8 ``kernel_q`` leaf: GSPMD computes the same function there, and the
port runs these models replicated on the model axis (with one printed line),
not split beyond what JAX splits.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.distributed as dist

from eraxvif5tts_tpu_torch.parallel.shard import ShardContext

AXES = ("data", "model")

# (regex over a torch parameter name, spec over the torch tensor's dims) —
# first match wins. A torch Linear weight is [out, in], the transpose of the
# flax kernel: JAX's column-parallel P(None, "model") is dim 0 here, its
# row-parallel P("model", None) dim 1.
_TP_RULES: list[tuple[str, tuple]] = [
    (r"(^|\.)attn\.to_[qkv]\.weight$", ("model", None)),
    (r"(^|\.)attn\.to_[qkv]\.bias$", ("model",)),
    (r"(^|\.)attn\.to_out\.0\.weight$", (None, "model")),
    (r"(^|\.)ff\.ff\.0\.0\.weight$", ("model", None)),
    (r"(^|\.)ff\.ff\.0\.0\.bias$", ("model",)),
    (r"(^|\.)ff\.ff\.2\.weight$", (None, "model")),
    # the AdaLN modulation stays replicated, as in JAX (its 6-way split)
]


class LocalBatch(dict):
    """A batch that holds this data rank's rows only (loaded per rank by
    ``training.cli.multihost_epoch_batches``): every data rank's has the
    same shape, and the global batch is their concatenation in rank order."""


# ---------------------------------------------------------------------------
# the mesh


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_from_environment(device_type: str = "cuda", backend: Optional[str] = None) -> None:
    """Initialise the default process group from ``torchrun``'s environment."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise ValueError(f"no process group and no torchrun environment (missing "
                         f"{', '.join(missing)}): start the processes with torchrun, or "
                         "call torch.distributed.init_process_group first")
    if device_type == "cuda":
        torch.cuda.set_device(local_device().index)
    dist.init_process_group(backend or default_backend(device_type), init_method="env://")


def local_device(device_type: str = "cuda") -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (0 without torchrun)."""
    if device_type != "cuda":
        return torch.device(device_type)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device_type: str = "cuda",
              backend: Optional[str] = None):
    """A ``(data, model)`` ``DeviceMesh`` over the default group's processes
    (rank ``r`` at ``(r // n_model, r % n_model)``: model peers are
    neighbours). Raises where the JAX ``make_mesh`` does: a mesh that does
    not cover the processes."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        init_from_environment(device_type, backend)
    world = dist.get_world_size()
    if n_model < 1 or world % n_model:
        raise ValueError(f"{world} processes not divisible by model={n_model}")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} processes")
    ranks = torch.arange(world, dtype=torch.int).view(n_data, n_model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The axis's process group, None when it has one rank (no collective)."""
    return None if axis_size(mesh, axis) == 1 else mesh.get_group(axis)


def new_axis_group(mesh, axis: str, backend: str = "gloo"):
    """A new group over this rank's peers on ``axis``, on ``backend``: for
    collectives off the training step's thread (a data loader's), which
    must not share the step's groups. Every process of the mesh calls it
    at the same point; None when the axis has one rank."""
    if axis_size(mesh, axis) == 1:
        return None
    ranks = mesh.mesh if axis == "model" else mesh.mesh.T  # one row a group
    mine = None
    for peers in ranks.tolist():
        group = dist.new_group(peers, backend=backend)
        if dist.get_rank() in peers:
            mine = group
    return mine


def process_count(mesh) -> int:
    """Processes the mesh spans: one a device."""
    return 1 if mesh is None else mesh.mesh.numel()


def is_main(mesh) -> bool:
    """Whether this process writes (checkpoints, logs, samples)."""
    return mesh is None or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# the rules


def param_sharding_rules(name: str) -> tuple:
    """The spec of a torch parameter name like
    ``transformer_blocks.0.attn.to_q.weight``: one entry a dim, ``"model"``
    where it is split; ``()`` replicated."""
    for pattern, spec in _TP_RULES:
        if re.search(pattern, name):
            return spec
    return ()


def shard_dim(name: str, shape, n_model: int) -> Optional[int]:
    """The dim a parameter is split on over ``n_model`` ranks, None when it
    is replicated, by the rules or because that dim does not divide (as in
    JAX)."""
    if n_model == 1:
        return None
    spec = param_sharding_rules(name)
    for dim, axis in enumerate(spec):
        if axis == "model":
            return dim if shape[dim] % n_model == 0 else None
    return None


def _splittable(model) -> tuple[bool, str]:
    """Whether the model's split leaves are the port's to split: the
    non-quantized DiT only (module doc)."""
    from eraxvif5tts_tpu_torch.models.dit import DiT

    if not isinstance(model, DiT):
        return False, f"the {type(model).__name__}'s"
    if model.arch.quantized:
        return False, "the int8 DiT's"
    return True, ""


def shard_model(model: torch.nn.Module, mesh) -> ShardContext:
    """Put ``model`` (its full weights loaded, identical on every rank) on
    the mesh, in place: hand every attention and feed-forward module the
    rank's :class:`ShardContext` and, with ``model > 1``, cut the parameters
    the rules split to this rank's shards (an attention module's only when
    its heads divide, a feed-forward's only when its hidden width does; the
    other stay replicated, as JAX leaves a leaf that does not divide).
    ``model.split_params`` then maps each split parameter to its dim.
    Returns the context (the trainer sets its ``batch_offset``). Idempotent."""
    from eraxvif5tts_tpu_torch.models.modules import Attention, FeedForward

    if getattr(model, "shard_context", None) is not None:
        return model.shard_context
    n_model = axis_size(mesh, "model")
    ctx = ShardContext(group=axis_group(mesh, "model"), rank=axis_rank(mesh, "model"),
                       size=n_model)
    ok, what = _splittable(model)
    if n_model > 1 and not ok:
        print(f"[mesh] model={n_model}: the JAX rules split none or not all of {what} "
              "projections; it runs replicated on every model rank")
    split: dict[str, int] = {}
    for prefix, mod in model.named_modules():
        if not isinstance(mod, (Attention, FeedForward)):
            continue
        mod.shard = ctx
        if n_model == 1 or not ok or not mod.splits_over(n_model):
            continue
        for name, p in mod.named_parameters(prefix=prefix):
            dim = shard_dim(name, p.shape, n_model)
            if dim is not None:
                p.data = p.data.chunk(n_model, dim)[ctx.rank].contiguous()
                split[name] = dim
        mod.split_over(ctx)
    model.shard_context = ctx
    model.split_params = split
    return ctx


# ---------------------------------------------------------------------------
# ZeRO-1 and batches


def zero1_bounds(numel: int, n_data: int) -> list[tuple[int, int]]:
    """``(start, end)`` of each data rank's part of a flat tensor of
    ``numel`` elements (``torch.tensor_split``'s: the first ``numel %
    n_data`` parts one longer)."""
    base, extra = divmod(numel, n_data)
    out, start = [], 0
    for r in range(n_data):
        end = start + base + (r < extra)
        out.append((start, end))
        start = end
    return out


def zero1_chunk(t: torch.Tensor, n_data: int, rank: int) -> torch.Tensor:
    """A view of data rank ``rank``'s part of ``t``'s flat elements: the
    parameter, moments and EMA a rank updates under ZeRO-1."""
    start, end = zero1_bounds(t.numel(), n_data)[rank]
    return t.detach().view(-1)[start:end]


def pad_batch(batch: dict, n_data: int) -> dict:
    """The batch axis padded to a multiple of ``n_data`` (the JAX trainer's
    ``_pad_batch``): padded rows have ``lens = 0``, text ``-1``, mel and
    phoneme ids 0, so the masked loss ignores them."""
    b = len(batch["lens"])
    pad = (-b) % n_data
    if pad == 0:
        return batch
    fills = {"text": -1}
    out = dict(batch)
    for key in ("mel", "text", "lens", "phoneme"):
        x = batch.get(key)
        if x is None:
            continue
        x = torch.as_tensor(x)
        filler = torch.full((pad, *x.shape[1:]), fills.get(key, 0), dtype=x.dtype,
                            device=x.device)
        out[key] = torch.cat([x, filler])
    return out


def local_rows(mesh, batch: dict) -> tuple[dict, int, int]:
    """This data rank's rows of a global batch padded to a multiple of
    ``data``: ``(rows, first row, global rows)``. A :class:`LocalBatch` is
    already the rank's rows."""
    n_data = axis_size(mesh, "data")
    rank = axis_rank(mesh, "data")
    if isinstance(batch, LocalBatch):
        b = len(batch["lens"])
        return dict(batch), rank * b, b * n_data
    batch = pad_batch(batch, n_data)
    total = len(batch["lens"])
    b = total // n_data
    rows = {k: (torch.as_tensor(v)[rank * b:(rank + 1) * b] if k in
                ("mel", "text", "lens", "phoneme") and v is not None else v)
            for k, v in batch.items()}
    return rows, rank * b, total


# ---------------------------------------------------------------------------
# collectives (all_reduce and broadcast only: gloo takes CUDA tensors for both)


def _by_dtype_flat(tensors: list[torch.Tensor], collective) -> None:
    """``collective(flat)`` on one flat copy of ``tensors`` a dtype, the
    result copied back in place."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        torch._foreach_copy_(ts, [c.view_as(t) for c, t in
                                  zip(flat.split([t.numel() for t in ts]), ts)])


def all_reduce_flat(tensors: list[torch.Tensor], group) -> None:
    """Sum ``tensors`` over ``group`` in place, one collective a dtype."""
    if group is not None and tensors:
        _by_dtype_flat(tensors, lambda flat: dist.all_reduce(flat, group=group))


def broadcast_flat(tensors: list[torch.Tensor], src_rank_in_group: int, group) -> None:
    """Broadcast ``tensors`` (same shapes on every rank) from one rank of
    ``group`` in place, one collective a dtype."""
    if group is not None and tensors:
        src = dist.get_global_rank(group, src_rank_in_group)
        _by_dtype_flat(tensors, lambda flat: dist.broadcast(flat, src=src, group=group))


def gather_dims(tensors: list[torch.Tensor], dims: list[Optional[int]], group,
                size: int) -> list[torch.Tensor]:
    """The wholes of tensors split evenly on ``dims`` over ``group`` (a
    tensor whose dim is None is replicated and comes back as it is)."""
    split = [i for i, d in enumerate(dims) if d is not None]
    out = list(tensors)
    if group is None or not split:
        return out
    parts = [[tensors[i].detach().clone() for i in split] for _ in range(size)]
    for r in range(size):
        broadcast_flat(parts[r], r, group)
    for j, i in enumerate(split):
        out[i] = torch.cat([parts[r][j] for r in range(size)], dim=dims[i])
    return out


def gather_zero1(chunks: list[torch.Tensor], numels: list[int], group,
                 n_data: int) -> list[torch.Tensor]:
    """The whole flat tensors of which each rank of ``group`` holds its
    :func:`zero1_chunk`."""
    fulls = [torch.empty(n, dtype=c.dtype, device=c.device) for c, n in zip(chunks, numels)]
    rank = dist.get_rank(group) if group is not None else 0
    for r in range(n_data):
        parts = [f[slice(*zero1_bounds(n, n_data)[r])] for f, n in zip(fulls, numels)]
        if r == rank:
            for part, chunk in zip(parts, chunks):
                part.copy_(chunk)
        broadcast_flat(parts, r, group)
    return fulls


def unshard_copy(model: torch.nn.Module, state_dict: dict) -> torch.nn.Module:
    """A copy of a sharded ``model`` off the mesh, holding the whole weights
    of ``state_dict`` (a consolidated one): it runs on this rank alone, with
    no collective (a rank's samples and exports)."""
    import copy

    from eraxvif5tts_tpu_torch.models.modules import Attention

    net = copy.deepcopy(model)
    for mod in net.modules():
        if isinstance(mod, Attention) and mod.tp is not None:
            mod.heads *= mod.tp.size
            mod.head0 = 0
        if hasattr(mod, "shard"):
            mod.shard = mod.tp = None
    for name, p in net.named_parameters():
        p.data = state_dict[name].to(device=p.device, dtype=p.dtype).clone()
    net.shard_context = None
    net.split_params = {}
    return net
