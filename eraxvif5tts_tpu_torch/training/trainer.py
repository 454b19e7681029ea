"""CFM trainer (port of `eraxvif5tts_tpu/training/trainer.py`).

Kept from the JAX package:

- AdamW (``b1``, ``b2`` = 0.9, 0.98), eps 1e-8, weight decay 1e-4 (optax's
  ``adamw`` default; torch's is 1e-2), with a linear warmup from 0 then a
  linear (or cosine) decay, evaluated at the count of updates applied before
  the current one (the first update has lr 0 when there is a warmup), and
  global-norm clipping with optax's formula (no epsilon on the norm);
  ``mu_dtype="bfloat16"`` stores the first moment in bf16 as optax does (the
  moment is formed in fp32 from the bf16 one, used in fp32, then rounded);
- gradient accumulation with ``optax.MultiSteps(every_k, skip_not_finite)``
  semantics: the running mean of the finite micro-batch gradients, applied on
  the k-th counted one; a non-finite micro-batch is neither counted nor added;
- the NaN/Inf skip: a step whose loss or gradient norm is not finite leaves
  the parameters, the optimizer, the schedule and ``step`` untouched;
- an fp32 EMA of the parameters, updated on applied updates only (a copy
  while ``step <= ema_update_after_step``, then every ``ema_update_every``
  with ema_pytorch's decay warmup of ``ema_decay`` / ``ema_inv_gamma`` /
  ``ema_power``);
- checkpoints ``model_{step}`` / ``model_last`` with the ``.meta.json``
  sidecar, ``keep_last_n`` rotation that spares ``model_last``, and
  mid-epoch resume: the per-batch generator is seeded from (seed, epoch,
  batch index), so a resumed run repeats the loss trajectory;
- the duration-predictor curriculum (reference `trainer.py:240-300,
  829-1079`): a trained predictor, a frozen "align" copy whose embedding
  feeds the MAS similarity (`training/alignment.py`), and the predictor's
  own AdamW (constant rate ``duration_lr``, weight decay 3e-4, no clipping).
  Phase 1 (the first ``duration_focus_updates`` updates) trains the
  predictor alone: the CFM loss is forward only and deterministic (no
  dropout, no backward), and the main optimizer takes the JAX package's
  update on all-zero gradients with its result discarded: its count and
  schedule advance, its moments decay by ``b1`` / ``b2``, the EMA step runs,
  and the parameters stay bit for bit. Phase 2 trains both on
  ``cfm_loss + weight * duration_loss``; the predictor's step has its own
  NaN skip and, with accumulation, its own running mean and count (the JAX
  trainer's two ``optax.MultiSteps``). The phase machine, the weight schedule and the live phoneme map
  go into the sidecar, and the map is restored in place (the collate
  closure holds the same dict);
- loggers: ``train(logger="wandb" | "tensorboard")`` falls through wandb ->
  tensorboard -> off with a printed line, as the JAX trainer does.

Differences, by design: the state is updated in place (the JAX ``TrainState``
is an immutable pytree returned anew each step); a step reads its losses and
gradient norms back to the host once, to decide the skip; checkpoints are
``torch.save`` files (Orbax is JAX-only). A state may also carry a duration
predictor and its optimizer without the curriculum (the distillation trainer
of `training/distill.py` fills them): checkpoints then carry them too, and a
state without them saves and restores as before.

On a mesh (``Trainer(mesh=parallel.mesh.make_mesh(...), zero1=...)``, the
JAX trainer's ``mesh`` / ``zero1`` fields) every process runs the step on
its shards and rows, and the step computes what the one-device step
computes, up to float reassociation:

- ``train_step`` takes the global batch (or a ``parallel.mesh.LocalBatch``
  of this data rank's rows), pads it to a multiple of ``data`` with
  ``lens = 0`` rows (the JAX ``_pad_batch``) and takes the rank's rows; the
  loss draws are drawn for the whole padded batch from the step's one
  generator and sliced, and every dropout site hashes global coordinates
  (`parallel/shard.py`), so the kept bits are the one-device step's;
- the loss is the global masked mean: each data rank divides its sum by the
  span count summed over ``data``, and the gradients are summed over
  ``data``; the clipping norm sums the split leaves' squares over ``model``
  and counts the replicated leaves once; the NaN skip is one decision for
  every rank;
- ``zero1``: the AdamW moments (``mu_dtype`` too) and the EMA are
  partitioned over ``data`` (each rank updates a contiguous part of every
  flat parameter, then the parts are broadcast); parameters, EMA and loss
  are those of the replicated layout;
- checkpoints are consolidated and written by rank 0 in the one-device
  format, so a mesh checkpoint resumes on one device and the other way
  round; restore runs on every rank, logging and samples on rank 0.

The duration-predictor curriculum runs on the mesh too: the predictor is
replicated (the JAX rules name none of its leaves), each data rank aligns
its own rows (MAS is per row), the duration loss, its MAE and the alignment
quality are global masked means as the CFM loss is, and the predictor's
gradients are summed over ``data``; ``align_durations`` are the rank's
rows. ``DistillTrainer`` has no mesh, as in the JAX package.
"""

from __future__ import annotations

import copy
import itertools
import json
import math
import os
import shutil
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.optim.lr_scheduler import LambdaLR

from eraxvif5tts_tpu_torch.models.cfm import CFM, LossDraws
from eraxvif5tts_tpu_torch.models.modules import fp32_when
from eraxvif5tts_tpu_torch.parallel import mesh as pm

STATE_FILE = "state.pt"
BETAS = (0.9, 0.98)
EPS = 1e-8
WEIGHT_DECAY = 1e-4  # optax adamw's default (torch's is 1e-2)
DUR_WEIGHT_DECAY = 3e-4  # the duration predictor's AdamW (`trainer.py:323-325`)
DUR_LR = 7.5e-5  # its rate when the trainer is given none
# ema_pytorch's defaults, which the reference relies on (`trainer.py:180`)
EMA_BETA = 0.9999
EMA_INV_GAMMA = 1.0
EMA_POWER = 2.0 / 3.0
MU_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16,
             torch.float32: None, torch.bfloat16: torch.bfloat16}


class AdamWBf16Mu(torch.optim.AdamW):
    """AdamW with its first moment stored in bf16 (optax's
    ``adamw(mu_dtype=bfloat16)`` as the JAX trainer's jitted step computes
    it): the new moment is ``(1 - b1) g + bf16(b1) mu``, formed in fp32 and
    used in fp32 for this update, then rounded to bf16 for the next (``b1``
    takes the stored moment's dtype in optax, so 0.9 acts as 0.8984375
    there); the second moment, the bias
    corrections (fp32, as optax's) and the decoupled weight decay are the
    usual ones. The state keeps torch AdamW's keys, so its checkpoints and
    :func:`advance_on_zero_grads` treat both classes alike."""

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamWBf16Mu takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in params:
                if not self.state[p]:
                    self.state[p].update(_zero_state(p, torch.bfloat16))
            grads = [p.grad.float() for p in params]
            mus = [self.state[p]["exp_avg"] for p in params]
            nus = [self.state[p]["exp_avg_sq"] for p in params]
            # optax's (1 - b1) g + b1 mu with mu in bf16: b1 takes mu's dtype (the
            # bf16 0.8984375 for 0.9), and the jitted JAX step keeps the product in fp32
            b1_mu = float(torch.tensor(b1, dtype=torch.bfloat16))
            mu32 = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(mu32, torch._foreach_mul([m.float() for m in mus], b1_mu))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, sq)
            step = self.state[params[0]]["step"] + 1.0
            for p in params:
                self.state[p]["step"] = step.clone()
            count = step.to(torch.float32)
            bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
            bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
            denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2.item()))
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(torch._foreach_div(mu32, bc1.item()), denom)
            torch._foreach_add_(upd, params, alpha=wd)
            torch._foreach_add_(params, upd, alpha=-lr)
            torch._foreach_copy_(mus, mu32)
        return None


def _zero_state(p: torch.Tensor, mu_dtype: Optional[torch.dtype]) -> dict:
    """A fresh AdamW state for ``p``, in torch AdamW's layout."""
    return {"step": torch.tensor(0.0, dtype=torch.float32),
            "exp_avg": torch.zeros_like(p, dtype=mu_dtype or p.dtype),
            "exp_avg_sq": torch.zeros_like(p)}


def advance_on_zero_grads(optimizer: torch.optim.AdamW, scheduler: LambdaLR) -> None:
    """The optax AdamW update on all-zero gradients with its result thrown
    away (the JAX trainer's duration-focus phase, `trainer.py:573-587`):
    every parameter's count rises by one and its moments decay by ``b1`` and
    ``b2`` (``(1 - b) * 0 + b * m``, exactly ``b * m``), the schedule
    advances; the parameters are not touched. ``optimizer.step()`` would
    move them (weight decay, and the momentum the moments hold)."""
    mu_dtype = torch.bfloat16 if isinstance(optimizer, AdamWBf16Mu) else None
    with torch.no_grad():
        for group in optimizer.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                state = optimizer.state[p]
                if not state:
                    state.update(_zero_state(p, mu_dtype))
                state["step"] += 1.0
                state["exp_avg"].mul_(b1)
                state["exp_avg_sq"].mul_(b2)
    with warnings.catch_warnings():
        # the schedule advances with no optimizer.step() of its own, by design
        warnings.filterwarnings("ignore", message="Detected call of `lr_scheduler.step")
        scheduler.step()


@dataclass(frozen=True)
class OptimizerSpec:
    """What :func:`make_optimizer` describes; :meth:`build` makes the torch
    optimizer and schedule once the parameters exist."""

    learning_rate: float
    num_warmup_updates: int
    total_updates: int
    max_grad_norm: float
    decay_type: str
    b1: float = BETAS[0]
    b2: float = BETAS[1]
    mu_dtype: Optional[torch.dtype] = None

    def lr_at(self, count: int) -> float:
        """optax's ``join_schedules`` of the warmup and the decay at ``count``."""
        if count < self.num_warmup_updates:
            warm = max(self.num_warmup_updates, 1)
            return self.learning_rate * min(count, warm) / warm
        steps = max(self.total_updates - self.num_warmup_updates, 1)
        frac = min(count - self.num_warmup_updates, steps) / steps
        if self.decay_type == "linear":
            return self.learning_rate * (1.0 - frac)
        alpha = 1e-8
        return self.learning_rate * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)

    def build(self, params: list[torch.Tensor]) -> tuple[torch.optim.AdamW, LambdaLR]:
        cls = AdamWBf16Mu if self.mu_dtype == torch.bfloat16 else torch.optim.AdamW
        opt = cls(params, lr=self.learning_rate, betas=(self.b1, self.b2), eps=EPS,
                  weight_decay=WEIGHT_DECAY)
        return opt, LambdaLR(opt, lambda count: self.lr_at(count) / self.learning_rate)


def make_optimizer(learning_rate: float = 7.5e-5, num_warmup_updates: int = 20000,
                   total_updates: int = 1_000_000, max_grad_norm: float = 1.0,
                   b1: float = BETAS[0], b2: float = BETAS[1], decay_type: str = "linear",
                   mu_dtype=None) -> OptimizerSpec:
    """Warmup -> decay AdamW, global-norm clipped (`trainer.py:70-104`).
    ``mu_dtype``: None / "float32" (fp32 moments) or "bfloat16" (the first
    moment stored in bf16)."""
    if decay_type not in ("linear", "cosine"):
        raise ValueError(f"decay_type must be 'linear' or 'cosine', got {decay_type!r}")
    if mu_dtype not in MU_DTYPES:
        raise ValueError(f"mu_dtype must be None, 'float32' or 'bfloat16', got {mu_dtype!r}")
    return OptimizerSpec(learning_rate, num_warmup_updates, total_updates, max_grad_norm,
                         decay_type, b1, b2, MU_DTYPES[mu_dtype])


def ema_current_decay(step: int, beta: float, update_after_step: int,
                      inv_gamma: float = EMA_INV_GAMMA, power: float = EMA_POWER) -> float:
    """ema_pytorch's decay warmup: ``1 - (1 + t / inv_gamma)^(-power)`` with
    ``t = step - update_after_step - 1``, clamped to ``[0, beta]``."""
    t = max(step - update_after_step - 1, 0)
    return min(max(1.0 - (1.0 + t / inv_gamma) ** (-power), 0.0), beta)


def _accumulate(acc: list[torch.Tensor], grads: list[torch.Tensor], count: int) -> None:
    """``optax.MultiSteps``' running mean: ``acc += (grads - acc) / (count + 1)``."""
    with torch.no_grad():
        torch._foreach_add_(acc, torch._foreach_div(torch._foreach_sub(grads, acc),
                                                    float(count + 1)))


def _updated(optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    """The tensors an optimizer updates, in order: the parameters, or a
    ZeRO-1 rank's views of its parts of them."""
    return [p for group in optimizer.param_groups for p in group["params"]]


def batch_seed(seed: int, epoch: int, batch_idx: int) -> int:
    """The per-batch generator seed, a function of (seed, epoch, batch) alone
    (the counterpart of ``fold_in(fold_in(rng, epoch), batch)``)."""
    return int(np.random.SeedSequence([seed, epoch, batch_idx]).generate_state(1, np.uint64)[0])


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all the tensors together, fp32, on their device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)).float())


def alignment_quality_metrics(durations: torch.Tensor, phoneme_mask: torch.Tensor,
                              mel_lens: torch.Tensor, weight_sum=None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Coverage and diagonality of a MAS alignment (`trainer.py:219-246`),
    on the device: ``coverage`` is the share of phonemes given at least one
    whole frame, ``diagonal`` is 1 - the mean distance of the phoneme centres
    from the uniform diagonal's, over the mel length; both averaged over the
    samples with a phoneme. They feed :class:`DurationWeightScheduler`.
    ``weight_sum`` maps the count of such samples to the one the means
    divide by (as in ``CFM.loss``)."""
    maskf = phoneme_mask.to(torch.float32)
    ntok = torch.clamp(maskf.sum(dim=1), min=1.0)
    coverage = ((durations >= 1.0).to(torch.float32) * maskf).sum(dim=1) / ntok
    ends = torch.cumsum(durations, dim=-1)
    centers = ends - durations / 2.0
    nt = durations.shape[1]
    idx = torch.arange(nt, device=durations.device, dtype=torch.float32)[None, :]
    mel_f = torch.clamp(mel_lens.to(torch.float32), min=1.0)[:, None]
    diag_centers = (idx + 0.5) * mel_f / ntok[:, None]
    dev = (centers - diag_centers).abs() * maskf
    diagonal = 1.0 - (dev.sum(dim=1) / ntok) / mel_f[:, 0]
    valid = phoneme_mask.any(dim=1).to(torch.float32)
    denom = torch.clamp(valid.sum() if weight_sum is None else weight_sum(valid.sum()), min=1.0)
    return ((coverage * valid).sum() / denom,
            (torch.clamp(diagonal, 0.0, 1.0) * valid).sum() / denom)


@dataclass
class TrainState:
    """The training state: the model's fp32 parameters, their EMA, the
    optimizer and schedule, the count of applied updates and the
    accumulation buffers; with the curriculum, the duration predictor
    (trained), its frozen align copy and its optimizer.
    :meth:`Trainer.train_step` updates it in place."""

    step: int
    model: torch.nn.Module
    ema_params: dict[str, torch.Tensor]
    optimizer: torch.optim.AdamW
    scheduler: LambdaLR
    acc_grads: Optional[list[torch.Tensor]] = None  # running mean of counted micro-batches
    mini_step: int = 0                              # micro-batches counted toward the next update
    dur_predictor: Optional[torch.nn.Module] = None       # the JAX dur_pred_params
    dur_optimizer: Optional[torch.optim.Optimizer] = None  # the JAX dur_opt_state
    dur_align: Optional[torch.nn.Module] = None           # the JAX dur_align_params (frozen)
    dur_acc_grads: Optional[list[torch.Tensor]] = None  # the predictor's running mean
    dur_mini_step: int = 0

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


# ---------------------------------------------------------------------------
# checkpoints (`trainer.py:113-200`)


def _state_dict(state: TrainState) -> dict:
    out = {"step": state.step, "params": state.model.state_dict(),
           "ema_params": state.ema_params, "optimizer": state.optimizer.state_dict(),
           "scheduler": state.scheduler.state_dict(), "acc_grads": state.acc_grads,
           "mini_step": state.mini_step}
    if state.dur_predictor is not None:
        out["dur_pred_params"] = state.dur_predictor.state_dict()
        out["dur_opt_state"] = state.dur_optimizer.state_dict()
        out["dur_acc_grads"] = state.dur_acc_grads
        out["dur_mini_step"] = state.dur_mini_step
    if state.dur_align is not None:
        out["dur_align_params"] = state.dur_align.state_dict()
    return out


def checkpoint_path(checkpoint_dir: str, step: int, last: bool = False) -> str:
    return os.path.abspath(os.path.join(checkpoint_dir, "model_last" if last
                                        else f"model_{step}"))


def checkpoint_save(checkpoint_dir: str, state: TrainState, step: int, last: bool = False,
                    meta: dict | None = None, keep_last_n: int = -1,
                    data: dict | None = None) -> str:
    """Write ``model_{step}`` (or ``model_last``) under ``checkpoint_dir``, its
    ``.meta.json`` sidecar, then rotate; returns the checkpoint's path.
    ``data``: what to write, when not the state's own (a mesh trainer's
    consolidated state)."""
    path = checkpoint_path(checkpoint_dir, step, last)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(_state_dict(state) if data is None else data, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if meta is not None:
        with open(path + ".meta.json", "w", encoding="utf-8") as f:
            json.dump(meta, f)
    checkpoint_rotate(checkpoint_dir, keep_last_n)
    return path


def checkpoint_rotate(checkpoint_dir: str, keep_last_n: int) -> None:
    """keep_last_n rotation; model_last is exempt."""
    if keep_last_n is None or keep_last_n < 0 or not checkpoint_dir:
        return
    entries = []
    for d in os.listdir(checkpoint_dir):
        if d.startswith("model_") and d != "model_last" and not d.endswith(".meta.json"):
            try:
                entries.append((int(d.split("_")[1]), d))
            except ValueError:
                continue
    entries.sort()
    for _, d in entries[: max(len(entries) - keep_last_n, 0)]:
        shutil.rmtree(os.path.join(checkpoint_dir, d), ignore_errors=True)
        meta = os.path.join(checkpoint_dir, d + ".meta.json")
        if os.path.isfile(meta):
            os.remove(meta)


def checkpoint_restore(path: str, state: TrainState,
                       localize: Callable[[dict], dict] | None = None
                       ) -> tuple[TrainState, Optional[dict]]:
    """Load a checkpoint into ``state`` (in place); returns (state, meta or None).
    A state with a duration predictor (and an align copy) needs a checkpoint
    that holds them. ``localize`` turns the loaded one-device state into this
    rank's shards (a mesh trainer's)."""
    path = os.path.abspath(path)
    device = next(state.model.parameters()).device
    data = torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)
    if localize is not None:
        data = localize(data)
    state.model.load_state_dict(data["params"])
    with torch.no_grad():
        for name, ema in state.ema_params.items():
            ema.copy_(data["ema_params"][name])
    state.optimizer.load_state_dict(data["optimizer"])
    state.scheduler.load_state_dict(data["scheduler"])
    state.step = data["step"]
    state.acc_grads = data["acc_grads"]
    state.mini_step = data["mini_step"]
    for module, key in ((state.dur_predictor, "dur_pred_params"),
                        (state.dur_align, "dur_align_params")):
        if module is None:
            continue
        if key not in data:
            raise ValueError(f"{path} holds no duration-predictor state ({key}), which this "
                             "training state carries")
        module.load_state_dict(data[key])
    if state.dur_optimizer is not None:
        state.dur_optimizer.load_state_dict(data["dur_opt_state"])
        state.dur_acc_grads = data.get("dur_acc_grads")
        state.dur_mini_step = data.get("dur_mini_step", 0)
    meta = None
    if os.path.isfile(path + ".meta.json"):
        with open(path + ".meta.json", "r", encoding="utf-8") as f:
            meta = json.load(f)
    return state, meta


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """Newest ``model_*`` in a directory, preferring ``model_last``."""
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return None
    last = os.path.join(checkpoint_dir, "model_last")
    if os.path.isdir(last):
        return last
    steps = []
    for d in os.listdir(checkpoint_dir):
        if d.startswith("model_") and not d.endswith(".meta.json"):
            try:
                steps.append((int(d.split("_")[1]), d))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(checkpoint_dir, max(steps)[1])


# ---------------------------------------------------------------------------


@dataclass
class Trainer:
    """Drives CFM training of ``cfm.transformer`` on its device, with the
    duration-predictor curriculum when ``duration_predictor`` is given and
    the batches carry ``phoneme`` ids."""

    cfm: CFM
    optimizer: OptimizerSpec
    ema_decay: float = EMA_BETA
    ema_update_after_step: int = 100
    ema_update_every: int = 10
    ema_inv_gamma: float = EMA_INV_GAMMA
    ema_power: float = EMA_POWER
    grad_accumulation_steps: int = 1
    checkpoint_dir: Optional[str] = None
    keep_last_n_checkpoints: int = -1
    duration_predictor: Optional[torch.nn.Module] = None  # a models.duration.DurationPredictor
    duration_focus_updates: int = 12000
    # the live phoneme -> index map shared with the collate pipeline, saved in
    # the sidecar and restored in place
    phoneme_map: Optional[dict] = None
    duration_lr: Optional[float] = None  # DUR_LR when None
    # the quality-adaptive duration weight (`trainer.py:289-292`)
    use_adaptive_duration_weight: bool = False
    # a (data, model) DeviceMesh (`parallel/mesh.py` make_mesh); None: one device
    mesh: Any = None
    # ZeRO-1: AdamW moments and the EMA partitioned over the mesh's `data` axis
    zero1: bool = False
    resume_meta: Optional[dict] = field(default=None, init=False)

    def __post_init__(self):
        self._n_data = pm.axis_size(self.mesh, "data")
        self._data_group = pm.axis_group(self.mesh, "data")
        self._model_group = pm.axis_group(self.mesh, "model")
        self._shard = None
        self._full_model = self._last_saved = None
        self.grad_accumulation_steps = max(int(self.grad_accumulation_steps), 1)
        self.alignment_manager = None
        self._phase2_start: Optional[int] = None
        self._current_epoch: Optional[int] = None
        self._dur_weight_sched = None
        self._last_quality = (0.0, 0.0)
        self._steps_per_epoch: Optional[int] = None
        self._mel_proj: Optional[torch.Tensor] = None
        if self.duration_predictor is not None:
            from eraxvif5tts_tpu_torch.training.alignment import AlignmentMethodManager

            self.alignment_manager = AlignmentMethodManager()

    def init_state(self, ema_init: str = "copy") -> TrainState:
        """The state for the transformer's current parameters, put in training
        mode: a fresh optimizer and schedule, the EMA a copy of the parameters
        (``ema_init="zeros"``: zeros, which the first applied update
        overwrites with the parameters while ``step <= ema_update_after_step``).
        With a duration predictor: its current weights moved to the
        transformer's device, a frozen align copy of them and its AdamW."""
        if ema_init not in ("copy", "zeros"):
            raise ValueError(f"ema_init must be 'copy' or 'zeros', got {ema_init!r}")
        model = self.cfm.transformer.train()
        if self.mesh is not None and self._shard is None:
            # every rank starts from rank 0's weights, then keeps its shards
            if pm.process_count(self.mesh) > 1:
                pm.broadcast_flat([p.data for p in model.parameters()], 0, dist.group.WORLD)
            self._shard = pm.shard_model(model, self.mesh)
        params = list(model.parameters())
        targets = self._targets(params)
        opt, sched = self.optimizer.build(targets)
        make = torch.zeros_like if ema_init == "zeros" else torch.clone
        ema = {name: make(t.detach()) for (name, _), t in zip(model.named_parameters(), targets)}
        acc = ([torch.zeros_like(p) for p in params]
               if self.grad_accumulation_steps > 1 else None)
        dur = dur_opt = dur_align = dur_acc = None
        if self.duration_predictor is not None:
            dur = self.duration_predictor.to(params[0].device).eval()
            if self.mesh is not None and pm.process_count(self.mesh) > 1:
                pm.broadcast_flat([p.data for p in dur.parameters()], 0, dist.group.WORLD)
            dur_align = copy.deepcopy(dur).requires_grad_(False)
            dur_opt = torch.optim.AdamW(dur.parameters(), lr=self.duration_lr or DUR_LR,
                                        betas=BETAS, eps=EPS, weight_decay=DUR_WEIGHT_DECAY)
            dur_acc = ([torch.zeros_like(p) for p in dur.parameters()]
                       if self.grad_accumulation_steps > 1 else None)
        return TrainState(step=0, model=model, ema_params=ema, optimizer=opt, scheduler=sched,
                          acc_grads=acc, dur_predictor=dur, dur_optimizer=dur_opt,
                          dur_align=dur_align, dur_acc_grads=dur_acc)

    # ------------------------------------------------------------------

    def _zero1_on(self) -> bool:
        return self.zero1 and self._n_data > 1

    def _targets(self, params: list[torch.Tensor]) -> list[torch.Tensor]:
        """What the optimizer and the EMA update: the parameters, or under
        ZeRO-1 this data rank's part of each (views into them)."""
        if not self._zero1_on():
            return params
        rank = pm.axis_rank(self.mesh, "data")
        return [pm.zero1_chunk(p, self._n_data, rank) for p in params]

    def _apply(self, state: TrainState, grads: list[torch.Tensor],
               norm: torch.Tensor) -> None:
        """Clip ``grads`` (in place) and take one optimizer step, then the EMA
        (under ZeRO-1 on this rank's parts, which every rank then receives)."""
        clip = torch.clamp(self.optimizer.max_grad_norm / norm, max=1.0)
        torch._foreach_mul_(grads, clip)
        params = list(state.model.parameters())
        targets = _updated(state.optimizer)
        for t, g in zip(targets, self._targets(grads)):
            t.grad = g
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        if self._zero1_on():
            for r in range(self._n_data):
                pm.broadcast_flat([pm.zero1_chunk(p, self._n_data, r) for p in params], r,
                                  self._data_group)
        for t in targets:
            t.grad = None
        self._ema_update(state)

    def _ema_update(self, state: TrainState) -> None:
        step = state.step
        take_copy = step <= self.ema_update_after_step
        if not (take_copy or step % self.ema_update_every == 0):
            return
        ema = list(state.ema_params.values())
        params = [p.detach() for p in _updated(state.optimizer)]
        with torch.no_grad():
            if take_copy:
                torch._foreach_copy_(ema, params)
                return
            decay = ema_current_decay(step, self.ema_decay, self.ema_update_after_step,
                                      self.ema_inv_gamma, self.ema_power)
            torch._foreach_mul_(ema, decay)
            torch._foreach_add_(ema, params, alpha=1.0 - decay)

    def _inputs(self, state: TrainState, batch: dict, draws):
        """The step's tensors on the model's device (``phoneme`` None when
        the batch has none), and the loss's count reduction: on a mesh this
        data rank's rows of the padded global batch and of its draws (drawn
        for the whole), and the sum over ``data``."""
        model = state.model
        device = next(model.parameters()).device
        rows, row0, total = (pm.local_rows(self.mesh, batch) if self.mesh is not None
                             else (batch, 0, len(batch["lens"])))
        mel = torch.as_tensor(rows["mel"], device=device)
        text = torch.as_tensor(rows["text"], device=device)
        lens = torch.as_tensor(rows["lens"], device=device)
        phoneme = (torch.as_tensor(rows["phoneme"], device=device)
                   if rows.get("phoneme") is not None else None)
        b, n, d = mel.shape
        if isinstance(draws, torch.Generator):
            draws = LossDraws.sample(draws, total, n, d, model.arch.depth,
                                     self.cfm.frac_lengths_mask)
        if self.mesh is None:
            return mel, text, lens, phoneme, draws, None
        self._shard.batch_offset = row0
        return mel, text, lens, phoneme, draws.rows(row0, row0 + b), self._sum_over_data

    def _sum_over_data(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach().clone()
        if self._data_group is not None:
            dist.all_reduce(t, group=self._data_group)
        return t

    def _grad_norm(self, state: TrainState, grads: list[torch.Tensor]) -> torch.Tensor:
        """The global norm; on a model axis the split leaves' squares are
        summed over it and the replicated ones counted once."""
        if self._model_group is None:
            return global_norm(grads)
        split = state.model.split_params
        names = [name for name, _ in state.model.named_parameters()]
        parts = [[g for name, g in zip(names, grads) if (name in split) == s]
                 for s in (True, False)]
        sq = [global_norm(ts).square() if ts else torch.zeros((), device=grads[0].device)
              for ts in parts]
        dist.all_reduce(sq[0], group=self._model_group)
        return torch.sqrt(sq[0] + sq[1])

    def _finite(self, *values: float) -> bool:
        """One skip decision for every rank of the mesh."""
        finite = all(math.isfinite(v) for v in values)
        if self.mesh is None or pm.process_count(self.mesh) == 1:
            return finite
        flag = torch.tensor([0.0 if finite else 1.0],
                            device=next(self.cfm.transformer.parameters()).device)
        dist.all_reduce(flag)
        return flag.item() == 0.0

    def train_step(self, state: TrainState, batch: dict,
                   draws: Union[LossDraws, torch.Generator]) -> tuple[TrainState, dict]:
        """One micro-batch: ``batch`` = {'mel': [b, n, d], 'text': [b, nt],
        'lens': [b]} (numpy or tensors), and 'phoneme' [b, np] ids for the
        curriculum; ``draws`` the loss's random draws or a generator to draw
        them from. With ``grad_accumulation_steps = k`` the optimizer applies
        on every k-th finite micro-batch. Returns the state (updated in place)
        and the metrics as Python floats: ``loss``, ``grad_norm`` and
        ``applied``; with the curriculum also its losses, the alignment's
        quality, the weight and the MAS durations (``align_durations``, a
        tensor). On a mesh ``batch`` is the global batch (or a
        ``LocalBatch``), ``draws`` are for the global batch padded to a
        multiple of ``data``, and the metrics are the global ones."""
        if self.duration_predictor is not None and batch.get("phoneme") is not None:
            return self._curriculum_step(state, batch, draws)
        model = state.model
        params = list(model.parameters())
        mel, text, lens, _, draws, weight_sum = self._inputs(state, batch, draws)

        model.zero_grad(set_to_none=True)
        # an fp32 model's backward and checkpointed recompute run in full fp32 too
        with fp32_when(model.dtype):
            loss, _, _ = self.cfm.loss(mel, text, lens, draws, weight_sum=weight_sum)
            loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        loss = loss.detach().float()
        if self.mesh is not None:
            pm.all_reduce_flat(grads, self._data_group)
            loss = self._sum_over_data(loss)
        norm = self._grad_norm(state, grads)
        loss_v, norm_v = torch.stack([loss, norm]).tolist()  # one host read
        applied = self._main_update(state, grads, norm, self._finite(loss_v, norm_v))
        model.zero_grad(set_to_none=True)
        return state, {"loss": loss_v, "grad_norm": norm_v, "applied": float(applied)}

    def _main_update(self, state: TrainState, grads: list[torch.Tensor], norm: torch.Tensor,
                     finite: bool) -> bool:
        """A finite micro-batch's gradients: applied (k = 1), or counted into the
        running mean and applied on the k-th (``optax.MultiSteps``); a
        non-finite one is neither. Returns whether an update was applied."""
        if not finite:
            return False
        if self.grad_accumulation_steps == 1:
            self._apply(state, grads, norm)
            return True
        acc = state.acc_grads
        _accumulate(acc, grads, state.mini_step)
        state.mini_step += 1
        if state.mini_step < self.grad_accumulation_steps:
            return False
        self._apply(state, acc, self._grad_norm(state, acc))
        torch._foreach_zero_(acc)
        state.mini_step = 0
        return True

    # ------------------------------------------------------------------
    # the duration-predictor curriculum (`trainer.py:541-642, 704-739`)

    def _curriculum_step(self, state: TrainState, batch: dict, draws) -> tuple[TrainState, dict]:
        from eraxvif5tts_tpu_torch.training.alignment import (
            duration_loss,
            make_mel_proj_matrix,
        )

        step = state.step
        manager = self.alignment_manager
        if manager.phase == 2 and self._phase2_start is None:
            self._phase2_start = step
        algorithm, weight, transitioned = manager.update(
            step, self.duration_focus_updates, self._phase2_start, self._current_epoch)
        if transitioned:
            self._phase2_start = step
            if self._dur_weight_sched is not None:
                self._dur_weight_sched.phase = 2
        if self._dur_weight_sched is not None:
            cov, diag = self._last_quality
            weight = self._dur_weight_sched.step(step, cov, diag, self._current_epoch or 0,
                                                 max(self._steps_per_epoch or 1, 1))
        freeze_main = manager.phase == 1

        model, dur = state.model, state.dur_predictor
        params = list(model.parameters())
        dur_params = list(dur.parameters())
        mel, text, lens, phoneme, draws, weight_sum = self._inputs(state, batch, draws)
        align = state.dur_align
        if self._mel_proj is None:
            self._mel_proj = torch.from_numpy(make_mel_proj_matrix(
                mel.shape[-1], align.text_embed.embedding_dim)).to(mel.device)

        state.optimizer.zero_grad(set_to_none=True)
        state.dur_optimizer.zero_grad(set_to_none=True)
        with fp32_when(model.dtype):
            if freeze_main:
                # the CFM loss forward only, deterministic, for the log
                with torch.no_grad():
                    cfm_loss = self.cfm.loss(mel, text, lens, draws, deterministic=True,
                                             weight_sum=weight_sum)[0]
                d_loss, d_mae, durs = duration_loss(dur, align, self._mel_proj, phoneme, mel,
                                                    lens, algorithm, weight_sum=weight_sum)
                d_loss.backward()
                total = cfm_loss + weight * d_loss.detach()
            else:
                cfm_loss = self.cfm.loss(mel, text, lens, draws, weight_sum=weight_sum)[0]
                d_loss, d_mae, durs = duration_loss(dur, align, self._mel_proj, phoneme, mel,
                                                    lens, algorithm, weight_sum=weight_sum)
                total = cfm_loss + weight * d_loss
                total.backward()
        dur_grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in dur_params]
        if self.mesh is not None:
            pm.all_reduce_flat(dur_grads, self._data_group)
        if freeze_main:
            grads, norm = None, torch.zeros((), device=mel.device)
        else:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            if self.mesh is not None:
                pm.all_reduce_flat(grads, self._data_group)
            norm = self._grad_norm(state, grads)
        coverage, diagonal = alignment_quality_metrics(durs, phoneme > 0, lens, weight_sum)
        # this rank's shares of the global means, summed over `data` on a mesh
        shares = torch.stack([v.detach().float() for v in (
            total, cfm_loss, d_loss, d_mae, coverage, diagonal)])
        if self.mesh is not None:
            shares = self._sum_over_data(shares)
        names = ("loss", "cfm_loss", "duration_loss", "duration_mae", "align_coverage",
                 "align_diagonal", "grad_norm")
        values = torch.cat([shares, torch.stack([norm.float(), global_norm(dur_grads)])]
                           ).tolist()  # one host read
        metrics = dict(zip(names, values))
        dur_norm = values[-1]

        k = self.grad_accumulation_steps
        if freeze_main:
            # the zero gradients count as a micro-batch; the running mean holds
            # zeros through the focus phase, which comes before every full update
            state.mini_step += 1
            applied = state.mini_step == k
            if applied:
                advance_on_zero_grads(state.optimizer, state.scheduler)
                state.step += 1
                self._ema_update(state)
                state.mini_step = 0
        else:
            applied = self._main_update(
                state, grads, norm, self._finite(metrics["loss"], metrics["grad_norm"]))
        if self._finite(metrics["duration_loss"], dur_norm):
            # the predictor's own AdamW, through its own running mean when k > 1
            if k > 1:
                _accumulate(state.dur_acc_grads, dur_grads, state.dur_mini_step)
                state.dur_mini_step += 1
            if k == 1 or state.dur_mini_step == k:
                if k > 1:
                    for p, g in zip(dur_params, state.dur_acc_grads):
                        p.grad = g.clone()
                    torch._foreach_zero_(state.dur_acc_grads)
                    state.dur_mini_step = 0
                state.dur_optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.dur_optimizer.zero_grad(set_to_none=True)
        metrics.update(duration_weight=float(weight), applied=float(applied),
                       align_durations=durs)
        return state, metrics

    def set_steps_per_epoch(self, steps_per_epoch: int) -> None:
        """Arm the epoch-based schedules (the viterbi switch and the cosine
        weight decay need the epoch's length, reference
        `alignment_utils.py:361-435`)."""
        self._steps_per_epoch = steps_per_epoch
        if self.alignment_manager is not None:
            self.alignment_manager.set_steps_per_epoch(steps_per_epoch)

    # ------------------------------------------------------------------

    def train(self, state: TrainState, batches: Iterable[dict] | None = None, seed: int = 0,
              *, epoch_iter: Callable[[int], Iterable[dict]] | None = None, epochs: int = 1,
              start_epoch: int = 0, skip_batches: int = 0, log_every: int = 100,
              save_per_updates: int = 50000, last_per_updates: int = 0,
              log_fn: Callable[[int, dict], None] | None = None,
              sample_fn: Callable[[TrainState, int], None] | None = None,
              tensorboard_dir: Optional[str] = None,
              logger: Optional[str] = None) -> TrainState:
        """Drive the loop over ``batches`` (one pass) or ``epoch_iter(epoch)``
        for ``start_epoch .. epochs - 1``; ``skip_batches`` resumes inside
        ``start_epoch``. Every ``log_every`` updates the scalar metrics go to
        ``log_fn(step, metrics)`` and to the logger (``'tensorboard'`` or
        ``'wandb'``, which falls back to tensorboard, then to none, with a
        printed line; ``tensorboard_dir`` opens a writer whatever the logger),
        and every ``5 * log_every`` updates of the curriculum the alignment
        goes to ``alignments/alignment_{step}.json`` under the checkpoint
        directory; ``sample_fn(state, step)`` runs after each
        ``model_{step}`` save (`trainer.py:743-854`). On a mesh every rank
        runs the loop on the same batches (or its own ``LocalBatch``es) and
        the saves; rank 0 alone logs and samples."""
        main = pm.is_main(self.mesh)
        tb_writer, wandb_run = (self._open_loggers(logger, tensorboard_dir) if main
                                else (None, None))
        k = self.grad_accumulation_steps
        if epoch_iter is None:
            if batches is None:
                raise ValueError("pass `batches` or `epoch_iter`")
            epoch_plan = [(start_epoch, batches)]
            final_epoch = start_epoch
        else:
            epoch_plan = ((e, epoch_iter(e)) for e in range(start_epoch, epochs))
            final_epoch = epochs - 1
        if (self.use_adaptive_duration_weight and self.alignment_manager is not None
                and self._dur_weight_sched is None):
            from eraxvif5tts_tpu_torch.training.alignment import DurationWeightScheduler

            m = self.alignment_manager
            self._dur_weight_sched = DurationWeightScheduler(
                total_epochs=max(epochs, 1), initial_weight=m.initial_dur_weight,
                min_weight=m.target_dur_weight)
            self._dur_weight_sched.phase = m.phase
        device = next(state.model.parameters()).device
        try:
            for epoch, it in epoch_plan:
                self._current_epoch = epoch
                batch_idx = 0
                if epoch == start_epoch and skip_batches:
                    it = itertools.islice(it, skip_batches, None)
                    batch_idx = skip_batches
                for batch in it:
                    gen = torch.Generator(device=device).manual_seed(
                        batch_seed(seed, epoch, batch_idx))
                    state, metrics = self.train_step(state, batch, gen)
                    batch_idx += 1
                    if batch_idx % k:
                        continue
                    step = state.step
                    if step % log_every == 0:
                        if "align_coverage" in metrics:
                            # every rank's weight schedule reads the global quality
                            self._last_quality = (metrics["align_coverage"],
                                                  metrics["align_diagonal"])
                        if main:
                            self._log(step, metrics, batch, log_every, log_fn, tb_writer,
                                      wandb_run)
                    if self.checkpoint_dir and save_per_updates and step % save_per_updates == 0:
                        self.save_checkpoint(state, meta=self._make_meta(epoch, batch_idx))
                        if sample_fn is not None and main:
                            sample_fn(state if self.mesh is None else self._main_view(state),
                                      step)
                    if self.checkpoint_dir and last_per_updates and step % last_per_updates == 0:
                        self.save_checkpoint(state, last=True,
                                             meta=self._make_meta(epoch, batch_idx))
                skip_batches = 0
        finally:
            self._current_epoch = final_epoch
            if tb_writer is not None:
                tb_writer.close()
            if wandb_run is not None:
                wandb_run.finish()
        return state

    def _log(self, step: int, metrics: dict, batch: dict, log_every: int, log_fn,
             tb_writer, wandb_run) -> None:
        scalars = {k: v for k, v in metrics.items() if isinstance(v, float)}
        if (self.checkpoint_dir and "align_durations" in metrics
                and step % (log_every * 5) == 0):
            self._dump_alignment_viz(step, metrics["align_durations"], batch, scalars)
        if log_fn is not None:
            log_fn(step, scalars)
        if tb_writer is not None:
            for name, v in scalars.items():
                tb_writer.add_scalar(name, v, step)
        if wandb_run is not None:
            wandb_run.log(scalars, step=step)

    def _open_loggers(self, logger, tensorboard_dir):
        tb_writer = wandb_run = None
        if logger == "wandb":
            try:
                import wandb

                wandb_run = wandb.init(project="eraxvif5tts-tpu", resume="allow")
            except Exception as e:  # noqa: BLE001 — any wandb failure falls back
                print(f"[trainer] logger='wandb' unavailable ({e}); "
                      "falling back to tensorboard")
                logger = "tensorboard"
        if tensorboard_dir or logger == "tensorboard":
            try:
                from torch.utils.tensorboard import SummaryWriter

                tb_writer = SummaryWriter(tensorboard_dir or "runs")
            except ImportError:
                if logger == "tensorboard":
                    print("[trainer] tensorboard unavailable; scalar logging off")
        return tb_writer, wandb_run

    def _make_meta(self, epoch: int, batch_in_epoch: int) -> dict:
        meta = {"epoch": epoch, "batch_in_epoch": batch_in_epoch,
                "grad_accumulation_steps": self.grad_accumulation_steps}
        if self.alignment_manager is not None:
            meta["alignment"] = {"phase": self.alignment_manager.phase,
                                 "method": self.alignment_manager.current_method,
                                 "phase2_start": self._phase2_start}
        if self._dur_weight_sched is not None:
            s = self._dur_weight_sched
            meta["dur_weight"] = {"ema_cov": s.ema_cov, "ema_diag": s.ema_diag,
                                  "prev_weight": s.prev_weight, "phase": s.phase}
        if self.phoneme_map is not None:
            meta["phoneme_map"] = dict(self.phoneme_map)
        return meta

    def _dump_alignment_viz(self, step: int, durations: torch.Tensor, batch: dict,
                            scalars: dict) -> None:
        """The periodic alignment snapshot the reference dumps as JSON
        (`trainer.py:1272-1277`): the MAS target durations of the batch's
        first two samples and the quality scalars."""
        out_dir = os.path.join(self.checkpoint_dir, "alignments")
        os.makedirs(out_dir, exist_ok=True)
        durs = durations.detach().cpu().numpy()
        phon = np.asarray(batch["phoneme"]) if batch.get("phoneme") is not None else None
        lens = np.asarray(batch["lens"])
        viz = {
            "update": step,
            "method": (self.alignment_manager.current_method
                       if self.alignment_manager is not None else None),
            "coverage": scalars.get("align_coverage"),
            "diagonal": scalars.get("align_diagonal"),
            "duration_weight": scalars.get("duration_weight"),
            "samples": [{"durations": durs[i].tolist(),
                         "phoneme_ids": phon[i].tolist() if phon is not None else None,
                         "mel_len": int(lens[i])}
                        for i in range(min(2, durs.shape[0]))],
        }
        with open(os.path.join(out_dir, f"alignment_{step}.json"), "w",
                  encoding="utf-8") as f:
            json.dump(viz, f, ensure_ascii=False)

    def restore_meta(self, meta: dict) -> tuple[int, int]:
        """Re-arm the curriculum's state machines from a checkpoint's sidecar
        and restore the phoneme map in place; returns (start_epoch,
        skip_batches) for :meth:`train`."""
        align = meta.get("alignment")
        if align and self.alignment_manager is not None:
            self.alignment_manager.phase = align["phase"]
            self.alignment_manager.current_method = align["method"]
            self._phase2_start = align["phase2_start"]
        dw = meta.get("dur_weight")
        if dw and self._dur_weight_sched is not None:
            self._dur_weight_sched.ema_cov = dw["ema_cov"]
            self._dur_weight_sched.ema_diag = dw["ema_diag"]
            self._dur_weight_sched.prev_weight = dw["prev_weight"]
            self._dur_weight_sched.phase = dw["phase"]
        pm = meta.get("phoneme_map")
        if pm and self.phoneme_map is not None:
            # in place: the collate closure holds the same dict object
            self.phoneme_map.clear()
            self.phoneme_map.update(pm)
        return meta.get("epoch", 0), meta.get("batch_in_epoch", 0)

    def save_checkpoint(self, state: TrainState, last: bool = False,
                        meta: dict | None = None) -> str:
        """Write a checkpoint; on a mesh every rank takes part in
        consolidating it and rank 0 writes it in the one-device format."""
        if self.checkpoint_dir is None:
            raise ValueError("save_checkpoint needs a checkpoint_dir")
        if self.mesh is None:
            return checkpoint_save(self.checkpoint_dir, state, state.step, last=last, meta=meta,
                                   keep_last_n=self.keep_last_n_checkpoints)
        data = self._consolidated(state)
        if pm.is_main(self.mesh):
            path = checkpoint_save(self.checkpoint_dir, state, state.step, last=last, meta=meta,
                                   keep_last_n=self.keep_last_n_checkpoints, data=data)
        else:
            path = checkpoint_path(self.checkpoint_dir, state.step, last)
        # the whole weights for rank 0's samples (`_main_view`)
        self._last_saved = ({k: data[k] for k in ("params", "ema_params")}
                            if pm.is_main(self.mesh) else None)
        dist.barrier()
        return path

    def load_checkpoint(self, path: str, state: TrainState) -> TrainState:
        """Restore ``state`` in place from ``path`` (the predictor trio too,
        when the state carries it); its sidecar goes to ``self.resume_meta``
        for :meth:`restore_meta`. On a mesh every rank reads the one-device
        checkpoint and keeps its shards."""
        localize = self._localize if self.mesh is not None else None
        state, self.resume_meta = checkpoint_restore(path, state, localize)
        return state

    # ------------------------------------------------------------------
    # a mesh state <-> the one-device format

    def _layout(self, state: TrainState) -> tuple[list[str], list, list[torch.Size]]:
        """Parameter names, their split dims (None: replicated over
        ``model``) and local shapes."""
        named = list(state.model.named_parameters())
        split = state.model.split_params
        return ([n for n, _ in named], [split.get(n) for n, _ in named],
                [p.shape for _, p in named])

    def _whole(self, tensors: list[torch.Tensor], dims: list) -> list[torch.Tensor]:
        return pm.gather_dims(tensors, dims, self._model_group,
                              pm.axis_size(self.mesh, "model"))

    def _unzero1(self, chunks: list[torch.Tensor], shapes: list) -> list[torch.Tensor]:
        """Local-shard tensors from this rank's ZeRO-1 parts of them."""
        if not self._zero1_on():
            return chunks
        numels = [math.prod(s) for s in shapes]
        return [f.view(s) for f, s in zip(
            pm.gather_zero1(chunks, numels, self._data_group, self._n_data), shapes)]

    def _consolidated(self, state: TrainState) -> dict:
        """The state in the one-device checkpoint format (every rank runs
        the collectives; each ends with the whole)."""
        names, dims, shapes = self._layout(state)
        data = _state_dict(state)
        params = self._whole([p.detach() for p in state.model.parameters()], dims)
        data["params"] = {**data["params"], **dict(zip(names, params))}
        ema = self._unzero1(list(state.ema_params.values()), shapes)
        data["ema_params"] = dict(zip(names, self._whole(ema, dims)))
        opt = data["optimizer"]
        held = [i for i in range(len(names)) if opt["state"].get(i)]
        for key in ("exp_avg", "exp_avg_sq"):
            local = self._unzero1([opt["state"][i][key] for i in held],
                                  [shapes[i] for i in held])
            for i, t in zip(held, self._whole(local, [dims[i] for i in held])):
                opt["state"][i] = {**opt["state"][i], key: t}
        if state.acc_grads is not None:
            data["acc_grads"] = self._whole(state.acc_grads, dims)
        return data

    def _localize(self, data: dict) -> dict:
        """This rank's shards (and ZeRO-1 parts) of a one-device state."""
        state_model = self.cfm.transformer
        split = state_model.split_params
        n_model = pm.axis_size(self.mesh, "model")
        rank = pm.axis_rank(self.mesh, "model")
        drank = pm.axis_rank(self.mesh, "data")
        names = [n for n, _ in state_model.named_parameters()]

        def shard(name, t):
            dim = split.get(name)
            return t if dim is None else t.chunk(n_model, dim)[rank].contiguous()

        def part(name, t):
            t = shard(name, t)
            return pm.zero1_chunk(t, self._n_data, drank).clone() if self._zero1_on() else t

        out = dict(data)
        out["params"] = {k: shard(k, v) for k, v in data["params"].items()}
        out["ema_params"] = {k: part(k, v) for k, v in data["ema_params"].items()}
        opt = dict(data["optimizer"])
        opt["state"] = {i: {k: (v if k == "step" else part(names[i], v)) for k, v in st.items()}
                        for i, st in data["optimizer"]["state"].items()}
        out["optimizer"] = opt
        if data.get("acc_grads") is not None:
            out["acc_grads"] = [shard(n, g) for n, g in zip(names, data["acc_grads"])]
        return out

    def _main_view(self, state: TrainState):
        """What rank 0's samples read: the whole model off the mesh, with
        the weights of the last consolidated save."""
        from types import SimpleNamespace

        data = self._last_saved
        if self._full_model is None:
            self._full_model = pm.unshard_copy(state.model, data["params"])
        else:
            with torch.no_grad():
                for name, p in self._full_model.named_parameters():
                    p.copy_(data["params"][name])
        return SimpleNamespace(step=state.step, model=self._full_model,
                               params=dict(data["params"]), ema_params=data["ema_params"],
                               dur_predictor=None)
