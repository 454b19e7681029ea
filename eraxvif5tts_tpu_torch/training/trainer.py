"""CFM trainer (port of `eraxvif5tts_tpu/training/trainer.py`).

Kept from the JAX package:

- AdamW (0.9, 0.98), eps 1e-8, weight decay 1e-4 (optax's ``adamw`` default;
  torch's is 1e-2), with a linear warmup from 0 then a linear (or cosine)
  decay, evaluated at the count of updates applied before the current one
  (the first update has lr 0 when there is a warmup), and global-norm
  clipping with optax's formula (no epsilon on the norm);
- gradient accumulation with ``optax.MultiSteps(every_k, skip_not_finite)``
  semantics: the running mean of the finite micro-batch gradients, applied on
  the k-th counted one; a non-finite micro-batch is neither counted nor added;
- the NaN/Inf skip: a step whose loss or gradient norm is not finite leaves
  the parameters, the optimizer, the schedule and ``step`` untouched;
- an fp32 EMA of the parameters, updated on applied updates only (a copy
  while ``step <= ema_update_after_step``, then every ``ema_update_every``);
- checkpoints ``model_{step}`` / ``model_last`` with the ``.meta.json``
  sidecar, ``keep_last_n`` rotation that spares ``model_last``, and
  mid-epoch resume: the per-batch generator is seeded from (seed, epoch,
  batch index), so a resumed run repeats the loss trajectory.

Differences, by design: the state is updated in place (the JAX ``TrainState``
is an immutable pytree returned anew each step); a step reads its loss and
gradient norm back to the host once, to decide the skip; checkpoints are
``torch.save`` files (Orbax is JAX-only). A state may also carry a duration
predictor and its optimizer (``dur_predictor`` / ``dur_optimizer``, the JAX
``dur_pred_params`` / ``dur_opt_state``; the distillation trainer of
`training/distill.py` fills them): checkpoints then carry them too, and a
state without them saves and restores as before. Not ported (ROADMAP.md): the
duration-predictor curriculum, meshes and ZeRO-1, loggers, ``mu_dtype``.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import shutil
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional, Union

import numpy as np
import torch
from torch.optim.lr_scheduler import LambdaLR

from eraxvif5tts_tpu_torch.models.cfm import CFM, LossDraws
from eraxvif5tts_tpu_torch.models.modules import fp32_when

STATE_FILE = "state.pt"
BETAS = (0.9, 0.98)
EPS = 1e-8
WEIGHT_DECAY = 1e-4  # optax adamw's default (torch's is 1e-2)
# ema_pytorch's defaults, which the reference relies on (`trainer.py:180`)
EMA_BETA = 0.9999
EMA_INV_GAMMA = 1.0
EMA_POWER = 2.0 / 3.0


@dataclass(frozen=True)
class OptimizerSpec:
    """What :func:`make_optimizer` describes; :meth:`build` makes the torch
    optimizer and schedule once the parameters exist."""

    learning_rate: float
    num_warmup_updates: int
    total_updates: int
    max_grad_norm: float
    decay_type: str

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
        opt = torch.optim.AdamW(params, lr=self.learning_rate, betas=BETAS, eps=EPS,
                                weight_decay=WEIGHT_DECAY)
        return opt, LambdaLR(opt, lambda count: self.lr_at(count) / self.learning_rate)


def make_optimizer(learning_rate: float = 7.5e-5, num_warmup_updates: int = 20000,
                   total_updates: int = 1_000_000, max_grad_norm: float = 1.0,
                   decay_type: str = "linear") -> OptimizerSpec:
    """Warmup -> decay AdamW, global-norm clipped (`trainer.py:70-104`)."""
    if decay_type not in ("linear", "cosine"):
        raise ValueError(f"decay_type must be 'linear' or 'cosine', got {decay_type!r}")
    return OptimizerSpec(learning_rate, num_warmup_updates, total_updates, max_grad_norm,
                         decay_type)


def ema_current_decay(step: int, update_after_step: int) -> float:
    """ema_pytorch's decay warmup: ``1 - (1 + t / inv_gamma)^(-power)`` with
    ``t = step - update_after_step - 1``, clamped to ``[0, beta]``."""
    t = max(step - update_after_step - 1, 0)
    return min(max(1.0 - (1.0 + t / EMA_INV_GAMMA) ** (-EMA_POWER), 0.0), EMA_BETA)


def batch_seed(seed: int, epoch: int, batch_idx: int) -> int:
    """The per-batch generator seed, a function of (seed, epoch, batch) alone
    (the counterpart of ``fold_in(fold_in(rng, epoch), batch)``)."""
    return int(np.random.SeedSequence([seed, epoch, batch_idx]).generate_state(1, np.uint64)[0])


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all the tensors together, fp32, on their device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)).float())


@dataclass
class TrainState:
    """The training state: the model's fp32 parameters, their EMA, the
    optimizer and schedule, the count of applied updates and the
    accumulation buffers. :meth:`Trainer.train_step` updates it in place."""

    step: int
    model: torch.nn.Module
    ema_params: dict[str, torch.Tensor]
    optimizer: torch.optim.AdamW
    scheduler: LambdaLR
    acc_grads: Optional[list[torch.Tensor]] = None  # running mean of counted micro-batches
    mini_step: int = 0                              # micro-batches counted toward the next update
    dur_predictor: Optional[torch.nn.Module] = None       # trained beside the model (distillation)
    dur_optimizer: Optional[torch.optim.Optimizer] = None

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
    return out


def checkpoint_save(checkpoint_dir: str, state: TrainState, step: int, last: bool = False,
                    meta: dict | None = None, keep_last_n: int = -1) -> str:
    """Write ``model_{step}`` (or ``model_last``) under ``checkpoint_dir``, its
    ``.meta.json`` sidecar, then rotate; returns the checkpoint's path."""
    path = os.path.abspath(os.path.join(checkpoint_dir, "model_last" if last
                                        else f"model_{step}"))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(_state_dict(state), tmp)
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


def checkpoint_restore(path: str, state: TrainState) -> tuple[TrainState, Optional[dict]]:
    """Load a checkpoint into ``state`` (in place); returns (state, meta or None)."""
    path = os.path.abspath(path)
    device = next(state.model.parameters()).device
    data = torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)
    state.model.load_state_dict(data["params"])
    with torch.no_grad():
        for name, ema in state.ema_params.items():
            ema.copy_(data["ema_params"][name])
    state.optimizer.load_state_dict(data["optimizer"])
    state.scheduler.load_state_dict(data["scheduler"])
    state.step = data["step"]
    state.acc_grads = data["acc_grads"]
    state.mini_step = data["mini_step"]
    if state.dur_predictor is not None:
        if "dur_pred_params" not in data:
            raise ValueError(f"{path} holds no duration-predictor state, which this "
                             "training state carries")
        state.dur_predictor.load_state_dict(data["dur_pred_params"])
        state.dur_optimizer.load_state_dict(data["dur_opt_state"])
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
    """Drives CFM training of ``cfm.transformer`` on its device."""

    cfm: CFM
    optimizer: OptimizerSpec
    ema_update_after_step: int = 100
    ema_update_every: int = 10
    grad_accumulation_steps: int = 1
    checkpoint_dir: Optional[str] = None
    keep_last_n_checkpoints: int = -1
    duration_predictor: Any = None
    resume_meta: Optional[dict] = field(default=None, init=False)

    def __post_init__(self):
        if self.duration_predictor is not None:
            raise NotImplementedError("the duration-predictor curriculum is not ported "
                                      "(ROADMAP.md)")
        self.grad_accumulation_steps = max(int(self.grad_accumulation_steps), 1)

    def init_state(self) -> TrainState:
        """The state for the transformer's current parameters, put in training
        mode: a fresh optimizer and schedule, the EMA a copy of the parameters."""
        model = self.cfm.transformer.train()
        params = list(model.parameters())
        opt, sched = self.optimizer.build(params)
        ema = {name: p.detach().clone() for name, p in model.named_parameters()}
        acc = ([torch.zeros_like(p) for p in params]
               if self.grad_accumulation_steps > 1 else None)
        return TrainState(step=0, model=model, ema_params=ema, optimizer=opt, scheduler=sched,
                          acc_grads=acc)

    # ------------------------------------------------------------------

    def _apply(self, state: TrainState, grads: list[torch.Tensor],
               norm: torch.Tensor) -> None:
        """Clip ``grads`` (in place) and take one optimizer step, then the EMA."""
        clip = torch.clamp(self.optimizer.max_grad_norm / norm, max=1.0)
        torch._foreach_mul_(grads, clip)
        for p, g in zip(state.model.parameters(), grads):
            p.grad = g
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        self._ema_update(state)

    def _ema_update(self, state: TrainState) -> None:
        step = state.step
        take_copy = step <= self.ema_update_after_step
        if not (take_copy or step % self.ema_update_every == 0):
            return
        ema = list(state.ema_params.values())
        params = [p.detach() for p in state.model.parameters()]
        with torch.no_grad():
            if take_copy:
                torch._foreach_copy_(ema, params)
                return
            decay = ema_current_decay(step, self.ema_update_after_step)
            torch._foreach_mul_(ema, decay)
            torch._foreach_add_(ema, params, alpha=1.0 - decay)

    def train_step(self, state: TrainState, batch: dict,
                   draws: Union[LossDraws, torch.Generator]) -> tuple[TrainState, dict]:
        """One micro-batch: ``batch`` = {'mel': [b, n, d], 'text': [b, nt],
        'lens': [b]} (numpy or tensors); ``draws`` the loss's random draws or
        a generator to draw them from. With ``grad_accumulation_steps = k``
        the optimizer applies on every k-th finite micro-batch. Returns the
        state (updated in place) and the metrics ``loss``, ``grad_norm`` and
        ``applied`` as Python floats."""
        model = state.model
        params = list(model.parameters())
        device = params[0].device
        mel = torch.as_tensor(batch["mel"], device=device)
        text = torch.as_tensor(batch["text"], device=device)
        lens = torch.as_tensor(batch["lens"], device=device)
        if isinstance(draws, torch.Generator):
            b, n, d = mel.shape
            draws = LossDraws.sample(draws, b, n, d, model.arch.depth,
                                     self.cfm.frac_lengths_mask)

        state.optimizer.zero_grad(set_to_none=True)
        # an fp32 model's backward and checkpointed recompute run in full fp32 too
        with fp32_when(model.dtype):
            loss, _, _ = self.cfm.loss(mel, text, lens, draws)
            loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        norm = global_norm(grads)
        loss_v, norm_v = torch.stack([loss.detach().float(), norm]).tolist()  # one host read
        applied = math.isfinite(loss_v) and math.isfinite(norm_v)
        if applied and self.grad_accumulation_steps > 1:
            acc = state.acc_grads
            with torch.no_grad():
                torch._foreach_add_(acc, torch._foreach_div(torch._foreach_sub(grads, acc),
                                                            float(state.mini_step + 1)))
            state.mini_step += 1
            applied = state.mini_step == self.grad_accumulation_steps
            if applied:
                self._apply(state, acc, global_norm(acc))
                torch._foreach_zero_(acc)
                state.mini_step = 0
        elif applied:
            self._apply(state, grads, norm)
        state.optimizer.zero_grad(set_to_none=True)
        return state, {"loss": loss_v, "grad_norm": norm_v, "applied": float(applied)}

    # ------------------------------------------------------------------

    def train(self, state: TrainState, batches: Iterable[dict] | None = None, seed: int = 0,
              *, epoch_iter: Callable[[int], Iterable[dict]] | None = None, epochs: int = 1,
              start_epoch: int = 0, skip_batches: int = 0, log_every: int = 100,
              save_per_updates: int = 50000, last_per_updates: int = 0,
              log_fn: Callable[[int, dict], None] | None = None,
              sample_fn: Callable[[TrainState, int], None] | None = None) -> TrainState:
        """Drive the loop over ``batches`` (one pass) or ``epoch_iter(epoch)``
        for ``start_epoch .. epochs - 1``; ``skip_batches`` resumes inside
        ``start_epoch``. ``log_fn(step, metrics)`` runs every ``log_every``
        updates, ``sample_fn(state, step)`` after each ``model_{step}`` save
        (`trainer.py:743-854`)."""
        k = self.grad_accumulation_steps
        device = next(state.model.parameters()).device
        if epoch_iter is None:
            if batches is None:
                raise ValueError("pass `batches` or `epoch_iter`")
            epoch_plan = [(start_epoch, batches)]
        else:
            epoch_plan = ((e, epoch_iter(e)) for e in range(start_epoch, epochs))
        for epoch, it in epoch_plan:
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
                if log_fn is not None and step % log_every == 0:
                    log_fn(step, metrics)
                if self.checkpoint_dir and save_per_updates and step % save_per_updates == 0:
                    self.save_checkpoint(state, meta=self._make_meta(epoch, batch_idx))
                    if sample_fn is not None:
                        sample_fn(state, step)
                if self.checkpoint_dir and last_per_updates and step % last_per_updates == 0:
                    self.save_checkpoint(state, last=True, meta=self._make_meta(epoch, batch_idx))
            skip_batches = 0
        return state

    def _make_meta(self, epoch: int, batch_in_epoch: int) -> dict:
        return {"epoch": epoch, "batch_in_epoch": batch_in_epoch,
                "grad_accumulation_steps": self.grad_accumulation_steps}

    def restore_meta(self, meta: dict) -> tuple[int, int]:
        """(start_epoch, skip_batches) for :meth:`train` from a checkpoint's sidecar."""
        return meta.get("epoch", 0), meta.get("batch_in_epoch", 0)

    def save_checkpoint(self, state: TrainState, last: bool = False,
                        meta: dict | None = None) -> str:
        if self.checkpoint_dir is None:
            raise ValueError("save_checkpoint needs a checkpoint_dir")
        return checkpoint_save(self.checkpoint_dir, state, state.step, last=last, meta=meta,
                               keep_last_n=self.keep_last_n_checkpoints)

    def load_checkpoint(self, path: str, state: TrainState) -> TrainState:
        """Restore ``state`` in place from ``path``; its sidecar goes to
        ``self.resume_meta`` for :meth:`restore_meta`."""
        state, self.resume_meta = checkpoint_restore(path, state)
        return state
