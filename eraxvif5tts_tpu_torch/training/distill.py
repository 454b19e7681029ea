"""Knowledge distillation: frozen teacher DiT -> pruned student (port of
`eraxvif5tts_tpu/training/distill.py`).

Kept from the JAX package:

- one CFM corruption ``(x0, t, xt, cond, span)`` shared by both models; its
  draws come in as :class:`~eraxvif5tts_tpu_torch.models.cfm.LossDraws`, in
  the order the JAX loss takes them from ``jax.random.split(rng, 7)``
  (frac, span, x0, t, drop_audio, drop_cond, dropout);
- the teacher runs in eval mode with no CFG drops and no gradient (the JAX
  ``stop_gradient``): on the card, its attention and FF input projection are
  the serving kernels; the student runs in train mode with the usual CFG
  drops and its attention and position-hash dropout;
- ``total = (1 - alpha) student_mse + alpha distill (mse | l1) +
  spec_l1_weight l1``, each summed over the span's frames and divided by the
  span's frame count (not times the mel channels, as ``CFM.loss`` does);
  ``spec_l1`` is always computed;
- the optional duration loss from a precomputed alignment ``batch['attn']``,
  its predictor trained by its own AdamW (``duration_lr``, 0.9 / 0.98,
  weight decay 3e-4, constant rate, no clipping) and run deterministically;
- the skip tests the loss alone (the main trainer also tests the gradient
  norm): a non-finite loss leaves the student, both optimizers, the schedule
  and ``step`` untouched;
- the EMA decay is the constant ``ema_decay`` (no ramp): a copy while
  ``step <= ema_update_after_step``, then every ``ema_update_every`` steps;
  it is applied after every call, a skipped one too, at the step count then
  current (on a skip the parameters are the previous ones), as the JAX step
  does;
- checkpoints through the main trainer's ``checkpoint_save`` /
  ``checkpoint_restore`` (the predictor and its optimizer in the state), and
  the EMA student exported in the reference key layout, which both packages'
  wrappers load.

Differences, by design: the state is updated in place and a step reads its
losses back to the host once, to decide the skip. The CLI is
`training/distill_cli.py`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Union

import torch
from torch import nn

from eraxvif5tts_tpu_torch.models.cfm import CFM, LossDraws
from eraxvif5tts_tpu_torch.models.modules import fp32_when
from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask, mask_from_frac_lengths
from eraxvif5tts_tpu_torch.training.trainer import (
    BETAS,
    DUR_WEIGHT_DECAY,
    EPS,
    OptimizerSpec,
    TrainState,
    checkpoint_restore,
    checkpoint_save,
    global_norm,
)


@dataclass(frozen=True)
class DistillConfig:
    distill_loss_weight: float = 0.5  # alpha
    distill_loss_type: str = "mse"  # "mse" | "l1"
    spec_l1_weight: float = 0.0
    duration_loss_weight: float = 0.5
    audio_drop_prob: float = 0.35
    cond_drop_prob: float = 0.25
    frac_lengths_mask: tuple[float, float] = (0.7, 1.0)


def distillation_losses(student_cfm: CFM, teacher_transformer: nn.Module, mel: torch.Tensor,
                        text: torch.Tensor, lens: torch.Tensor, draws: LossDraws,
                        config: DistillConfig) -> tuple[torch.Tensor, dict]:
    """The distillation objective of ``mel [b, n, d]``, ``text [b, nt]``
    (-1 padded) and ``lens [b]`` on ``draws``: (total, metrics {loss,
    student_loss, distill_loss, spec_l1}). The student runs in its own mode
    (train mode for the JAX ``deterministic=False``), the teacher as it is
    (eval mode) under ``no_grad``."""
    if config.distill_loss_type not in ("mse", "l1"):
        raise ValueError(f"unsupported distill_loss_type {config.distill_loss_type!r}")
    b, n, _ = mel.shape
    mask = lens_to_mask(lens, n)
    span = mask_from_frac_lengths(lens, draws.frac, n, draws.rand) & mask

    x1 = mel
    t = draws.time[:, None, None]
    xt = (1.0 - t) * draws.x0 + t * x1
    flow = x1 - draws.x0
    cond = x1.masked_fill(span[..., None], 0.0)

    no_drop = torch.zeros(b, dtype=torch.bool, device=mel.device)
    with torch.no_grad():
        teacher_pred = teacher_transformer(xt, cond, text, draws.time, no_drop, no_drop).float()

    drop_cond = draws.drop_cond < config.cond_drop_prob
    drop_audio = (draws.drop_audio < config.audio_drop_prob) | drop_cond
    student_pred = student_cfm.transformer(xt, cond, text, draws.time, drop_audio.expand(b),
                                           drop_cond.expand(b),
                                           dropout_keys=draws.dropout_keys)

    w = span[..., None].to(x1.dtype)
    denom = torch.clamp(span.sum(), min=1).to(x1.dtype)
    student_loss = ((student_pred - flow).square() * w).sum() / denom
    diff = student_pred - teacher_pred
    distill_full = diff.square() if config.distill_loss_type == "mse" else diff.abs()
    distill_loss = (distill_full * w).sum() / denom
    spec_l1 = (diff.abs() * w).sum() / denom

    alpha = config.distill_loss_weight
    total = (1.0 - alpha) * student_loss + alpha * distill_loss + config.spec_l1_weight * spec_l1
    return total, {"loss": total, "student_loss": student_loss,
                   "distill_loss": distill_loss, "spec_l1": spec_l1}


def duration_loss_from_attn(dur_predictor: nn.Module, text: torch.Tensor,
                            text_lens: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Duration loss from a precomputed alignment ``attn [b, nt, frames]``
    (`distill.py:110-123`): the squared error of the predicted log-durations
    against ``log(frames per token)``, summed per sample over its tokens and
    divided by the batch's token count. The -1-padded text ids map to the
    predictor's ``max(text + 1, 0)`` (its torch table's row ``text + 2``)."""
    nt = text.shape[1]
    tmask = (torch.arange(nt, device=text.device)[None, :] < text_lens[:, None]).float()
    logw_target = torch.log(attn.sum(dim=2) + 1e-6) * tmask
    logw = dur_predictor(torch.clamp(text + 1, min=0), tmask > 0)
    per_sample = (logw - logw_target).square().sum(dim=1) / torch.clamp(tmask.sum(), min=1.0)
    return per_sample.sum()


@dataclass
class DistillTrainer:
    """Distillation of ``teacher_transformer`` (eval mode, frozen) into
    ``student_cfm.transformer`` on the student's device, with an optional
    duration predictor trained beside it from ``batch['attn']``."""

    student_cfm: CFM
    teacher_transformer: nn.Module
    optimizer: OptimizerSpec
    config: DistillConfig = DistillConfig()
    ema_decay: float = 0.9999
    ema_update_every: int = 10
    ema_update_after_step: int = 100
    checkpoint_dir: Optional[str] = None
    keep_last_n_checkpoints: int = -1
    duration_predictor: Optional[nn.Module] = None
    duration_lr: float = 3e-5  # the reference gives the predictor 3x the base rate
    resume_meta: Optional[dict] = field(default=None, init=False)

    def __post_init__(self):
        self.teacher_transformer.eval().requires_grad_(False)

    def init_state(self) -> TrainState:
        """The state for the student's and the predictor's current parameters:
        the student in train mode with a fresh optimizer and schedule and its
        EMA a copy; the predictor (deterministic, eval mode) with its own
        AdamW."""
        model = self.student_cfm.transformer.train()
        opt, sched = self.optimizer.build(list(model.parameters()))
        ema = {name: p.detach().clone() for name, p in model.named_parameters()}
        dur = dur_opt = None
        if self.duration_predictor is not None:
            dur = self.duration_predictor.eval()
            dur_opt = torch.optim.AdamW(dur.parameters(), lr=self.duration_lr, betas=BETAS,
                                        eps=EPS, weight_decay=DUR_WEIGHT_DECAY)
        return TrainState(step=0, model=model, ema_params=ema, optimizer=opt, scheduler=sched,
                          dur_predictor=dur, dur_optimizer=dur_opt)

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
            torch._foreach_mul_(ema, self.ema_decay)
            torch._foreach_add_(ema, params, alpha=1.0 - self.ema_decay)

    def train_step(self, state: TrainState, batch: dict,
                   draws: Union[LossDraws, torch.Generator]) -> tuple[TrainState, dict]:
        """One step on ``batch`` = {'mel', 'text', 'lens'} and, with a
        predictor, an optional 'attn' [b, nt, frames] (numpy or tensors);
        ``draws`` the loss's random draws or a generator to draw them from.
        Returns the state (updated in place) and the metrics as Python
        floats: the losses and ``skipped``."""
        model = state.model
        params = list(model.parameters())
        device = params[0].device
        mel = torch.as_tensor(batch["mel"], device=device)
        text = torch.as_tensor(batch["text"], device=device)
        lens = torch.as_tensor(batch["lens"], device=device)
        if isinstance(draws, torch.Generator):
            b, n, d = mel.shape
            draws = LossDraws.sample(draws, b, n, d, model.arch.depth,
                                     self.config.frac_lengths_mask)
        with_duration = state.dur_predictor is not None and batch.get("attn") is not None

        state.optimizer.zero_grad(set_to_none=True)
        # an fp32 student's backward and checkpointed recompute run in full fp32 too
        with fp32_when(model.dtype):
            total, metrics = distillation_losses(self.student_cfm, self.teacher_transformer,
                                                 mel, text, lens, draws, self.config)
            if with_duration:
                state.dur_optimizer.zero_grad(set_to_none=True)
                attn = torch.as_tensor(batch["attn"], device=device, dtype=torch.float32)
                d_loss = duration_loss_from_attn(state.dur_predictor, text,
                                                 (text != -1).sum(dim=-1), attn)
                total = total + self.config.duration_loss_weight * d_loss
                metrics.update(duration_loss=d_loss, loss=total)
            total.backward()
        values = torch.stack([v.detach().float() for v in metrics.values()]).tolist()
        metrics = dict(zip(metrics, values))  # one host read
        ok = math.isfinite(metrics["loss"])
        if ok:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            clip = torch.clamp(self.optimizer.max_grad_norm / global_norm(grads), max=1.0)
            torch._foreach_mul_(grads, clip)
            for p, g in zip(params, grads):
                p.grad = g
            state.optimizer.step()
            state.scheduler.step()
            state.step += 1
            if with_duration:
                state.dur_optimizer.step()
        self._ema_update(state)
        state.optimizer.zero_grad(set_to_none=True)
        if state.dur_optimizer is not None:
            state.dur_optimizer.zero_grad(set_to_none=True)
        metrics["skipped"] = float(not ok)
        return state, metrics

    # ------------------------------------------------------------------
    # checkpointing (the main trainer's primitives)

    def save_checkpoint(self, state: TrainState, last: bool = False,
                        meta: dict | None = None) -> str:
        if self.checkpoint_dir is None:
            raise ValueError("save_checkpoint needs a checkpoint_dir")
        return checkpoint_save(self.checkpoint_dir, state, state.step, last=last, meta=meta,
                               keep_last_n=self.keep_last_n_checkpoints)

    def load_checkpoint(self, path: str, state: TrainState) -> TrainState:
        """Restore ``state`` in place from ``path`` (the predictor too, when
        the state carries one); the sidecar goes to ``self.resume_meta``."""
        state, self.resume_meta = checkpoint_restore(path, state)
        return state

    def export_student_torch(self, state: TrainState, path: str, depth: Optional[int] = None,
                             conv_layers: Optional[int] = None, use_ema: bool = True) -> str:
        """The EMA (or raw) student -> a reference-layout checkpoint
        (``transformer.transformer_blocks.N.*``; ``.pt``, or ``.safetensors``
        where that package is installed) that both packages' wrappers load.
        ``depth`` / ``conv_layers``, when given, must be the student's."""
        from eraxvif5tts_tpu_torch.compression.convert import backbone_state_dict_to_reference
        from eraxvif5tts_tpu_torch.compression.pruner import save_state_dict

        arch = state.model.arch
        for name, want in (("depth", depth), ("conv_layers", conv_layers)):
            if want is not None and want != getattr(arch, name):
                raise ValueError(f"{name}={want} but the student has {getattr(arch, name)}")
        sd = state.model.state_dict()
        if use_ema:
            sd = {**sd, **state.ema_params}
        save_state_dict(backbone_state_dict_to_reference(sd), path)
        return path
