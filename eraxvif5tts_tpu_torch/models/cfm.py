"""Conditional flow matching: the training objective and the Euler ODE
sampler (port of ``CFM.loss`` and ``CFM.sample`` in
`eraxvif5tts_tpu/models/cfm.py`).

As in the JAX package: classifier-free guidance doubles the batch
(``[cond, uncond]``) instead of calling the transformer twice per step; the
text embedding of both branches is computed once, at the bucket length,
before the loop; the sway-warped time grid ``t + s(cos(pi t / 2) - 1 + t)``
gives non-uniform steps; one ``[max_duration, d]`` noise draw is shared by
every sample of the batch (batch-size invariant) and zeroed past each
sample's duration; the prompt region is pasted back at the end.

Noise is an argument: the wrapper draws it from a ``torch.Generator``, the
tests hand in the JAX draw. Likewise every random draw of the loss is an
argument (:class:`LossDraws`): the trainer draws them from the step's
generator, the tests from ``jax.random`` in the JAX order. As in the JAX
package, the loss runs the transformer with no mask: training attention runs
unmasked over the padded frames, and only the loss is masked (to the random
span inside each sample).

``sample`` also takes the JAX sampler's editing inputs: ``edit_mask`` (frames
kept from ``cond``; it narrows the conditioning only, the attention key mask
stays the duration prefix that the serving attention kernel takes),
``no_ref_audio`` (``cond`` zeroed) and ``t_start`` / ``t_inter_cond`` (the
ODE started at an intermediate time from a blended state).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask, mask_from_frac_lengths


@dataclass(frozen=True)
class SamplingConfig:
    """Defaults per the reference `infer/utils_infer.py:57-62`."""

    steps: int = 32
    cfg_strength: float = 2.0
    sway_sampling_coef: Optional[float] = -1.0
    max_duration: int = 4096


def sway_time_grid(steps: int, sway_coef: Optional[float],
                   t_start: float = 0.0) -> torch.Tensor:
    """``steps + 1`` float32 times on [t_start, 1], sway-warped when ``sway_coef``."""
    t = torch.linspace(t_start, 1.0, steps + 1, dtype=torch.float32)
    if sway_coef is not None:
        t = t + sway_coef * (torch.cos(math.pi / 2.0 * t) - 1.0 + t)
    return t


@dataclass(frozen=True)
class LossDraws:
    """The random draws of one :meth:`CFM.loss`, in the order the JAX loss
    takes them from ``jax.random.split(rng, 7)`` (`cfm.py:105-139`)."""

    frac: torch.Tensor        # [b] span fraction, uniform in ``frac_lengths_mask``
    rand: torch.Tensor        # [b] span start, uniform in [0, 1)
    x0: torch.Tensor          # [b, n, d] standard normal noise
    time: torch.Tensor        # [b] flow time, uniform in [0, 1)
    drop_audio: torch.Tensor  # [] uniform: the audio prompt is dropped below audio_drop_prob
    drop_cond: torch.Tensor   # [] uniform: audio and text are dropped below cond_drop_prob
    dropout_keys: Optional[list] = None  # per block, 3 keys of two 32-bit words

    @classmethod
    def sample(cls, generator: torch.Generator, b: int, n: int, d: int, depth: int,
               frac_lengths_mask: tuple[float, float] = (0.7, 1.0)) -> "LossDraws":
        """Every draw from ``generator``, on its device. The dropout keys are
        read back to the host (they seed the kernels): one sync."""
        dev = generator.device

        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        lo, hi = frac_lengths_mask
        frac = uniform(b) * (hi - lo) + lo
        rand = uniform(b)
        x0 = torch.randn((b, n, d), generator=generator, device=dev)
        time = uniform(b)
        drop_audio, drop_cond = uniform(), uniform()
        keys = torch.randint(0, 2**32, (depth, 3, 2), generator=generator, device=dev)
        return cls(frac, rand, x0, time, drop_audio, drop_cond, keys.tolist())

    def rows(self, start: int, stop: int) -> "LossDraws":
        """The draws of rows ``[start, stop)`` of the batch they were drawn
        for (a data rank's share of the global batch's draws)."""
        return dataclasses.replace(self, frac=self.frac[start:stop], rand=self.rand[start:stop],
                                   x0=self.x0[start:stop], time=self.time[start:stop])


class CFM:
    """Stateless objective and sampler around a backbone: a
    :class:`~eraxvif5tts_tpu_torch.models.dit.DiT`, a
    :class:`~eraxvif5tts_tpu_torch.models.unett.UNetT` or a
    :class:`~eraxvif5tts_tpu_torch.models.mmdit.MMDiT`, through their shared
    ``embed_text`` / ``run`` / ``forward`` interface: :meth:`loss` (and so
    ``Trainer.train_step``) calls the backbone's ``forward`` whichever it
    is."""

    audio_drop_prob = 0.35  # reference `cfm.py:42`
    cond_drop_prob = 0.25  # reference `cfm.py:43`
    frac_lengths_mask = (0.7, 1.0)

    def __init__(self, transformer: torch.nn.Module):
        self.transformer = transformer

    @property
    def num_channels(self) -> int:
        return self.transformer.mel_dim

    def loss(self, mel: torch.Tensor, text: torch.Tensor, lens: torch.Tensor,
             draws: LossDraws, deterministic: bool = False, weight_sum=None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Masked-span infilling flow-matching loss of ``mel [b, n, d]`` log-mel
        frames, ``text [b, nt]`` ids (-1 padded) and ``lens [b]``; returns
        (loss, cond, pred). The transformer runs in its own mode
        (``train()`` for the training branch); ``deterministic`` turns its
        dropout off (the JAX ``deterministic=True``; the CFG drops stay, and
        the draws' dropout keys go unused). ``weight_sum`` maps this call's
        count of masked span elements to the one the mean divides by: a data
        rank passes the sum over the global batch, so that the ranks' losses
        add up to the one-device loss (default: this call's own)."""
        b, n, d = mel.shape
        mask = lens_to_mask(lens, n)
        rand_span_mask = mask_from_frac_lengths(lens, draws.frac, n, draws.rand) & mask

        x1 = mel
        t = draws.time[:, None, None]
        xt = (1.0 - t) * draws.x0 + t * x1
        flow = x1 - draws.x0
        cond = x1.masked_fill(rand_span_mask[..., None], 0.0)

        # CFG drops: one draw per step, shared across the batch (`cfm.py:121-127`)
        drop_cond = draws.drop_cond < self.cond_drop_prob
        drop_audio = (draws.drop_audio < self.audio_drop_prob) | drop_cond
        pred = self.transformer(xt, cond, text, draws.time, drop_audio.expand(b),
                                drop_cond.expand(b), dropout_keys=draws.dropout_keys,
                                deterministic=deterministic)

        # mean squared error over (span frames x channels) (`cfm.py:141-144`)
        se = (pred - flow).square()
        weight = rand_span_mask[..., None].to(se.dtype)
        total = weight.sum() if weight_sum is None else weight_sum(weight.sum())
        loss = (se * weight).sum() / torch.clamp(total * d, min=1.0)
        return loss, cond, pred

    @torch.inference_mode()
    def sample(self, cond: torch.Tensor, text: torch.Tensor, duration: torch.Tensor,
               lens: torch.Tensor, noise: torch.Tensor, steps: int = 32,
               cfg_strength: float = 2.0, sway_sampling_coef: Optional[float] = -1.0,
               max_duration: int = 4096, use_cfg: bool = True,
               edit_mask: Optional[torch.Tensor] = None, no_ref_audio: bool = False,
               t_start: float = 0.0,
               t_inter_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Integrate noise -> mel.

        cond ``[b, n_cond, d]`` prompt mel (``n_cond <= max_duration``); text
        ``[b, nt]`` ids, -1 padded; duration / lens ``[b]`` total and prompt
        frames; noise ``[max_duration, d]``, shared by every sample. Returns
        ``[b, max_duration, d]`` float32: zero past each sample's duration,
        the prompt region pasted back from ``cond``.

        ``edit_mask [b, <= max_duration]`` (True = kept) is padded with False
        and ANDed into the prompt mask; ``no_ref_audio`` zeroes ``cond``. With
        ``t_start > 0`` the time grid starts at ``t_start``, and with
        ``t_inter_cond [b, <= max_duration, d]`` the start state is
        ``(1 - t_start) * noise + t_start * t_inter_cond``, masked to each
        duration; without it integration starts from the noise (as the JAX
        sampler: only the pair is the reference's intermediate start). The
        caller passes the step count for the shorter interval."""
        b, n_cond, d = cond.shape
        if d != self.num_channels:
            raise ValueError(f"cond has {d} channels, the model {self.num_channels}")
        device = cond.device
        backbone = self.transformer

        text_lens = (text != -1).sum(dim=-1)
        duration = torch.maximum(torch.maximum(text_lens, lens) + 1, duration)
        duration = duration.clamp(max=max_duration)

        cond = torch.nn.functional.pad(cond.float(), (0, 0, 0, max_duration - n_cond))
        if no_ref_audio:
            cond = torch.zeros_like(cond)
        cond_mask = lens_to_mask(lens, max_duration)
        if edit_mask is not None:
            em = edit_mask.to(device=device, dtype=torch.bool)
            cond_mask = cond_mask & torch.nn.functional.pad(
                em, (0, max_duration - em.shape[-1]))
        step_cond = cond.masked_fill(~cond_mask[..., None], 0.0)
        frame_mask = lens_to_mask(duration, max_duration)

        y = noise.to(device=device, dtype=torch.float32)[None].expand(b, -1, -1)
        y = y.masked_fill(~frame_mask[..., None], 0.0)
        if t_start > 0.0 and t_inter_cond is not None:
            inter = t_inter_cond.to(device=device, dtype=torch.float32)
            inter = torch.nn.functional.pad(inter, (0, 0, 0, max_duration - inter.shape[1]))
            y = (1.0 - t_start) * y + t_start * inter
            y = y.masked_fill(~frame_mask[..., None], 0.0)
        t_grid = sway_time_grid(steps, sway_sampling_coef, t_start)

        false_b = torch.zeros(b, dtype=torch.bool, device=device)
        true_b = torch.ones(b, dtype=torch.bool, device=device)
        te_cond = backbone.embed_text(text, max_duration, false_b)
        if use_cfg and cfg_strength > 1e-5:
            te2 = torch.cat([te_cond, backbone.embed_text(text, max_duration, true_b)])
            cond2 = torch.cat([step_cond, step_cond])
            drop2 = torch.cat([false_b, true_b])
            mask2 = torch.cat([frame_mask, frame_mask])

            def flow(x, t):
                time2 = torch.full((2 * b,), t, dtype=torch.float32, device=device)
                pred2 = backbone.run(torch.cat([x, x]), cond2, te2, time2, drop2, mask2)
                pred, null_pred = pred2[:b], pred2[b:]
                return pred + (pred - null_pred) * cfg_strength
        else:
            def flow(x, t):
                time = torch.full((b,), t, dtype=torch.float32, device=device)
                return backbone.run(x, step_cond, te_cond, time, false_b, frame_mask)

        for i in range(steps):
            dt = float(t_grid[i + 1] - t_grid[i])  # the fp32 difference
            y = y + dt * flow(y, float(t_grid[i]))

        out = torch.where(cond_mask[..., None], cond, y)
        return out.masked_fill(~frame_mask[..., None], 0.0)
