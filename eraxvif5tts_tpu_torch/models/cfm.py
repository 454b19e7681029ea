"""Conditional flow matching: the Euler ODE sampler (port of ``CFM.sample`` in
`eraxvif5tts_tpu/models/cfm.py`).

As in the JAX package: classifier-free guidance doubles the batch
(``[cond, uncond]``) instead of calling the transformer twice per step; the
text embedding of both branches is computed once, at the bucket length,
before the loop; the sway-warped time grid ``t + s(cos(pi t / 2) - 1 + t)``
gives non-uniform steps; one ``[max_duration, d]`` noise draw is shared by
every sample of the batch (batch-size invariant) and zeroed past each
sample's duration; the prompt region is pasted back at the end.

Noise is an argument: the wrapper draws it from a ``torch.Generator``, the
tests hand in the JAX draw. ``edit_mask``, ``no_ref_audio``, ``t_start`` and
``t_inter_cond`` wait for the speech-edit port; ``CFM.loss`` for the training
port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from eraxvif5tts_tpu_torch.models.dit import DiT
from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask


@dataclass(frozen=True)
class SamplingConfig:
    """Defaults per the reference `infer/utils_infer.py:57-62`."""

    steps: int = 32
    cfg_strength: float = 2.0
    sway_sampling_coef: Optional[float] = -1.0
    max_duration: int = 4096


def sway_time_grid(steps: int, sway_coef: Optional[float]) -> torch.Tensor:
    """``steps + 1`` float32 times on [0, 1], sway-warped when ``sway_coef``."""
    t = torch.linspace(0.0, 1.0, steps + 1, dtype=torch.float32)
    if sway_coef is not None:
        t = t + sway_coef * (torch.cos(math.pi / 2.0 * t) - 1.0 + t)
    return t


class CFM:
    """Stateless sampler around a :class:`DiT`."""

    def __init__(self, transformer: DiT):
        self.transformer = transformer

    @property
    def num_channels(self) -> int:
        return self.transformer.mel_dim

    @torch.inference_mode()
    def sample(self, cond: torch.Tensor, text: torch.Tensor, duration: torch.Tensor,
               lens: torch.Tensor, noise: torch.Tensor, steps: int = 32,
               cfg_strength: float = 2.0, sway_sampling_coef: Optional[float] = -1.0,
               max_duration: int = 4096, use_cfg: bool = True) -> torch.Tensor:
        """Integrate noise -> mel.

        cond ``[b, n_cond, d]`` prompt mel (``n_cond <= max_duration``); text
        ``[b, nt]`` ids, -1 padded; duration / lens ``[b]`` total and prompt
        frames; noise ``[max_duration, d]``, shared by every sample. Returns
        ``[b, max_duration, d]`` float32: zero past each sample's duration,
        the prompt region pasted back from ``cond``."""
        b, n_cond, d = cond.shape
        if d != self.num_channels:
            raise ValueError(f"cond has {d} channels, the model {self.num_channels}")
        device = cond.device
        dit = self.transformer

        text_lens = (text != -1).sum(dim=-1)
        duration = torch.maximum(torch.maximum(text_lens, lens) + 1, duration)
        duration = duration.clamp(max=max_duration)

        cond = torch.nn.functional.pad(cond.float(), (0, 0, 0, max_duration - n_cond))
        cond_mask = lens_to_mask(lens, max_duration)
        step_cond = cond.masked_fill(~cond_mask[..., None], 0.0)
        frame_mask = lens_to_mask(duration, max_duration)

        y = noise.to(device=device, dtype=torch.float32)[None].expand(b, -1, -1)
        y = y.masked_fill(~frame_mask[..., None], 0.0)
        t_grid = sway_time_grid(steps, sway_sampling_coef)

        false_b = torch.zeros(b, dtype=torch.bool, device=device)
        true_b = torch.ones(b, dtype=torch.bool, device=device)
        te_cond = dit.embed_text(text, max_duration, false_b)
        if use_cfg and cfg_strength > 1e-5:
            te2 = torch.cat([te_cond, dit.embed_text(text, max_duration, true_b)])
            cond2 = torch.cat([step_cond, step_cond])
            drop2 = torch.cat([false_b, true_b])
            mask2 = torch.cat([frame_mask, frame_mask])

            def flow(x, t):
                time2 = torch.full((2 * b,), t, dtype=torch.float32, device=device)
                pred2 = dit.run(torch.cat([x, x]), cond2, te2, time2, drop2, mask2)
                pred, null_pred = pred2[:b], pred2[b:]
                return pred + (pred - null_pred) * cfg_strength
        else:
            def flow(x, t):
                time = torch.full((b,), t, dtype=torch.float32, device=device)
                return dit.run(x, step_cond, te_cond, time, false_b, frame_mask)

        for i in range(steps):
            dt = float(t_grid[i + 1] - t_grid[i])  # the fp32 difference
            y = y + dt * flow(y, float(t_grid[i]))

        out = torch.where(cond_mask[..., None], cond, y)
        return out.masked_fill(~frame_mask[..., None], 0.0)
