"""TTS-specific from-scratch weight init (port of
`eraxvif5tts_tpu/training/scratch_init.py`; reference `finetune_cli.py:26-97`
``init_weights_tts``).

The JAX rules key on flax parameter paths and compute fans in flax layouts
(dense ``[in, out]``, conv ``[k, in/groups, out]``). The port's parameters
carry the reference torch names and layouts (``Linear`` ``[out, in]``,
``Conv1d`` ``[out, in/groups, k]``), so each parameter's rule is chosen from
its flax counterpart's path (the key rules of `compression/convert.py`;
:data:`DURATION_PATHS` for the duration predictor), the value is drawn in
the flax layout and transposed into the torch one:

- attention projections (``/attn/``): Xavier *normal*, gain 1
- feed-forward (``/ff/``): Xavier *uniform*, gain sqrt(2)
- embeddings: normal(0, 0.02)
- norm scales 1, GRN gamma and every bias 0
- output projections (path contains ``proj`` or the name ``out``): Xavier
  uniform, gain 0.5
- other dense kernels: Xavier uniform, gain 1
- conv kernels: uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))
- the AdaLN-zero modulations and ``proj_out`` stay 0 (the JAX package's
  deliberate deviation from the reference, which re-initialises them and so
  loses the identity blocks).

Each parameter's draws come from a ``torch.Generator`` seeded by the seed
and the crc32 of its flax path (the JAX package folds the path's crc32 into
its key), so the init does not depend on the order of the walk. The
predictor's torch embedding row 0 (the filler row, which no id addresses and
the JAX table does not have) is set to 0.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch
from torch import nn

# Param paths whose zero-init is load-bearing (AdaLN-zero identity blocks).
_KEEP_ZERO = ("attn_norm/linear", "norm_out/linear", "proj_out")

# the duration predictor's torch keys -> (flax path, layout), as the JAX
# package's `duration_params_from_torch` maps them
DURATION_PATHS = {
    "text_embed.weight": ("embed/embedding", "embedding"),
    "conv_1.weight": ("conv_0/kernel", "conv"), "conv_1.bias": ("conv_0/bias", "id"),
    "norm_1.weight": ("norm_0/scale", "id"), "norm_1.bias": ("norm_0/bias", "id"),
    "conv_2.weight": ("conv_1/kernel", "conv"), "conv_2.bias": ("conv_1/bias", "id"),
    "norm_2.weight": ("norm_1/scale", "id"), "norm_2.bias": ("norm_1/bias", "id"),
    "proj.weight": ("proj/kernel", "conv"), "proj.bias": ("proj/bias", "id"),
}


def _fans(shape: tuple[int, ...]) -> tuple[float, float]:
    """Fans of a flax-layout shape (dense [in, out], conv [k..., in, out])."""
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    if len(shape) == 2:
        return float(shape[0]), float(shape[1])
    receptive = float(np.prod(shape[:-2]))
    return receptive * shape[-2], receptive * shape[-1]


def init_rule(path: str, shape: tuple[int, ...]) -> tuple[str, float]:
    """The JAX rule of the flax parameter at ``path`` with flax ``shape``:
    (kind, scale), kind one of ``zeros``, ``ones``, ``normal`` (scale = std)
    or ``uniform`` (scale = bound)."""
    name = path.rsplit("/", 1)[-1]
    if any(z in path for z in _KEEP_ZERO):
        return "zeros", 0.0
    if name in ("bias", "beta", "dwconv_bias", "embed_bias"):
        return "zeros", 0.0
    if name in ("scale", "weight") and len(shape) == 1:  # norms
        return "ones", 1.0
    if name == "gamma":  # GRN gamma is zero-init by design
        return "zeros", 0.0
    if name == "embedding":
        return "normal", 0.02
    lowered = path.lower()
    if len(shape) >= 3:  # conv kernels
        fan_in, _ = _fans(shape)
        return "uniform", 1.0 / math.sqrt(max(fan_in, 1.0))
    fan_in, fan_out = _fans(shape)
    std = math.sqrt(2.0 / (fan_in + fan_out))
    if "/attn/" in path or "attention" in lowered:
        return "normal", std
    if "/ff/" in path or "mlp" in lowered or "feed_forward" in lowered:
        return "uniform", math.sqrt(2.0) * math.sqrt(3.0) * std
    if "proj" in lowered or "out" in name:
        return "uniform", 0.5 * math.sqrt(3.0) * std
    return "uniform", math.sqrt(3.0) * std


def flax_paths(model: nn.Module) -> dict[str, tuple[str, str]]:
    """Each parameter of ``model`` (a backbone with an ``arch`` or a
    duration predictor) -> (its flax path, its layout: ``linear``, ``conv``,
    ``embedding`` or ``id``)."""
    from eraxvif5tts_tpu_torch.compression.convert import _t_conv, _t_linear, backbone_rules
    from eraxvif5tts_tpu_torch.configs import ModelConfig
    from eraxvif5tts_tpu_torch.models.duration import DurationPredictor

    if isinstance(model, DurationPredictor):
        return DURATION_PATHS
    backbone = type(model).__name__
    rules = backbone_rules(ModelConfig(backbone=backbone, arch=model.arch))
    layout = {_t_linear: "linear", _t_conv: "conv"}
    return {key: ("/".join(path), layout.get(fwd, "id")) for key, path, fwd, _ in rules}


def _generator(seed: int, path: str) -> torch.Generator:
    mixed = np.random.SeedSequence([seed, zlib.crc32(path.encode())]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(mixed))


@torch.no_grad()
def init_weights_tts(model: nn.Module, seed: int) -> nn.Module:
    """Re-initialise ``model``'s parameters in place with the TTS scratch rules
    above; returns ``model``."""
    paths = flax_paths(model)
    for key, param in model.named_parameters():
        path, layout = paths[key]
        shape = tuple(param.shape)
        if layout in ("linear", "conv"):
            shape = shape[::-1]  # [out, in] -> [in, out]; [out, in, k] -> [k, in, out]
        elif layout == "embedding":
            shape = (shape[0] - 1,) + shape[1:]  # the JAX table has no filler row
        kind, scale = init_rule(path, shape)
        if kind in ("zeros", "ones"):
            param.fill_(0.0 if kind == "zeros" else 1.0)
            continue
        g = _generator(seed, path)
        if kind == "normal":
            value = scale * torch.randn(shape, generator=g)
        else:
            value = (torch.rand(shape, generator=g) * 2.0 - 1.0) * scale
        if layout in ("linear", "conv"):
            value = value.permute(*reversed(range(value.ndim)))
        elif layout == "embedding":
            value = torch.cat([torch.zeros((1,) + shape[1:]), value])
        param.copy_(value)
    return model
