"""State dicts for the port's modules, from JAX parameters or reference
checkpoints.

The key rules live in `eraxvif5tts_tpu/compression/convert.py` (jax-free)
and are reused by import: ``backbone_params_to_torch`` (``dit_rules``) for the
DiT, ``vocos_rules`` for the vocoder. The port's modules carry exactly the
reference torch key names, so the results load with
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from eraxvif5tts_tpu.compression.convert import (
    backbone_params_to_torch,
    load_state_dict,
    normalize_reference_state_dict,
    vocos_rules,
)
from eraxvif5tts_tpu.configs import ModelConfig

StateDict = dict[str, torch.Tensor]


def _tensors(sd: dict) -> StateDict:
    return {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v, dtype=np.float32)))
            for k, v in sd.items()}


def state_dict_from_jax(params: Optional[dict], vocoder_params: Optional[dict],
                        cfg: ModelConfig) -> tuple[Optional[StateDict], Optional[StateDict]]:
    """The JAX wrapper's (DiT, Vocos) parameter trees, numpy or array leaves,
    -> the port's (DiT, Vocos) state dicts; None passes through."""
    dit_sd = vocos_sd = None
    if params is not None:
        a = cfg.arch
        dit_sd = _tensors(backbone_params_to_torch(
            params, "DiT", a.depth, a.conv_layers, qk_norm=a.qk_norm == "rms_norm",
            long_skip=a.long_skip_connection, with_prefix=False))
    if vocoder_params is not None:
        num_layers = sum(key.startswith("convnext_") for key in vocoder_params)
        out = {}
        for key, path, _, inverse in vocos_rules(num_layers):
            node = vocoder_params
            for part in path:
                node = node[part]
            out[key] = inverse(np.asarray(node))
        vocos_sd = _tensors(out)
    return dit_sd, vocos_sd


def reference_dit_state_dict(path: str, use_ema: bool = True) -> StateDict:
    """A reference F5-TTS checkpoint (.pt / .safetensors) -> port DiT state
    dict: EMA / model prefixes, counters and buffers stripped, then the CFM
    level ``transformer.`` prefix."""
    sd = normalize_reference_state_dict(load_state_dict(path), use_ema=use_ema)
    prefix = "transformer."
    return _tensors({k[len(prefix):] if k.startswith(prefix) else k: v
                     for k, v in sd.items()})


def reference_vocos_state_dict(path: str, num_layers: int = 8) -> StateDict:
    """A Vocos checkpoint -> port Vocos state dict (the feature extractor and
    the ISTFT window buffer dropped)."""
    sd = load_state_dict(path)
    keys = [rule[0] for rule in vocos_rules(num_layers)]
    return _tensors({k: sd[k] for k in keys if k in sd})
