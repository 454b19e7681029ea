"""State dicts for the port's modules, from JAX parameters or reference
checkpoints.

The key rules live in `eraxvif5tts_tpu/compression/convert.py` (jax-free)
and are reused by import: ``dit_rules`` for the DiT, ``vocos_rules`` for the
vocoder. The port's modules carry exactly the reference torch key names, so
the results load with ``load_state_dict(strict=True)``.

A JAX tree quantized by `quantize_params` (``kernel_q [in, out]`` int8 and
``kernel_scale [out]`` in place of ``kernel`` in the six projections of each
block) maps to the quantized DiT's ``weight_q [out, in]`` int8 and
``weight_scale``; int8 leaves keep their dtype, every other leaf is fp32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from eraxvif5tts_tpu.compression.convert import (
    dit_rules,
    load_state_dict,
    normalize_reference_state_dict,
    unstack_block_params,
    vocos_rules,
)
from eraxvif5tts_tpu.configs import ModelConfig
from eraxvif5tts_tpu_torch.ops.quant import quantized_weight_keys

StateDict = dict[str, torch.Tensor]


def _tensors(sd: dict) -> StateDict:
    """numpy / array leaves -> contiguous tensors: int8 kept, the rest fp32."""
    def tensor(v):
        v = np.asarray(v)
        return torch.from_numpy(np.ascontiguousarray(
            v if v.dtype == np.int8 else v.astype(np.float32)))

    return {k: tensor(v) for k, v in sd.items()}


def _get(tree: dict, path: tuple[str, ...]):
    for part in path:
        tree = tree[part]
    return tree


def dit_state_dict_from_jax(params: dict, cfg: ModelConfig) -> dict[str, np.ndarray]:
    """The JAX DiT tree (per-block or scan-stacked, fp or quantized by
    `quantize_params`) -> reference-schema numpy arrays without the
    ``transformer.`` prefix (`backbone_params_to_torch` for fp trees)."""
    if "blocks" in params:
        params = unstack_block_params(params)
    a = cfg.arch
    quantized = set(quantized_weight_keys(a.depth))
    out = {}
    for key, path, _, inverse in dit_rules(a.depth, a.conv_layers,
                                           qk_norm=a.qk_norm == "rms_norm",
                                           long_skip=a.long_skip_connection):
        node = _get(params, path[:-1])
        if key in quantized and "kernel_q" in node:
            stem = key[:-len("weight")]
            out[stem + "weight_q"] = np.asarray(node["kernel_q"]).T
            out[stem + "weight_scale"] = np.asarray(node["kernel_scale"])
        else:
            out[key] = inverse(np.asarray(node[path[-1]]))
    return out


def state_dict_from_jax(params: Optional[dict], vocoder_params: Optional[dict],
                        cfg: ModelConfig) -> tuple[Optional[StateDict], Optional[StateDict]]:
    """The JAX wrapper's (DiT, Vocos) parameter trees, numpy or array leaves,
    -> the port's (DiT, Vocos) state dicts; None passes through."""
    dit_sd = vocos_sd = None
    if params is not None:
        dit_sd = _tensors(dit_state_dict_from_jax(params, cfg))
    if vocoder_params is not None:
        num_layers = sum(key.startswith("convnext_") for key in vocoder_params)
        vocos_sd = _tensors({key: inverse(np.asarray(_get(vocoder_params, path)))
                             for key, path, _, inverse in vocos_rules(num_layers)})
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
