"""State dicts for the port's modules, from reference checkpoints or from the
JAX package's parameter trees.

The port's own copy of the pure part of
`eraxvif5tts_tpu/compression/convert.py`: checkpoint IO
(:func:`load_state_dict`, :func:`normalize_reference_state_dict`), the key
rules between the reference torch schema and the JAX package's parameter
paths (:func:`dit_rules`, :func:`unett_rules`, :func:`mmdit_rules`,
:func:`vocos_rules`; each rule is ``(torch key, JAX path, forward, inverse)``
with the layout transforms below), :func:`infer_depth`,
:func:`infer_text_num_embeds`, and the *unstacking* direction of the
scan-layout adapters (a scan-stacked JAX tree is accepted; the port never
builds one). BigVGAN has no rule table, as in the JAX package: a reference
generator checkpoint (fresh or weight-normed) is walked key by key
(:func:`bigvgan_state_dict_from_reference`, the counterpart of
`models/bigvgan.py` ``bigvgan_params_from_torch``), and so is the JAX
package's BigVGAN tree (:func:`bigvgan_state_dict_from_jax`).

Weight layout transforms (torch -> JAX; each is its own inverse):

- ``nn.Linear``  [out, in]            -> Dense kernel [in, out]
- ``nn.Conv1d``  [out, in/groups, k]  -> conv kernel  [k, in/groups, out]
- ``nn.Embedding`` / norms / GRN      -> unchanged

The port's modules carry exactly the reference torch key names, so the
state dicts built here load with ``load_state_dict(strict=True)``.

A JAX tree quantized by `quantize_params` (``kernel_q [in, out]`` int8 and
``kernel_scale [out]`` in place of ``kernel`` in the six projections of each
DiT block or UNetT layer, and in an MMDiT block the text stream's four and
both feed-forwards' too) maps to the quantized backbone's
``weight_q [out, in]`` int8 and ``weight_scale``; int8 leaves keep their
dtype, every other leaf is fp32.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Optional

import numpy as np
import torch

from eraxvif5tts_tpu_torch.configs import ModelConfig

StateDict = dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# State-dict IO


def load_state_dict(path: str) -> dict[str, np.ndarray]:
    """Load a ``.pt`` / ``.safetensors`` checkpoint into a flat numpy dict."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return dict(load_file(path))
    raw = torch.load(path, map_location="cpu", weights_only=True)
    # training checkpoints nest the EMA / model dicts (`trainer.py:524-530`)
    if isinstance(raw, dict) and not any(hasattr(v, "numpy") for v in raw.values()):
        for key in ("ema_model_state_dict", "model_state_dict", "state_dict"):
            if key in raw:
                raw = raw[key]
                break
    out = {}
    for k, v in raw.items():
        out[k] = v.numpy() if hasattr(v, "numpy") else np.asarray(v)
    return out


_META_KEYS = {"initted", "step"}
_BUFFER_PATTERNS = (
    re.compile(r"(^|\.)mel_spec\."),
    re.compile(r"(^|\.)rotary_embed\.inv_freq$"),
    re.compile(r"(^|\.)freqs_cis$"),
)


def normalize_reference_state_dict(
    sd: dict[str, np.ndarray], use_ema: bool = True
) -> dict[str, np.ndarray]:
    """Strip EMA/model prefixes, metadata counters, and non-param buffers.

    Mirrors `utils_infer.py:203-217` (EMA key surgery + mel-buffer back-compat
    deletion) and the pruner's prefix cleaning (`...pruner.py:122-163`).
    """
    has_ema = any(k.startswith("ema_model.") for k in sd)
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k in _META_KEYS:
            continue
        if has_ema:
            if use_ema:
                if not k.startswith("ema_model."):
                    continue
                k = k[len("ema_model."):]
            else:
                if k.startswith("ema_model."):
                    continue
        if k.startswith("model."):
            k = k[len("model."):]
        if any(p.search(k) for p in _BUFFER_PATTERNS):
            continue
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# Transforms


def _t_linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _t_conv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 1, 0))


def _t_id(w: np.ndarray) -> np.ndarray:
    return w


# Each entry: (torch key suffix, flax path tuple, forward transform, inverse transform)
Rule = tuple[str, tuple[str, ...], Callable, Callable]


def _convnext_rules(torch_prefix: str, flax_prefix: tuple[str, ...], v2: bool) -> list[Rule]:
    fp = flax_prefix
    rules: list[Rule] = [
        (f"{torch_prefix}.dwconv.weight", fp + ("dwconv_kernel",), _t_conv, _t_conv),
        (f"{torch_prefix}.dwconv.bias", fp + ("dwconv_bias",), _t_id, _t_id),
        (f"{torch_prefix}.norm.weight", fp + ("norm", "scale"), _t_id, _t_id),
        (f"{torch_prefix}.norm.bias", fp + ("norm", "bias"), _t_id, _t_id),
        (f"{torch_prefix}.pwconv1.weight", fp + ("pwconv1", "kernel"), _t_linear, _t_linear),
        (f"{torch_prefix}.pwconv1.bias", fp + ("pwconv1", "bias"), _t_id, _t_id),
        (f"{torch_prefix}.pwconv2.weight", fp + ("pwconv2", "kernel"), _t_linear, _t_linear),
        (f"{torch_prefix}.pwconv2.bias", fp + ("pwconv2", "bias"), _t_id, _t_id),
    ]
    if v2:
        rules += [
            (f"{torch_prefix}.grn.gamma", fp + ("grn", "gamma"), _t_id, _t_id),
            (f"{torch_prefix}.grn.beta", fp + ("grn", "beta"), _t_id, _t_id),
        ]
    else:
        rules += [(f"{torch_prefix}.gamma", fp + ("gamma",), _t_id, _t_id)]
    return rules


def dit_rules(depth: int, conv_layers: int, qk_norm: bool = False,
              long_skip: bool = False) -> list[Rule]:
    """Key map for the DiT backbone (torch side WITHOUT the ``transformer.`` prefix)."""
    rules: list[Rule] = [
        ("time_embed.time_mlp.0.weight", ("time_embed", "mlp_in", "kernel"), _t_linear, _t_linear),
        ("time_embed.time_mlp.0.bias", ("time_embed", "mlp_in", "bias"), _t_id, _t_id),
        ("time_embed.time_mlp.2.weight", ("time_embed", "mlp_out", "kernel"), _t_linear, _t_linear),
        ("time_embed.time_mlp.2.bias", ("time_embed", "mlp_out", "bias"), _t_id, _t_id),
        ("text_embed.text_embed.weight", ("text_embed", "embed", "embedding"), _t_id, _t_id),
        ("input_embed.proj.weight", ("input_embed", "proj", "kernel"), _t_linear, _t_linear),
        ("input_embed.proj.bias", ("input_embed", "proj", "bias"), _t_id, _t_id),
        ("input_embed.conv_pos_embed.conv1d.0.weight",
         ("input_embed", "conv_pos_embed", "conv1", "kernel"), _t_conv, _t_conv),
        ("input_embed.conv_pos_embed.conv1d.0.bias",
         ("input_embed", "conv_pos_embed", "conv1", "bias"), _t_id, _t_id),
        ("input_embed.conv_pos_embed.conv1d.2.weight",
         ("input_embed", "conv_pos_embed", "conv2", "kernel"), _t_conv, _t_conv),
        ("input_embed.conv_pos_embed.conv1d.2.bias",
         ("input_embed", "conv_pos_embed", "conv2", "bias"), _t_id, _t_id),
        ("norm_out.linear.weight", ("norm_out", "linear", "kernel"), _t_linear, _t_linear),
        ("norm_out.linear.bias", ("norm_out", "linear", "bias"), _t_id, _t_id),
        ("proj_out.weight", ("proj_out", "kernel"), _t_linear, _t_linear),
        ("proj_out.bias", ("proj_out", "bias"), _t_id, _t_id),
    ]
    for i in range(conv_layers):
        rules += _convnext_rules(
            f"text_embed.text_blocks.{i}", ("text_embed", f"conv_{i}"), v2=True
        )
    for i in range(depth):
        tb = f"transformer_blocks.{i}"
        blk = f"block_{i}"
        rules += [
            (f"{tb}.attn_norm.linear.weight", (blk, "attn_norm", "linear", "kernel"), _t_linear, _t_linear),
            (f"{tb}.attn_norm.linear.bias", (blk, "attn_norm", "linear", "bias"), _t_id, _t_id),
            (f"{tb}.attn.to_q.weight", (blk, "attn", "to_q", "kernel"), _t_linear, _t_linear),
            (f"{tb}.attn.to_q.bias", (blk, "attn", "to_q", "bias"), _t_id, _t_id),
            (f"{tb}.attn.to_k.weight", (blk, "attn", "to_k", "kernel"), _t_linear, _t_linear),
            (f"{tb}.attn.to_k.bias", (blk, "attn", "to_k", "bias"), _t_id, _t_id),
            (f"{tb}.attn.to_v.weight", (blk, "attn", "to_v", "kernel"), _t_linear, _t_linear),
            (f"{tb}.attn.to_v.bias", (blk, "attn", "to_v", "bias"), _t_id, _t_id),
            (f"{tb}.attn.to_out.0.weight", (blk, "attn", "to_out", "kernel"), _t_linear, _t_linear),
            (f"{tb}.attn.to_out.0.bias", (blk, "attn", "to_out", "bias"), _t_id, _t_id),
            (f"{tb}.ff.ff.0.0.weight", (blk, "ff", "project_in", "kernel"), _t_linear, _t_linear),
            (f"{tb}.ff.ff.0.0.bias", (blk, "ff", "project_in", "bias"), _t_id, _t_id),
            (f"{tb}.ff.ff.2.weight", (blk, "ff", "project_out", "kernel"), _t_linear, _t_linear),
            (f"{tb}.ff.ff.2.bias", (blk, "ff", "project_out", "bias"), _t_id, _t_id),
        ]
        if qk_norm:
            rules += [
                (f"{tb}.attn.q_norm.weight", (blk, "attn", "q_norm", "weight"), _t_id, _t_id),
                (f"{tb}.attn.k_norm.weight", (blk, "attn", "k_norm", "weight"), _t_id, _t_id),
            ]
    if long_skip:
        rules.append(
            ("long_skip_connection.weight", ("long_skip", "kernel"), _t_linear, _t_linear)
        )
    return rules


def unett_rules(depth: int, conv_layers: int, qk_norm: bool = False,
                skip_connect_type: str = "concat") -> list[Rule]:
    """Key map for the UNetT backbone (reference `backbones/unett.py:106-250`;
    torch layers are ``layers.{i}.{0..4}`` = [skip_proj, attn_norm, attn, ff_norm, ff])."""
    rules: list[Rule] = [
        ("time_embed.time_mlp.0.weight", ("time_embed", "mlp_in", "kernel"), _t_linear, _t_linear),
        ("time_embed.time_mlp.0.bias", ("time_embed", "mlp_in", "bias"), _t_id, _t_id),
        ("time_embed.time_mlp.2.weight", ("time_embed", "mlp_out", "kernel"), _t_linear, _t_linear),
        ("time_embed.time_mlp.2.bias", ("time_embed", "mlp_out", "bias"), _t_id, _t_id),
        ("text_embed.text_embed.weight", ("text_embed", "embed", "embedding"), _t_id, _t_id),
        ("input_embed.proj.weight", ("input_embed", "proj", "kernel"), _t_linear, _t_linear),
        ("input_embed.proj.bias", ("input_embed", "proj", "bias"), _t_id, _t_id),
        ("input_embed.conv_pos_embed.conv1d.0.weight",
         ("input_embed", "conv_pos_embed", "conv1", "kernel"), _t_conv, _t_conv),
        ("input_embed.conv_pos_embed.conv1d.0.bias",
         ("input_embed", "conv_pos_embed", "conv1", "bias"), _t_id, _t_id),
        ("input_embed.conv_pos_embed.conv1d.2.weight",
         ("input_embed", "conv_pos_embed", "conv2", "kernel"), _t_conv, _t_conv),
        ("input_embed.conv_pos_embed.conv1d.2.bias",
         ("input_embed", "conv_pos_embed", "conv2", "bias"), _t_id, _t_id),
        ("norm_out.g", ("norm_out", "g"), _t_id, _t_id),
        ("proj_out.weight", ("proj_out", "kernel"), _t_linear, _t_linear),
        ("proj_out.bias", ("proj_out", "bias"), _t_id, _t_id),
    ]
    for i in range(conv_layers):
        rules += _convnext_rules(
            f"text_embed.text_blocks.{i}", ("text_embed", f"conv_{i}"), v2=True
        )
    half = depth // 2
    for i in range(depth):
        tb = f"layers.{i}"
        if skip_connect_type == "concat" and i >= half:
            rules.append((f"{tb}.0.weight", (f"skip_proj_{i}", "kernel"), _t_linear, _t_linear))
        rules += [
            (f"{tb}.1.g", (f"attn_norm_{i}", "g"), _t_id, _t_id),
            (f"{tb}.2.to_q.weight", (f"attn_{i}", "to_q", "kernel"), _t_linear, _t_linear),
            (f"{tb}.2.to_q.bias", (f"attn_{i}", "to_q", "bias"), _t_id, _t_id),
            (f"{tb}.2.to_k.weight", (f"attn_{i}", "to_k", "kernel"), _t_linear, _t_linear),
            (f"{tb}.2.to_k.bias", (f"attn_{i}", "to_k", "bias"), _t_id, _t_id),
            (f"{tb}.2.to_v.weight", (f"attn_{i}", "to_v", "kernel"), _t_linear, _t_linear),
            (f"{tb}.2.to_v.bias", (f"attn_{i}", "to_v", "bias"), _t_id, _t_id),
            (f"{tb}.2.to_out.0.weight", (f"attn_{i}", "to_out", "kernel"), _t_linear, _t_linear),
            (f"{tb}.2.to_out.0.bias", (f"attn_{i}", "to_out", "bias"), _t_id, _t_id),
            (f"{tb}.3.g", (f"ff_norm_{i}", "g"), _t_id, _t_id),
            (f"{tb}.4.ff.0.0.weight", (f"ff_{i}", "project_in", "kernel"), _t_linear, _t_linear),
            (f"{tb}.4.ff.0.0.bias", (f"ff_{i}", "project_in", "bias"), _t_id, _t_id),
            (f"{tb}.4.ff.2.weight", (f"ff_{i}", "project_out", "kernel"), _t_linear, _t_linear),
            (f"{tb}.4.ff.2.bias", (f"ff_{i}", "project_out", "bias"), _t_id, _t_id),
        ]
        if qk_norm:
            rules += [
                (f"{tb}.2.q_norm.weight", (f"attn_{i}", "q_norm", "weight"), _t_id, _t_id),
                (f"{tb}.2.k_norm.weight", (f"attn_{i}", "k_norm", "weight"), _t_id, _t_id),
            ]
    return rules


def mmdit_rules(depth: int, qk_norm: bool = False) -> list[Rule]:
    """Key map for the MMDiT backbone (reference `backbones/mmdit.py:85-189`)."""
    rules: list[Rule] = [
        ("time_embed.time_mlp.0.weight", ("time_embed", "mlp_in", "kernel"), _t_linear, _t_linear),
        ("time_embed.time_mlp.0.bias", ("time_embed", "mlp_in", "bias"), _t_id, _t_id),
        ("time_embed.time_mlp.2.weight", ("time_embed", "mlp_out", "kernel"), _t_linear, _t_linear),
        ("time_embed.time_mlp.2.bias", ("time_embed", "mlp_out", "bias"), _t_id, _t_id),
        ("text_embed.text_embed.weight", ("text_embed", "embed", "embedding"), _t_id, _t_id),
        ("audio_embed.linear.weight", ("audio_embed", "linear", "kernel"), _t_linear, _t_linear),
        ("audio_embed.linear.bias", ("audio_embed", "linear", "bias"), _t_id, _t_id),
        ("audio_embed.conv_pos_embed.conv1d.0.weight",
         ("audio_embed", "conv_pos_embed", "conv1", "kernel"), _t_conv, _t_conv),
        ("audio_embed.conv_pos_embed.conv1d.0.bias",
         ("audio_embed", "conv_pos_embed", "conv1", "bias"), _t_id, _t_id),
        ("audio_embed.conv_pos_embed.conv1d.2.weight",
         ("audio_embed", "conv_pos_embed", "conv2", "kernel"), _t_conv, _t_conv),
        ("audio_embed.conv_pos_embed.conv1d.2.bias",
         ("audio_embed", "conv_pos_embed", "conv2", "bias"), _t_id, _t_id),
        ("norm_out.linear.weight", ("norm_out", "linear", "kernel"), _t_linear, _t_linear),
        ("norm_out.linear.bias", ("norm_out", "linear", "bias"), _t_id, _t_id),
        ("proj_out.weight", ("proj_out", "kernel"), _t_linear, _t_linear),
        ("proj_out.bias", ("proj_out", "bias"), _t_id, _t_id),
    ]
    for i in range(depth):
        tb = f"transformer_blocks.{i}"
        blk = f"block_{i}"
        last = i == depth - 1
        rules += [
            (f"{tb}.attn_norm_c.linear.weight", (blk, "attn_norm_c", "linear", "kernel"), _t_linear, _t_linear),
            (f"{tb}.attn_norm_c.linear.bias", (blk, "attn_norm_c", "linear", "bias"), _t_id, _t_id),
            (f"{tb}.attn_norm_x.linear.weight", (blk, "attn_norm_x", "linear", "kernel"), _t_linear, _t_linear),
            (f"{tb}.attn_norm_x.linear.bias", (blk, "attn_norm_x", "linear", "bias"), _t_id, _t_id),
        ]
        for proj in ("to_q", "to_k", "to_v", "to_q_c", "to_k_c", "to_v_c"):
            rules += [
                (f"{tb}.attn.{proj}.weight", (blk, "attn", proj, "kernel"), _t_linear, _t_linear),
                (f"{tb}.attn.{proj}.bias", (blk, "attn", proj, "bias"), _t_id, _t_id),
            ]
        rules += [
            (f"{tb}.attn.to_out.0.weight", (blk, "attn", "to_out", "kernel"), _t_linear, _t_linear),
            (f"{tb}.attn.to_out.0.bias", (blk, "attn", "to_out", "bias"), _t_id, _t_id),
        ]
        if not last:
            rules += [
                (f"{tb}.attn.to_out_c.weight", (blk, "attn", "to_out_c", "kernel"), _t_linear, _t_linear),
                (f"{tb}.attn.to_out_c.bias", (blk, "attn", "to_out_c", "bias"), _t_id, _t_id),
                (f"{tb}.ff_c.ff.0.0.weight", (blk, "ff_c", "project_in", "kernel"), _t_linear, _t_linear),
                (f"{tb}.ff_c.ff.0.0.bias", (blk, "ff_c", "project_in", "bias"), _t_id, _t_id),
                (f"{tb}.ff_c.ff.2.weight", (blk, "ff_c", "project_out", "kernel"), _t_linear, _t_linear),
                (f"{tb}.ff_c.ff.2.bias", (blk, "ff_c", "project_out", "bias"), _t_id, _t_id),
            ]
        rules += [
            (f"{tb}.ff_x.ff.0.0.weight", (blk, "ff_x", "project_in", "kernel"), _t_linear, _t_linear),
            (f"{tb}.ff_x.ff.0.0.bias", (blk, "ff_x", "project_in", "bias"), _t_id, _t_id),
            (f"{tb}.ff_x.ff.2.weight", (blk, "ff_x", "project_out", "kernel"), _t_linear, _t_linear),
            (f"{tb}.ff_x.ff.2.bias", (blk, "ff_x", "project_out", "bias"), _t_id, _t_id),
        ]
        if qk_norm:
            for norm in ("q_norm", "k_norm", "c_q_norm", "c_k_norm"):
                rules.append(
                    (f"{tb}.attn.{norm}.weight", (blk, "attn", norm, "weight"), _t_id, _t_id)
                )
    return rules


def vocos_rules(num_layers: int = 8) -> list[Rule]:
    rules: list[Rule] = [
        ("backbone.embed.weight", ("embed_kernel",), _t_conv, _t_conv),
        ("backbone.embed.bias", ("embed_bias",), _t_id, _t_id),
        ("backbone.norm.weight", ("norm", "scale"), _t_id, _t_id),
        ("backbone.norm.bias", ("norm", "bias"), _t_id, _t_id),
        ("backbone.final_layer_norm.weight", ("final_layer_norm", "scale"), _t_id, _t_id),
        ("backbone.final_layer_norm.bias", ("final_layer_norm", "bias"), _t_id, _t_id),
        ("head.out.weight", ("head_out", "kernel"), _t_linear, _t_linear),
        ("head.out.bias", ("head_out", "bias"), _t_id, _t_id),
    ]
    for i in range(num_layers):
        rules += _convnext_rules(f"backbone.convnext.{i}", (f"convnext_{i}",), v2=False)
    return rules


def infer_depth(sd: dict[str, np.ndarray]) -> int:
    """Count transformer blocks present in a (normalized) state dict."""
    sd = normalize_reference_state_dict(sd)
    pat = re.compile(r"(?:transformer\.)?transformer_blocks\.(\d+)\.")
    layers = {int(m.group(1)) for k in sd if (m := pat.match(k))}
    return max(layers) + 1 if layers else 0


def infer_text_num_embeds(sd: dict[str, np.ndarray]) -> int:
    """Vocab rows from the text-embedding table (reference `get_embeding_size.py`);
    returns rows - 1 (the +1 filler row is added by the model)."""
    sd = normalize_reference_state_dict(sd)
    for k, v in sd.items():
        if k.endswith("text_embed.text_embed.weight"):
            return v.shape[0] - 1
    raise KeyError("text embedding table not found in checkpoint")


# ---------------------------------------------------------------------------
# scan-layout adapters, unstacking direction only: the JAX package may hand
# over a tree whose blocks are stacked along a leading [depth] axis


def _tree_map(fn, tree):
    """``fn`` over every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def unstack_block_params(params: dict, name: str = "blocks",
                         prefix: str = "block_") -> dict:
    """Stacked `blocks` subtree [depth, ...] -> per-block `block_N` subtrees."""
    if name not in params:
        raise ValueError(f"no stacked '{name}' subtree found to unstack")
    stacked = params[name]
    depths = {x.shape[0] for x in _leaves(stacked)}
    if len(depths) != 1:
        raise ValueError(f"inconsistent leading depth axes {sorted(depths)}")
    out = {k: v for k, v in params.items() if k != name}
    for i in range(depths.pop()):
        out[f"{prefix}{i}"] = _tree_map(lambda x, i=i: x[i], stacked)
    return out


def unstack_unett_params(params: dict, name_down: str = "down_blocks",
                         name_up: str = "up_blocks") -> dict:
    """Stacked UNetT scan subtrees -> the flat per-index layout
    (`attn_3`, `skip_proj_12`, ...)."""
    if name_down not in params or name_up not in params:
        raise ValueError("no stacked UNetT subtrees found to unstack")
    down, up = params[name_down], params[name_up]
    half = {x.shape[0] for x in _leaves(down)} | {x.shape[0] for x in _leaves(up)}
    if len(half) != 1:
        raise ValueError(f"inconsistent leading depth axes {sorted(half)}")
    half = half.pop()
    out = {k: v for k, v in params.items() if k not in (name_down, name_up)}
    for j in range(half):
        for stacked, base in ((down, 0), (up, half)):
            for part, sub in stacked.items():
                out[f"{part}_{base + j}"] = _tree_map(lambda x, j=j: x[j], sub)
    return out


# ---------------------------------------------------------------------------
# the port's state dicts


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


def backbone_rules(cfg: ModelConfig) -> list[Rule]:
    """The key rules of ``cfg``'s backbone at its depth and options."""
    a = cfg.arch
    qk_norm = a.qk_norm == "rms_norm"
    if cfg.backbone == "DiT":
        return dit_rules(a.depth, a.conv_layers, qk_norm=qk_norm,
                         long_skip=a.long_skip_connection)
    if cfg.backbone == "UNetT":
        return unett_rules(a.depth, a.conv_layers, qk_norm=qk_norm)
    if cfg.backbone == "MMDiT":
        return mmdit_rules(a.depth, qk_norm=qk_norm)
    raise ValueError(f"unknown backbone {cfg.backbone!r} (DiT | UNetT | MMDiT)")


def backbone_state_dict_from_jax(params: dict, cfg: ModelConfig) -> dict[str, np.ndarray]:
    """The JAX backbone tree of ``cfg`` (DiT: per-block or scan-stacked; UNetT:
    flat or scan-stacked; MMDiT: per-block; each fp or quantized by
    `quantize_params`) ->
    reference-schema numpy arrays without the ``transformer.`` prefix
    (`backbone_params_to_torch` for fp trees)."""
    from eraxvif5tts_tpu_torch.ops.quant import quantized_weight_keys

    if "blocks" in params:
        params = unstack_block_params(params)
    if "down_blocks" in params:
        params = unstack_unett_params(params)
    rules = backbone_rules(cfg)
    quantized = set(quantized_weight_keys(cfg.arch.depth, cfg.backbone))
    out = {}
    for key, path, _, inverse in rules:
        node = _get(params, path[:-1])
        if key in quantized and "kernel_q" in node:
            stem = key[:-len("weight")]
            out[stem + "weight_q"] = np.asarray(node["kernel_q"]).T
            out[stem + "weight_scale"] = np.asarray(node["kernel_scale"])
        else:
            out[key] = inverse(np.asarray(node[path[-1]]))
    return out


def state_dict_from_jax(params: Optional[dict], vocoder_params: Optional[dict],
                        cfg: ModelConfig, bigvgan_config=None
                        ) -> tuple[Optional[StateDict], Optional[StateDict]]:
    """The JAX wrapper's (backbone, vocoder) parameter trees, numpy or array
    leaves, -> the port's (backbone, vocoder) state dicts; the backbone is
    ``cfg.backbone`` (DiT, UNetT or MMDiT), the vocoder Vocos, or BigVGAN of
    ``bigvgan_config`` when one is given. None passes through."""
    backbone_sd = vocoder_sd = None
    if params is not None:
        backbone_sd = _tensors(backbone_state_dict_from_jax(params, cfg))
    if vocoder_params is not None and bigvgan_config is not None:
        vocoder_sd = bigvgan_state_dict_from_jax(vocoder_params)
    elif vocoder_params is not None:
        num_layers = sum(key.startswith("convnext_") for key in vocoder_params)
        vocoder_sd = _tensors({key: inverse(np.asarray(_get(vocoder_params, path)))
                               for key, path, _, inverse in vocos_rules(num_layers)})
    return backbone_sd, vocoder_sd


def reference_backbone_state_dict(path: str, use_ema: bool = True) -> StateDict:
    """A reference F5-TTS / E2-TTS checkpoint (.pt / .safetensors) -> the
    port backbone's state dict: EMA / model prefixes, counters and buffers
    stripped, then the CFM level ``transformer.`` prefix. The same for every
    backbone: the port's DiT, UNetT and MMDiT carry the reference key names."""
    sd = normalize_reference_state_dict(load_state_dict(path), use_ema=use_ema)
    prefix = "transformer."
    return _tensors({k[len(prefix):] if k.startswith(prefix) else k: v
                     for k, v in sd.items()})


def backbone_state_dict_to_reference(state_dict: StateDict,
                                     with_prefix: bool = True) -> dict[str, np.ndarray]:
    """The port backbone's state dict -> a reference checkpoint's flat layout
    (fp32 numpy arrays, ``transformer.`` prefixed): the counterpart of the
    JAX package's ``dit_params_to_torch``, what a distilled student is
    exported as and what the reference loaders of both packages read."""
    prefix = "transformer." if with_prefix else ""
    return {prefix + k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}


TRAINER_STATE_FILE = "state.pt"  # what `training/trainer.py` `checkpoint_save` writes


def is_trainer_checkpoint(path: str) -> bool:
    """A ``model_*`` directory of the port's trainer, or its state file."""
    return os.path.isdir(path) or os.path.basename(path) == TRAINER_STATE_FILE


def trainer_backbone_state_dict(path: str, use_ema: bool = True) -> StateDict:
    """The backbone's state dict from a checkpoint of the port's own trainer
    (a ``model_*`` directory or its ``state.pt``): the EMA weights when
    present, else (or with ``use_ema=False``) the raw parameters, as the JAX
    wrapper serves its trainer's checkpoints. Buffers the EMA does not carry
    come from the raw state."""
    if os.path.isdir(path):
        path = os.path.join(path, TRAINER_STATE_FILE)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    params = raw.get("params") if isinstance(raw, dict) else None
    ema = raw.get("ema_params") if isinstance(raw, dict) else None
    pick = ema if use_ema and ema else params
    if not pick:
        raise ValueError(f"{path} holds no 'params' / 'ema_params': not a checkpoint of "
                         "this package's trainer")
    return {k: v.detach().float().contiguous() for k, v in {**(params or {}), **pick}.items()}


def reference_vocos_state_dict(path: str, num_layers: int = 8) -> StateDict:
    """A Vocos checkpoint -> port Vocos state dict (the feature extractor and
    the ISTFT window buffer dropped)."""
    sd = load_state_dict(path)
    keys = [rule[0] for rule in vocos_rules(num_layers)]
    return _tensors({k: sd[k] for k in keys if k in sd})


# ---------------------------------------------------------------------------
# BigVGAN (`eraxvif5tts_tpu/models/bigvgan.py:268-346`)


def _fuse_weight_norm(sd: dict, prefix: str) -> np.ndarray | None:
    """weight / (weight_v, weight_g) / parametrizations.* -> fused weight."""
    if f"{prefix}.weight" in sd:
        return np.asarray(sd[f"{prefix}.weight"])
    for gk, vk in ((f"{prefix}.weight_g", f"{prefix}.weight_v"),
                   (f"{prefix}.parametrizations.weight.original0",
                    f"{prefix}.parametrizations.weight.original1")):
        if vk in sd:
            v = np.asarray(sd[vk])
            g = np.asarray(sd[gk])
            norm = np.sqrt((v.reshape(v.shape[0], -1) ** 2).sum(axis=1))
            norm = norm.reshape((-1,) + (1,) * (v.ndim - 1))
            return v * (g / np.maximum(norm, 1e-12))
    return None


def _bigvgan_keys(config) -> tuple[list[str], list[str]]:
    """The BigVGAN module's (convolution prefixes, snake parameter keys) for
    ``config``, in the order of the JAX package's key walk."""
    beta = config.activation == "snakebeta"
    n_k = len(config.resblock_kernel_sizes)

    def act(prefix):
        return [f"{prefix}.act.alpha"] + ([f"{prefix}.act.beta"] if beta else [])

    convs, acts = ["conv_pre", "conv_post"], act("activation_post")
    for i in range(len(config.upsample_rates)):
        convs.append(f"ups.{i}.0")
        for j in range(n_k):
            base = f"resblocks.{i * n_k + j}"
            n_d = len(config.resblock_dilation_sizes[j])
            convs += [f"{base}.convs{c}.{m}" for c in (1, 2) for m in range(n_d)]
            acts += [key for m in range(2 * n_d) for key in act(f"{base}.activations.{m}")]
    return convs, acts


def bigvgan_state_dict_from_reference(sd: dict, config) -> StateDict:
    """A BigVGAN generator state dict (fresh or weight-normed, under a
    ``generator`` key or flat; tensors or numpy) -> the port's
    ``models.bigvgan.BigVGAN`` state dict: weight norm fused, the filter
    buffers dropped (the key walk of ``bigvgan_params_from_torch``)."""
    if "generator" in sd:
        sd = sd["generator"]
    sd = {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in sd.items()}
    convs, acts = _bigvgan_keys(config)
    out = {}
    for prefix in convs:
        w = _fuse_weight_norm(sd, prefix)
        if w is None:
            raise KeyError(f"missing conv weight at {prefix}")
        out[f"{prefix}.weight"] = w
        if f"{prefix}.bias" in sd:
            out[f"{prefix}.bias"] = np.asarray(sd[f"{prefix}.bias"])
    for key in acts:
        out[key] = np.asarray(sd[key])
    return _tensors(out)


def bigvgan_state_dict_from_jax(params: dict) -> StateDict:
    """The JAX package's BigVGAN parameter tree (``bigvgan_params_from_torch``,
    ``BigVGAN.init_random_params``) -> the port's BigVGAN state dict."""
    out: dict[str, np.ndarray] = {}

    def conv(prefix, p):
        out[f"{prefix}.weight"] = _t_conv(np.asarray(p["kernel"]))  # [k, in, out] -> [out, in, k]
        if p.get("bias") is not None:
            out[f"{prefix}.bias"] = np.asarray(p["bias"])

    def act(prefix, p):
        for name, value in p.items():
            out[f"{prefix}.act.{name}"] = np.asarray(value)

    conv("conv_pre", params["conv_pre"])
    conv("conv_post", params["conv_post"])
    act("activation_post", params["activation_post"])
    for i, up in enumerate(params["ups"]):
        out[f"ups.{i}.0.weight"] = np.asarray(up["weight"])  # ConvTranspose1d's [in, out, k]
        out[f"ups.{i}.0.bias"] = np.asarray(up["bias"])
    for r, block in enumerate(params["resblocks"]):
        base = f"resblocks.{r}"
        for c in (1, 2):
            for m, p in enumerate(block[f"convs{c}"]):
                conv(f"{base}.convs{c}.{m}", p)
        for m, p in enumerate(block["acts"]):
            act(f"{base}.activations.{m}", p)
    return _tensors(out)


def load_bigvgan(path: str, config=None):
    """A `bigvgan_generator.pt` (HF nvidia/bigvgan_* layout) -> the port's
    BigVGAN in eval mode on the CPU, its weights loaded strictly."""
    from eraxvif5tts_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig

    config = config or BigVGANConfig()
    raw = torch.load(path, map_location="cpu", weights_only=True)
    model = BigVGAN(config)
    model.load_state_dict(bigvgan_state_dict_from_reference(raw, config), strict=True)
    return model.eval()
