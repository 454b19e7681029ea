"""Layer-pruning toolkit: checkpoint surgery to produce 14/12-layer students
(the port's own copy of `eraxvif5tts_tpu/compression/pruner.py`).

Parity with reference `src/model_pruning/excellent_definitive-f5tts-pruner.py`:
- per-block importance = 0.4*norm-entropy + 0.3*norm-magnitude + 0.3*SNR over
  weight histograms (`:540-575`), position-based U-shape fallback (`:400-420`);
- selection always keeps the first 2 and last 2 blocks, fills the rest with the
  top-scored middle blocks (`:697-700`); manual block list mode (`--manual_blocks`);
- pruned state dict re-indexes kept blocks sequentially (`:721-760`);
- ``test_pruned_model`` smoke-loads the result into a fresh model (`:1062`):
  here the port's own backbone, strict, built on the ``meta`` device (shapes
  and names are checked, no weight memory is taken).

Pure numpy over flat (torch-layout) state dicts, so it operates on reference
checkpoints and on the port's exported ones identically.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

import numpy as np

from eraxvif5tts_tpu_torch.compression.convert import (
    infer_depth,
    infer_text_num_embeds,
    load_state_dict,
    normalize_reference_state_dict,
)

_BLOCK_RE = re.compile(r"^(transformer\.)?transformer_blocks\.(\d+)\.")


@dataclass
class PruneReport:
    block_scores: list[tuple[int, float]] = field(default_factory=list)
    blocks_to_keep: list[int] = field(default_factory=list)
    params_before: int = 0
    params_after: int = 0
    used_fallback: bool = False


def _position_fallback_scores(n_blocks: int) -> list[tuple[int, float]]:
    """U-shaped position prior (`...pruner.py:400-420`)."""
    scores = []
    for i in range(n_blocks):
        if i < 2:
            s = 1.0 - i * 0.05
        elif i >= n_blocks - 2:
            s = 0.9 - (n_blocks - i - 1) * 0.05
        else:
            rel = i / (n_blocks - 1)
            s = 0.5 + 0.3 * (1 - 4 * (rel - 0.5) ** 2)
        scores.append((i, float(s)))
    return scores


def block_importance_scores(sd: dict[str, np.ndarray]) -> tuple[list[tuple[int, float]], bool]:
    """Per-block importance scores; returns (scores, used_fallback)."""
    sd = normalize_reference_state_dict(sd)
    n_blocks = infer_depth(sd)
    if n_blocks == 0:
        raise ValueError("no transformer blocks found in state dict")

    diversity: dict[int, list[float]] = {i: [] for i in range(n_blocks)}
    magnitude: dict[int, list[float]] = {i: [] for i in range(n_blocks)}
    noise: dict[int, list[float]] = {i: [] for i in range(n_blocks)}

    for key, tensor in sd.items():
        m = _BLOCK_RE.match(key)
        if not m or not ("weight" in key or "bias" in key):
            continue
        idx = int(m.group(2))
        flat = np.asarray(tensor, dtype=np.float64).reshape(-1)
        if flat.size < 10 or np.allclose(flat, flat[0], rtol=1e-5, atol=1e-8):
            continue
        hist, _ = np.histogram(flat, bins=50, density=True)
        total = hist.sum()
        if total > 1e-6:
            hist = hist / total
            nz = hist[hist > 0]
            if nz.size:
                diversity[idx].append(float(-np.sum(nz * np.log2(nz + 1e-10))))
        mag = float(np.mean(np.abs(flat)))
        if mag > 0:
            magnitude[idx].append(mag)
        std = float(np.std(flat))
        if std > 0:
            noise[idx].append(std)

    div_means = [np.mean(v) for v in diversity.values() if v]
    mag_means = [np.mean(v) for v in magnitude.values() if v]
    noise_means = [np.mean(v) for v in noise.values() if v]
    if not (div_means and mag_means and noise_means):
        return _position_fallback_scores(n_blocks), True

    max_div, max_mag, max_noise = max(div_means), max(mag_means), max(noise_means)
    scores = []
    for i in range(n_blocks):
        nd = np.mean(diversity[i]) / max_div if diversity[i] else 0.0
        nm = np.mean(magnitude[i]) / max_mag if magnitude[i] else 0.0
        nn = np.mean(noise[i]) / max_noise if noise[i] else 0.0
        if nd > 0 and nm > 0 and nn > 0:
            snr = (nd * nm) / (nn + 1e-10)
            importance = 0.4 * nd + 0.3 * nm + 0.3 * snr
        elif nd > 0 or nm > 0:
            importance = 0.6 * nd + 0.4 * nm
        else:
            importance = 0.5 if (i < 2 or i >= n_blocks - 2) else 0.3
        scores.append((i, float(importance)))
    return scores, False


def select_blocks_to_keep(
    scores: list[tuple[int, float]],
    n_blocks: int,
    target_layers: int,
    manual_blocks: list[int] | None = None,
) -> list[int]:
    """First-2 + last-2 always kept; top-scored middle blocks fill the budget."""
    if manual_blocks is not None:
        assert len(manual_blocks) == target_layers, (
            f"manual blocks {len(manual_blocks)} != target {target_layers}"
        )
        assert all(0 <= b < n_blocks for b in manual_blocks)
        return sorted(manual_blocks)

    must_keep = sorted({0, 1, n_blocks - 2, n_blocks - 1})
    middle = [(i, s) for i, s in scores if i not in must_keep]
    middle.sort(key=lambda t: t[1], reverse=True)
    n_middle = target_layers - len(must_keep)
    if n_middle < 0:
        return must_keep[:target_layers]
    return sorted(must_keep + [i for i, _ in middle[:n_middle]])


def prune_state_dict(
    sd: dict[str, np.ndarray], blocks_to_keep: list[int]
) -> dict[str, np.ndarray]:
    """Drop non-kept transformer blocks; re-index the kept ones sequentially."""
    sd = normalize_reference_state_dict(sd)
    mapping = {old: new for new, old in enumerate(sorted(blocks_to_keep))}
    out: dict[str, np.ndarray] = {}
    for key, tensor in sd.items():
        m = _BLOCK_RE.match(key)
        if m:
            idx = int(m.group(2))
            if idx not in mapping:
                continue
            prefix = m.group(1) or ""
            key = _BLOCK_RE.sub(f"{prefix}transformer_blocks.{mapping[idx]}.", key)
        out[key] = np.asarray(tensor)
    return out


def prune_checkpoint(
    ckpt_path: str,
    output_path: str,
    target_layers: int = 14,
    manual_blocks: list[int] | None = None,
    use_ema: bool = True,
) -> PruneReport:
    """Full pipeline: load -> score -> select -> re-index -> save (.safetensors)."""
    sd = normalize_reference_state_dict(load_state_dict(ckpt_path), use_ema=use_ema)
    n_blocks = infer_depth(sd)
    scores, fallback = block_importance_scores(sd)
    keep = select_blocks_to_keep(scores, n_blocks, target_layers, manual_blocks)
    pruned = prune_state_dict(sd, keep)
    save_state_dict(pruned, output_path)
    report = PruneReport(
        block_scores=sorted(scores, key=lambda t: t[1], reverse=True),
        blocks_to_keep=keep,
        params_before=sum(int(np.prod(v.shape)) for v in sd.values()),
        params_after=sum(int(np.prod(v.shape)) for v in pruned.values()),
        used_fallback=fallback,
    )
    with open(output_path + ".prune_report.json", "w", encoding="utf-8") as f:
        json.dump(
            {
                "blocks_to_keep": keep,
                "original_num_transformer_blocks": n_blocks,
                "target_layers": target_layers,
                "block_scores": report.block_scores,
                "params_before": report.params_before,
                "params_after": report.params_after,
                "used_fallback": fallback,
            },
            f,
            indent=2,
        )
    return report


def pruned_model_config(sd: dict[str, np.ndarray], backbone: str = "DiT"):
    """The ``ModelConfig`` of a (normalized) DiT state dict, read from its
    shapes and keys: depth, width, heads x 64 (or one head when the inner
    width is no multiple of 64: only the product shapes a weight), ff_mult,
    text width and conv layers, mel channels, q / k norm, long skip."""
    from eraxvif5tts_tpu_torch.configs import ArchConfig, MelSpecConfig, ModelConfig

    if backbone != "DiT":
        raise ValueError(f"the pruner's block surgery is the DiT's, got backbone {backbone!r}")
    prefix = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    dim = sd["time_embed.time_mlp.0.weight"].shape[0]
    inner = sd["transformer_blocks.0.attn.to_q.weight"].shape[0]
    dim_head = 64 if inner % 64 == 0 else inner
    conv_pat = re.compile(r"text_embed\.text_blocks\.(\d+)\.")
    conv_ids = {int(m.group(1)) for k in sd if (m := conv_pat.match(k))}
    arch = ArchConfig(
        dim=dim, depth=infer_depth(sd), heads=inner // dim_head, dim_head=dim_head,
        ff_mult=sd["transformer_blocks.0.ff.ff.0.0.weight"].shape[0] // dim,
        text_dim=sd["text_embed.text_embed.weight"].shape[1],
        conv_layers=(max(conv_ids) + 1) if conv_ids else 0,
        qk_norm="rms_norm" if "transformer_blocks.0.attn.q_norm.weight" in sd else None,
        long_skip_connection="long_skip_connection.weight" in sd)
    mel = MelSpecConfig(n_mel_channels=sd["proj_out.weight"].shape[0])
    return ModelConfig(name="pruned", backbone=backbone, arch=arch, mel_spec=mel)


def test_pruned_model(pruned_path: str, backbone: str = "DiT") -> bool:
    """Smoke-load the pruned checkpoint into the port's backbone, strict
    (`...pruner.py:1062`); False when it holds no transformer block."""
    import torch

    from eraxvif5tts_tpu_torch.models import build_backbone

    sd = normalize_reference_state_dict(load_state_dict(pruned_path))
    if infer_depth(sd) == 0:
        return False
    cfg = pruned_model_config(sd, backbone)
    prefix = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    weights = {k[len(prefix):]: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in sd.items() if k.startswith(prefix)}
    with torch.device("meta"):
        model = build_backbone(cfg, infer_text_num_embeds(sd))
    model.load_state_dict(weights, strict=True, assign=True)
    return True


def save_state_dict(sd: dict[str, np.ndarray], path: str) -> None:
    if path.endswith(".safetensors"):
        from safetensors.numpy import save_file

        save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, path)
    else:
        import torch

        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)


def convert_pt_to_safetensors(pt_path: str, out_path: str, use_ema: bool = True) -> int:
    """`.pt` -> `.safetensors` with state-dict discovery & cleaning
    (reference `pt_to_safetensor.py:36,156`). Returns tensor count."""
    sd = normalize_reference_state_dict(load_state_dict(pt_path), use_ema=use_ema)
    save_state_dict(sd, out_path)
    return len(sd)


def get_embedding_size(ckpt_path: str) -> int:
    """Vocab rows of the text-embedding table (reference `get_embeding_size.py`)."""
    return infer_text_num_embeds(load_state_dict(ckpt_path)) + 1


def inspect_checkpoint(ckpt_path: str, max_keys: int = 50) -> dict:
    """Structure dump (reference `inspect_pt.py`)."""
    sd = load_state_dict(ckpt_path)
    return {
        "n_tensors": len(sd),
        "total_params": sum(int(np.prod(v.shape)) for v in sd.values()),
        "depth": infer_depth(sd),
        "keys": [
            {"key": k, "shape": list(np.asarray(v).shape), "dtype": str(np.asarray(v).dtype)}
            for k, v in list(sd.items())[:max_keys]
        ],
    }


def expand_text_embedding(
    sd: dict[str, np.ndarray], new_vocab_size: int, seed: int = 0
) -> dict[str, np.ndarray]:
    """Grow the text-embedding table for vocab extension (reference
    `finetune_gradio.py:1020-1073` ``expand_model_embeddings``): new rows are
    initialized from the N(0, 0.02) distribution, existing rows preserved."""
    out = dict(sd)
    for key, value in sd.items():
        if key.endswith("text_embed.text_embed.weight"):
            old = np.asarray(value)
            rows_needed = new_vocab_size + 1  # +1 filler row
            if rows_needed <= old.shape[0]:
                return out
            rng = np.random.default_rng(seed)
            extra = (rng.standard_normal((rows_needed - old.shape[0], old.shape[1])) * 0.02).astype(old.dtype)
            out[key] = np.concatenate([old, extra], axis=0)
            return out
    raise KeyError("text embedding table not found")


def reset_training_counters(ckpt_path: str, output_path: str) -> None:
    """Reset update/epoch counters keeping weights (reference
    `reset_f5tts_epoch_enhanced.py:85`). For torch-layout checkpoints this drops
    optimizer/scheduler state and the `step`/`initted` counters."""
    sd = normalize_reference_state_dict(load_state_dict(ckpt_path))
    save_state_dict(sd, output_path)
