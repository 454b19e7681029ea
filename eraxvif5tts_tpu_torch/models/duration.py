"""Phoneme duration predictor (port of `eraxvif5tts_tpu/models/duration.py`).

Phoneme-id embedding -> 2x (conv1d k3 -> ReLU -> GroupNorm(1) -> dropout) ->
conv1d k1 -> one log-duration per token, masked; total frames at inference
``exp(logw).round().sum()``. The checkpoint embeds its own ``phoneme_map``.

The module carries the reference torch key layout (``text_embed``,
``conv_1`` / ``norm_1``, ``conv_2`` / ``norm_2``, ``proj``), so a reference
checkpoint loads with a plain ``load_state_dict``. As in the reference, the
embedding table has ``vocab_size + 1`` rows and an id is looked up at row
``id + 1``: the JAX package drops row 0 on import and looks ids up directly,
so JAX row ``i`` is torch row ``i + 1``.

Kept from the JAX package:

- ``GroupNorm(num_groups=1)`` with flax's epsilon 1e-6 (torch's default is
  1e-5): statistics over every position and channel of a sample, the padded
  positions included;
- an id outside the JAX table (``[-vocab_size, vocab_size)``, negative ids
  counted from the end) embeds as NaN, as flax's gather fills it, so its
  sample's log-durations are NaN; the lookup is clamped first, so such an id
  never reaches the CUDA gather (where it would be a device-side assert);
- ``deterministic=True`` by default: dropout only when the caller asks.

The convolutions and the norm are plain torch (cuDNN on the card), with
TF32 off so that the card predicts the CPU's frame counts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eraxvif5tts_tpu_torch.models.modules import fp32_convolutions
from eraxvif5tts_tpu_torch.text.phoneme import text_to_phoneme_indices

StateDict = dict[str, torch.Tensor]
GROUP_NORM_EPS = 1e-6  # flax nn.GroupNorm's default


def predictor_vocab_size(text_vocab_size: int) -> int:
    """One shared sizing rule for the predictor's embedding table: pad row 0 +
    ids 1..n + one spare row (the JAX package's rule)."""
    return text_vocab_size + 2


class DurationPredictor(nn.Module):
    """``phoneme_ids [b, nt]`` (0 = pad) and ``mask [b, nt]`` (True = valid)
    -> log-durations ``[b, nt]``, 0 where masked. ``vocab_size`` is the JAX
    table's row count; the torch table holds one more row in front."""

    def __init__(self, vocab_size: int, d_model: int = 512, d_filter: int = 512,
                 kernel_size: int = 3, dropout: float = 0.5):
        super().__init__()
        self.vocab_size = vocab_size
        self.dropout = dropout
        self.text_embed = nn.Embedding(vocab_size + 1, d_model)
        pad = kernel_size // 2
        self.conv_1 = nn.Conv1d(d_model, d_filter, kernel_size, padding=pad)
        self.norm_1 = nn.GroupNorm(1, d_filter, eps=GROUP_NORM_EPS)
        self.conv_2 = nn.Conv1d(d_filter, d_filter, kernel_size, padding=pad)
        self.norm_2 = nn.GroupNorm(1, d_filter, eps=GROUP_NORM_EPS)
        self.proj = nn.Conv1d(d_filter, 1, 1)

    def embed(self, phoneme_ids: torch.Tensor) -> torch.Tensor:
        """The rows of ``phoneme_ids`` as the JAX gather gives them: negative
        ids from the end, ids outside the table NaN."""
        v = self.vocab_size
        idx = torch.where(phoneme_ids < 0, phoneme_ids + v, phoneme_ids)
        inside = (idx >= 0) & (idx < v)
        x = self.text_embed(idx.clamp(0, v - 1) + 1)
        return x.masked_fill(~inside[..., None], float("nan"))

    def forward(self, phoneme_ids: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        x = self.embed(phoneme_ids)
        if mask is not None:
            x = x.masked_fill(~mask[..., None], 0.0)
        x = x.transpose(1, 2)  # [b, d, nt]
        with fp32_convolutions():
            for conv, norm in ((self.conv_1, self.norm_1), (self.conv_2, self.norm_2)):
                x = norm(F.relu(conv(x)))
                x = F.dropout(x, self.dropout, training=not deterministic)
            logw = self.proj(x)[:, 0]
        if mask is not None:
            logw = logw.masked_fill(~mask, 0.0)
        return logw


# ---------------------------------------------------------------------------
# checkpoints (`duration.py:60-169`)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def duration_state_dict_from_torch(sd: dict) -> tuple[StateDict, dict]:
    """A duration-predictor state dict in any historical layout that the JAX
    package's ``duration_params_from_torch`` accepts -> (the reference layout
    of :class:`DurationPredictor`, the embedded ``phoneme_map``).

    Embedding: ``text_embed.weight`` (the reference, shifted: row ``id + 1``)
    is kept; the legacy unshifted ``embedding.weight`` / ``embed.weight`` get
    a zero row in front. Convolutions ``conv_{1,2}`` / ``conv_layers.{i}.0``
    / ``convs.{i}.conv``, norms ``norm_{1,2}`` / ``conv_layers.{i}.2`` /
    ``norms.{i}``, projection ``proj`` / ``linear`` / ``out_proj`` (a
    ``[1, d]`` linear weight becomes the ``[1, d, 1]`` convolution)."""
    sd = dict(sd)
    phoneme_map = sd.pop("phoneme_map", {}) if isinstance(sd.get("phoneme_map"), dict) else {}
    if "model_state_dict" in sd:
        sd = sd["model_state_dict"]

    def arr(key):
        v = sd[key]
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    out: dict[str, np.ndarray] = {}
    if "text_embed.weight" in sd:
        out["text_embed.weight"] = arr("text_embed.weight")
    else:
        for key in ("embedding.weight", "embed.weight"):  # legacy unshifted layouts
            if key in sd:
                emb = arr(key)
                out["text_embed.weight"] = np.concatenate(
                    [np.zeros((1, emb.shape[1]), emb.dtype), emb])
                break
    for i in range(2):
        for name in (f"conv_{i + 1}", f"conv_layers.{i}.0", f"convs.{i}.conv"):
            if f"{name}.weight" in sd:
                out[f"conv_{i + 1}.weight"] = arr(f"{name}.weight")
                out[f"conv_{i + 1}.bias"] = arr(f"{name}.bias")
                break
        for name in (f"norm_{i + 1}", f"conv_layers.{i}.2", f"norms.{i}"):
            if f"{name}.weight" in sd:
                out[f"norm_{i + 1}.weight"] = arr(f"{name}.weight")
                out[f"norm_{i + 1}.bias"] = arr(f"{name}.bias")
                break
    for name in ("proj", "linear", "out_proj"):
        if f"{name}.weight" in sd:
            w = arr(f"{name}.weight")
            out["proj.weight"] = w[:, :, None] if w.ndim == 2 else w
            out["proj.bias"] = arr(f"{name}.bias")
            break
    return {k: _tensor(v) for k, v in out.items()}, phoneme_map


def duration_state_dict_from_jax(params: dict) -> StateDict:
    """The JAX predictor's parameter tree (numpy or array leaves) -> the
    reference layout, as the JAX package's ``duration_params_to_torch``
    writes it: a zero row 0 in front of the embedding, convolution kernels
    ``[k, in, out]`` -> ``[out, in, k]``."""

    def conv(w):
        return np.asarray(w).transpose(2, 1, 0)

    emb = np.asarray(params["embed"]["embedding"])
    out = {"text_embed.weight": np.concatenate([np.zeros((1, emb.shape[1]), emb.dtype), emb])}
    for i in range(2):
        out[f"conv_{i + 1}.weight"] = conv(params[f"conv_{i}"]["kernel"])
        out[f"conv_{i + 1}.bias"] = np.asarray(params[f"conv_{i}"]["bias"])
        out[f"norm_{i + 1}.weight"] = np.asarray(params[f"norm_{i}"]["scale"])
        out[f"norm_{i + 1}.bias"] = np.asarray(params[f"norm_{i}"]["bias"])
    out["proj.weight"] = conv(params["proj"]["kernel"])
    out["proj.bias"] = np.asarray(params["proj"]["bias"])
    return {k: _tensor(v) for k, v in out.items()}


def save_duration_predictor(path: str, model: DurationPredictor, phoneme_map: dict[str, int],
                            update: int = 0, duration_loss_weight: float = 0.1) -> str:
    """Write the reference-format predictor checkpoint with its embedded
    ``phoneme_map``."""
    sd = {k: v.detach().float().cpu().contiguous() for k, v in model.state_dict().items()}
    torch.save({"duration_predictor": sd, "update": update,
                "duration_loss_weight": duration_loss_weight,
                "phoneme_map": dict(phoneme_map)}, path)
    return path


def load_duration_predictor(ckpt_path: str, device: str | torch.device = "cuda"
                            ) -> tuple[DurationPredictor, dict]:
    """A duration-predictor checkpoint (any layout of
    :func:`duration_state_dict_from_torch`) -> (the predictor in eval mode on
    ``device``, its ``phoneme_map``)."""
    raw = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    phoneme_map = raw.get("phoneme_map", {}) if isinstance(raw, dict) else {}
    sd = raw
    if isinstance(raw, dict):
        # the reference layout nests under 'duration_predictor'
        sd = raw.get("duration_predictor", raw.get("model_state_dict", raw))
    state_dict, _ = duration_state_dict_from_torch(sd)
    rows, d_model = state_dict["text_embed.weight"].shape
    d_filter, _, kernel_size = state_dict["conv_1.weight"].shape
    model = DurationPredictor(vocab_size=rows - 1, d_model=d_model, d_filter=d_filter,
                              kernel_size=kernel_size)
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval(), phoneme_map


def predict_duration_frames(model: DurationPredictor, phoneme_map: dict[str, int],
                            text: str) -> int:
    """Text -> total predicted mel frames on the model's device; 0 when the
    text has no phoneme in the map. An id outside the table raises here, on
    the host (the JAX function raises too: its frame count is NaN)."""
    try:
        ids = text_to_phoneme_indices(text, phoneme_map)
    except Exception:
        return 0
    if not ids:
        return 0
    if not all(-model.vocab_size <= i < model.vocab_size for i in ids):
        raise ValueError(f"phoneme ids {sorted(set(ids))[-3:]}... fall outside the duration "
                         f"predictor's table of {model.vocab_size} rows: the phoneme map "
                         "does not belong to this predictor")
    device = model.text_embed.weight.device
    arr = torch.tensor([ids], dtype=torch.long, device=device)
    mask = arr > 0
    with torch.inference_mode():
        logw = model(arr, mask)
        frames = (torch.round(torch.exp(logw)) * mask).sum()
    return int(frames.item())
