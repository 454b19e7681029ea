"""Typed configuration tree (the port's own copy of
`eraxvif5tts_tpu/configs/__init__.py`: same classes, field names, defaults and
presets, so the reference-format YAML files under `configs/` at the
repository root load unchanged).

Fields that configure what the port has not ported (``scan_layers``, the
``dots`` / ``attn`` remat policies, ``mu_dtype``, ``zero1``) are kept so that
every YAML and every JAX-side config maps field by field; the modules that
would use them raise.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class MelSpecConfig:
    """Mel frontend parameters (reference `configs/F5TTS_v1_Base.yaml:36-42`)."""

    target_sample_rate: int = 24000
    n_mel_channels: int = 100
    hop_length: int = 256
    win_length: int = 1024
    n_fft: int = 1024
    mel_spec_type: str = "vocos"  # "vocos" | "bigvgan"


@dataclass(frozen=True)
class ArchConfig:
    """DiT/UNetT/MMDiT architecture knobs (reference `configs/*.yaml` `model.arch`)."""

    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    text_dim: Optional[int] = 512
    text_mask_padding: bool = True
    qk_norm: Optional[str] = None  # None | "rms_norm"
    conv_layers: int = 4
    pe_attn_head: Optional[int] = None
    long_skip_connection: bool = False
    checkpoint_activations: bool = False
    # remat selectivity when checkpoint_activations is on: "full" recomputes
    # everything in the backward (least memory); "dots" saves matmul outputs;
    # "attn" saves only the attention outputs. "auto" picks by per-chip frame
    # budget at trainer build time (resolve_remat_policy); the models
    # treat an unresolved "auto" as "full". The port checkpoints whole blocks
    # ("full") and raises for "dots" / "attn".
    remat_policy: str = "auto"  # "auto" | "full" | "dots" | "attn"
    # the JAX package's one-scan-body compile mode; the port runs eagerly and
    # refuses it
    scan_layers: bool = False
    dropout: float = 0.1
    # int8 W8A8 serving for the block matmuls (opt-in; weights pre-quantized,
    # `ops/quant.py`)
    quantized: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str = "F5TTS_v1_Base"
    backbone: str = "DiT"  # "DiT" | "UNetT" | "MMDiT"
    tokenizer: str = "pinyin"  # "pinyin" | "char" | "custom"
    tokenizer_path: Optional[str] = None
    arch: ArchConfig = field(default_factory=ArchConfig)
    mel_spec: MelSpecConfig = field(default_factory=MelSpecConfig)
    # absent from the reference YAML: training matmul/activation dtype.
    # Parameters, optimizer state and layernorm statistics stay float32.
    compute_dtype: str = "bfloat16"  # "bfloat16" | "float32"


@dataclass(frozen=True)
class OptimConfig:
    """Reference `configs/F5TTS_v1_Base.yaml` `optim` block."""

    epochs: int = 11
    learning_rate: float = 7.5e-5
    num_warmup_updates: int = 20000
    grad_accumulation_steps: int = 1
    max_grad_norm: float = 1.0
    bnb_optimizer: bool = False  # accepted for config parity
    # store the AdamW first moment in bf16; nu stays fp32
    mu_dtype: Optional[str] = None  # None (fp32) | "bfloat16"
    # ZeRO-1 optimizer-state sharding over the data axis
    zero1: bool = False


@dataclass(frozen=True)
class DatasetConfig:
    name: str = "Emilia_ZH_EN"
    batch_size_per_gpu: int = 38400
    batch_size_type: str = "frame"  # "frame" | "sample"
    max_samples: int = 64
    num_workers: int = 16


@dataclass(frozen=True)
class CkptConfig:
    logger: Optional[str] = "tensorboard"  # "wandb" | "tensorboard" | None
    log_samples: bool = True
    save_per_updates: int = 50000
    keep_last_n_checkpoints: int = -1
    last_per_updates: int = 5000
    save_dir: str = "ckpts"


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    datasets: DatasetConfig = field(default_factory=DatasetConfig)
    ckpts: CkptConfig = field(default_factory=CkptConfig)


# Per-chip frame budget at or below which the JAX package resolves "auto" to
# "dots" (kept so both packages resolve a config alike).
REMAT_DOTS_MAX_FRAMES = 6 * 4096


def resolve_remat_policy(policy: str, per_chip_frames: int | None) -> str:
    """Resolve ``remat_policy="auto"`` from the per-chip frame budget:
    ``dots`` at or below :data:`REMAT_DOTS_MAX_FRAMES`, else ``full``.
    Explicit policies pass through unchanged."""
    if policy != "auto":
        if policy not in ("full", "dots", "attn"):
            raise ValueError(f"unknown remat_policy {policy!r} (auto|full|dots|attn)")
        return policy
    if per_chip_frames is not None and per_chip_frames <= REMAT_DOTS_MAX_FRAMES:
        return "dots"
    return "full"


# ---------------------------------------------------------------------------
# Construction helpers


def _build(cls, data: dict[str, Any]):
    """Recursively build a dataclass from a nested dict, ignoring unknown keys."""
    if data is None:
        return cls()
    names = {f.name: f for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = {}
    for key, value in data.items():
        f = names.get(key)
        if f is None:
            continue  # tolerate extra keys (hydra blocks, comments)
        sub = _DATACLASS_FIELDS.get((cls, key))
        if sub is not None and isinstance(value, dict):
            kwargs[key] = _build(sub, value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


_DATACLASS_FIELDS = {
    (ModelConfig, "arch"): ArchConfig,
    (ModelConfig, "mel_spec"): MelSpecConfig,
    (TrainConfig, "model"): ModelConfig,
    (TrainConfig, "optim"): OptimConfig,
    (TrainConfig, "datasets"): DatasetConfig,
    (TrainConfig, "ckpts"): CkptConfig,
}


def model_config_from_dict(data: dict[str, Any]) -> ModelConfig:
    return _build(ModelConfig, data)


def train_config_from_dict(data: dict[str, Any]) -> TrainConfig:
    return _build(TrainConfig, data)


def load_yaml_config(path: str) -> TrainConfig:
    """Load a reference-format YAML training config (e.g. `configs/F5TTS_v1_Base.yaml`)."""
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f)
    return train_config_from_dict(raw)


def load_model_config(path: str) -> ModelConfig:
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f)
    if "model" in raw:
        raw = raw["model"]
    return model_config_from_dict(raw)


# Named presets mirroring reference `configs/*.yaml` and the pruned-student presets in
# reference `train/finetune_cli.py:222-249`.
PRESETS: dict[str, ModelConfig] = {
    "F5TTS_v1_Base": ModelConfig(),
    "F5TTS_v1_Pruned_14": ModelConfig(
        name="F5TTS_v1_Pruned_14", arch=ArchConfig(depth=14)
    ),
    "F5TTS_v1_Pruned_12": ModelConfig(
        name="F5TTS_v1_Pruned_12", arch=ArchConfig(depth=12)
    ),
    "F5TTS_Base": ModelConfig(
        name="F5TTS_Base",
        arch=ArchConfig(text_mask_padding=False, pe_attn_head=1),
    ),
    "F5TTS_Small": ModelConfig(
        name="F5TTS_Small",
        arch=ArchConfig(dim=768, depth=18, heads=12, text_mask_padding=False, pe_attn_head=1),
    ),
    "E2TTS_Base": ModelConfig(
        name="E2TTS_Base",
        backbone="UNetT",
        arch=ArchConfig(
            dim=1024, depth=24, heads=16, ff_mult=4, text_dim=None,
            text_mask_padding=False, pe_attn_head=1, conv_layers=0,
        ),
    ),
    "E2TTS_Small": ModelConfig(
        name="E2TTS_Small",
        backbone="UNetT",
        arch=ArchConfig(
            dim=768, depth=20, heads=12, ff_mult=4, text_dim=None,
            text_mask_padding=False, pe_attn_head=1, conv_layers=0,
        ),
    ),
    # Flagship-dim MMDiT (reference `backbones/mmdit.py:85-189`; the reference
    # ships no MMDiT YAML). The port serves it in bf16 (`models/mmdit.py`);
    # its int8 form and its training are not ported.
    "F5TTS_v1_MMDiT": ModelConfig(
        name="F5TTS_v1_MMDiT",
        backbone="MMDiT",
        arch=ArchConfig(dim=1024, depth=22, heads=16, dim_head=64, ff_mult=2),
    ),
}
