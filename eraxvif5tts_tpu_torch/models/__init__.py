"""Backbones (DiT, UNetT), the CFM objective and sampler, and Vocos."""


def build_backbone(config, text_num_embeds: int, compute_dtype=None):
    """Resolve ``config.backbone`` -> the port's module (the counterpart of
    `eraxvif5tts_tpu/models/__init__.py` ``build_backbone``). ``compute_dtype``
    None computes in the parameters' dtype (serving)."""
    from eraxvif5tts_tpu_torch.models.dit import DiT
    from eraxvif5tts_tpu_torch.models.unett import UNetT

    if config.backbone == "MMDiT":
        raise ValueError("backbone 'MMDiT' is not ported yet (DiT | UNetT)")
    cls = {"DiT": DiT, "UNetT": UNetT}.get(config.backbone)
    if cls is None:
        raise ValueError(f"unknown backbone {config.backbone!r}")
    return cls(config.arch, text_num_embeds=text_num_embeds,
               mel_dim=config.mel_spec.n_mel_channels, compute_dtype=compute_dtype)
