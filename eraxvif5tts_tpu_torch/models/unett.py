"""UNetT backbone (E2-TTS): a flat UNet transformer with skip connections
(port of `eraxvif5tts_tpu/models/unett.py`, the unrolled form).

As in the JAX package: the time embedding is packed as frame 0 of the
sequence (so the transformer sees ``seq_len + 1`` positions, the mask gets one
valid frame in front and the rotary angles cover ``seq_len + 1``); every layer
is pre-RMSNorm attention and pre-RMSNorm feed-forward with residuals; the
input of each first-half layer is pushed and popped, last in first out, by
the second half, which merges it (``skip_connect_type``: ``"concat"`` projects
``[h, skip]`` back to ``dim`` with a bias-free linear, a product the JAX
package leaves to XLA and the port to ``torch.matmul``; ``"add"``;
``"none"``). Classifier-free guidance as a doubled batch and the out-of-loop
text embedding work as in the :class:`~eraxvif5tts_tpu_torch.models.dit.DiT`,
whose ``embed_text`` / ``run`` / ``forward`` interface this class shares.

Serving (eval mode, bf16): the pre-FF RMSNorm, the FF input projection and the
tanh-GELU are one kernel, ``ln_mod_matmul(norm="rms")`` with the norm's gain
folded in as ``scale = g - 1`` and ``shift = 0`` (`unett.py:245-270`); the
attention is the serving kernel without fused rotary when ``pe_attn_head`` is
set (the E2-TTS configs rotate head 0 only). In training mode, and in fp32
(where the JAX package's fusion gate is closed too), the feed-forward is
unfused.

Module and parameter names follow the reference torch schema
(`compression/convert.py` ``unett_rules``: ``layers.{i}.{0..4}`` = skip_proj,
attn_norm, attn, ff_norm, ff), so a reference E2-TTS checkpoint loads with
``load_state_dict(strict=True)``.

``arch.checkpoint_activations`` is ignored, as in the JAX UNetT. Not ported:
``scan_layers`` (the JAX package's compile-time workaround) and
``arch.quantized`` (int8 W8A8): the one-kernel int8 feed-forward holds a
block's 16 hidden rows in shared memory, and at ``ff_mult`` 4 those
16 x 4104 x 4 B = 263 KB exceed the 227 KB a block can have. Both raise.
"""

from __future__ import annotations

import torch
from torch import nn

from eraxvif5tts_tpu_torch.configs import ArchConfig
from eraxvif5tts_tpu_torch.models.dit import InputEmbedding, TextEmbedding
from eraxvif5tts_tpu_torch.models.modules import (
    Attention,
    FeedForward,
    TimestepEmbedding,
    XRMSNorm,
    linear,
)
from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs

SKIP_CONNECT_TYPES = ("concat", "add", "none")


class UNetT(nn.Module):
    """Flow-prediction UNet transformer: ``(x, cond, text, t) -> flow
    [b, n, mel]`` (`unett.py:124-290`). The compute dtype is
    ``compute_dtype``, or the parameters' dtype when that is None (serving,
    where the wrapper casts the parameters)."""

    def __init__(self, arch: ArchConfig, text_num_embeds: int = 256, mel_dim: int = 100,
                 compute_dtype: torch.dtype | None = None,
                 skip_connect_type: str = "concat"):
        super().__init__()
        if arch.depth % 2:
            raise ValueError(f"UNet-Transformer depth must be even, got {arch.depth}")
        if skip_connect_type not in SKIP_CONNECT_TYPES:
            raise ValueError(f"skip_connect_type must be one of {SKIP_CONNECT_TYPES}, "
                             f"got {skip_connect_type!r}")
        if arch.scan_layers:
            raise ValueError("scan_layers=True is the JAX package's compile-time workaround "
                             "and is not ported: build the unrolled form")
        if arch.quantized:
            raise ValueError("int8 serving of the UNetT is not ported yet: the one-kernel int8 "
                             "feed-forward does not fit ff_mult 4 in shared memory")
        self.arch = arch
        self.mel_dim = mel_dim
        self.compute_dtype = compute_dtype
        self.skip_connect_type = skip_connect_type
        text_dim = arch.text_dim if arch.text_dim is not None else mel_dim
        self.time_embed = TimestepEmbedding(arch.dim)
        self.text_embed = TextEmbedding(text_num_embeds, text_dim,
                                        conv_layers=arch.conv_layers,
                                        mask_padding=arch.text_mask_padding)
        self.input_embed = InputEmbedding(mel_dim, text_dim, arch.dim)
        half = arch.depth // 2
        self.layers = nn.ModuleList()
        for idx in range(arch.depth):
            skip_proj = (nn.Linear(arch.dim * 2, arch.dim, bias=False)
                         if skip_connect_type == "concat" and idx >= half else None)
            self.layers.append(nn.ModuleList([
                skip_proj,
                XRMSNorm(arch.dim),
                Attention(arch.dim, heads=arch.heads, dim_head=arch.dim_head,
                          qk_norm=arch.qk_norm, pe_attn_head=arch.pe_attn_head),
                XRMSNorm(arch.dim),
                FeedForward(arch.dim, mult=arch.ff_mult),
            ]))
        self.norm_out = XRMSNorm(arch.dim)
        self.proj_out = nn.Linear(arch.dim, mel_dim)
        self._rope: dict[tuple[int, torch.device], torch.Tensor] = {}

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.proj_out.weight.dtype

    def rope(self, seq_len: int, device: torch.device) -> torch.Tensor:
        """Rotary angles ``[seq_len, dim_head]`` fp32, kept per length so the
        Euler loop never copies them from the host."""
        key = (seq_len, torch.device(device))
        if key not in self._rope:
            self._rope[key] = rotary_freqs(seq_len, self.arch.dim_head, device=device)
        return self._rope[key]

    def embed_text(self, text: torch.Tensor, seq_len: int,
                   drop_text: torch.Tensor) -> torch.Tensor:
        """Text embedding at ``seq_len`` frames, computed once per sample call."""
        return self.text_embed(text, seq_len, drop_text, self.dtype)

    def _layer(self, h: torch.Tensor, skip: torch.Tensor | None, idx: int,
               mask: torch.Tensor | None, rope: torch.Tensor, rate: float, keys,
               fused: bool) -> torch.Tensor:
        skip_proj, attn_norm, attn, ff_norm, ff = self.layers[idx]
        if skip is not None:
            if self.skip_connect_type == "concat":
                h = linear(torch.cat([h, skip], dim=-1), skip_proj)
            elif self.skip_connect_type == "add":
                h = h + skip
        h = attn(attn_norm(h), mask, rope, rate, keys[:2]) + h
        if fused:
            # the norm's gain as the kernel's modulation: (1 + scale) = g, shift = 0
            scale = (ff_norm.g.float() - 1.0).to(h.dtype).expand(h.shape[0], -1)
            return ff(h, scale, torch.zeros_like(scale), norm="rms") + h
        return ff.project(ff_norm(h), rate, keys[2]) + h

    def run(self, x: torch.Tensor, cond: torch.Tensor, text_embed: torch.Tensor,
            time: torch.Tensor, drop_audio_cond: torch.Tensor,
            mask: torch.Tensor | None = None, dropout_keys=None) -> torch.Tensor:
        """Forward from a precomputed text embedding (the Euler-loop hot path).
        ``dropout_keys`` (training with dropout): per layer, the keys of its
        three dropout sites (attention weights, attention output, FF hidden
        state), each two 32-bit words."""
        batch, seq_len = x.shape[0], x.shape[1]
        depth = len(self.layers)
        if time.ndim == 0:
            time = time.expand(batch)
        rate = self.arch.dropout if self.training else 0.0
        if rate > 0.0 and (dropout_keys is None or len(dropout_keys) != depth):
            raise ValueError("a training forward with dropout needs the dropout keys of "
                             f"all {depth} layers")
        if rate == 0.0:
            dropout_keys = [(None, None, None)] * depth
        x, cond, text_embed = (t.to(self.dtype) for t in (x, cond, text_embed))
        t = self.time_embed(time, self.dtype)
        h = self.input_embed(x, cond, text_embed, drop_audio_cond, mask=mask)

        # the time token is frame 0 (`unett.py:223-228`)
        h = torch.cat([t[:, None, :], h], dim=1)
        if mask is not None:
            mask = torch.nn.functional.pad(mask, (1, 0), value=True)
        rope = self.rope(seq_len + 1, x.device)

        # the JAX package's fusion gate: serving, bf16 (`unett.py:245-250`)
        fused = not self.training and h.dtype == torch.bfloat16
        half = depth // 2
        skips: list[torch.Tensor] = []
        for idx, keys in enumerate(dropout_keys):
            skip = None
            if idx < half:
                skips.append(h)
            else:
                skip = skips.pop()
            h = self._layer(h, skip, idx, mask, rope, rate, keys, fused)

        h = self.norm_out(h)[:, 1:, :]  # drop the time token
        return linear(h.to(self.proj_out.weight.dtype), self.proj_out).float()

    def forward(self, x: torch.Tensor, cond: torch.Tensor, text: torch.Tensor,
                time: torch.Tensor, drop_audio_cond: torch.Tensor, drop_text: torch.Tensor,
                mask: torch.Tensor | None = None, dropout_keys=None) -> torch.Tensor:
        """The whole UNetT (the JAX ``__call__``): text embedding at x's
        length, then :meth:`run`."""
        return self.run(x, cond, self.embed_text(text, x.shape[1], drop_text), time,
                        drop_audio_cond, mask, dropout_keys)
