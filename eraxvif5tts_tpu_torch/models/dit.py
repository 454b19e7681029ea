"""DiT backbone (port of `eraxvif5tts_tpu/models/dit.py`).

Kept from the JAX package: classifier-free guidance runs the cond and uncond
branches as one call on a doubled batch (``drop_audio_cond`` / ``drop_text``
are per-sample bool tensors), and the text embedding is a separate method
(:meth:`DiT.embed_text`) so the sampler computes it once before the Euler
loop and calls :meth:`DiT.run` at every step.

The port builds the ``F5TTS_v1`` family (rotary on every head) and the
``F5TTS_Base`` / ``F5TTS_Small`` options: ``pe_attn_head`` (rotary on the first
heads only), ``qk_norm="rms_norm"``, ``long_skip_connection`` and
``text_mask_padding=False``. ``scan_layers`` is the JAX package's compile-time
workaround and raises here. ``arch.quantized`` builds the int8 W8A8 serving blocks
(`ops/quant.py`; the wrapper's ``compute_dtype="int8"``): they serve only, in
eval mode, as in the JAX package, where quantized models are never trained.

Training (``module.train()``, the JAX ``deterministic=False``) keeps the
parameters in fp32 and computes in ``compute_dtype`` (bf16 on the card, the
JAX recipe); ``proj_out``, a flax ``Dense`` without a dtype in the JAX
package, computes in its parameters' dtype. The dropout keys of every block
are drawn by the caller before the forward (:meth:`DiT.forward`). A
training-mode forward with ``deterministic=True`` runs the training
attention without dropout (the trainer's forward-only loss of the
duration-focus updates).
``ArchConfig.checkpoint_activations`` checkpoints each block
(``torch.utils.checkpoint``, the JAX ``remat_policy="full"``; an unresolved
``"auto"`` means "full", as in the JAX DiT);
the ``"dots"`` and ``"attn"`` policies are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from eraxvif5tts_tpu_torch.configs import ArchConfig
from eraxvif5tts_tpu_torch.models.modules import (
    AdaLayerNormFinal,
    ConvNeXtV2Block,
    ConvPositionEmbedding,
    DiTBlock,
    TimestepEmbedding,
    full_fp32,
    linear,
)
from eraxvif5tts_tpu_torch.ops.rotary import abs_pos_embedding_table, rotary_freqs

MAX_POS = 4096  # sequence cap, as in the JAX package


def _remat(arch: ArchConfig) -> bool:
    """Whether to checkpoint each block: the ``full`` policy (an unresolved
    ``auto`` means ``full``, as in the JAX DiT)."""
    if not arch.checkpoint_activations:
        return False
    if arch.remat_policy in ("full", "auto"):
        return True
    if arch.remat_policy in ("dots", "attn"):
        raise ValueError(f"remat_policy={arch.remat_policy!r} is not ported "
                         "(the port checkpoints whole blocks: 'full')")
    raise ValueError(f"unknown remat_policy {arch.remat_policy!r} (auto|full|dots|attn)")


class TextEmbedding(nn.Module):
    """Char-id embedding + absolute sin position + ConvNeXtV2 stack, with the
    filler positions masked when ``mask_padding`` (`dit.py:36-87`,
    ``text_mask_padding``). ``text`` ids are -1 padded; +1 makes 0 the filler.
    Without conv layers (the UNetT) it is the embedding alone."""

    def __init__(self, text_num_embeds: int, text_dim: int, conv_layers: int = 0,
                 conv_mult: int = 2, mask_padding: bool = True):
        super().__init__()
        self.mask_padding = mask_padding
        self.text_embed = nn.Embedding(text_num_embeds + 1, text_dim)
        self.text_blocks = nn.ModuleList(
            [ConvNeXtV2Block(text_dim, text_dim * conv_mult) for _ in range(conv_layers)])
        self.register_buffer(
            "freqs_cis", torch.from_numpy(abs_pos_embedding_table(text_dim, MAX_POS)),
            persistent=False)

    def forward(self, text: torch.Tensor, seq_len: int, drop_text: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        text = (text + 1)[:, :seq_len]
        text = F.pad(text, (0, seq_len - text.shape[1]))
        # the filler mask is taken BEFORE the CFG drop (`dit.py:57-65`)
        filler = text == 0
        text = torch.where(drop_text[:, None], torch.zeros_like(text), text)
        embed = self.text_embed(text).to(dtype)
        if len(self.text_blocks):
            embed = embed + self.freqs_cis[:seq_len].to(embed.dtype)[None]
            if self.mask_padding:
                embed = embed.masked_fill(filler[..., None], 0.0)
            for block in self.text_blocks:
                embed = block(embed)
                if self.mask_padding:
                    embed = embed.masked_fill(filler[..., None], 0.0)
        return embed


class InputEmbedding(nn.Module):
    """Linear(cat(x, cond, text)) + conv position embedding (`dit.py:90-113`)."""

    def __init__(self, mel_dim: int, text_dim: int, out_dim: int):
        super().__init__()
        self.proj = nn.Linear(mel_dim * 2 + text_dim, out_dim)
        self.conv_pos_embed = ConvPositionEmbedding(out_dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor, text_embed: torch.Tensor,
                drop_audio_cond: torch.Tensor, mask: torch.Tensor | None = None):
        cond = cond.masked_fill(drop_audio_cond[:, None, None], 0.0)
        x = linear(torch.cat([x, cond, text_embed], dim=-1), self.proj)
        return self.conv_pos_embed(x, mask=mask) + x


class DiT(nn.Module):
    """Flow-prediction DiT: ``(x, cond, text, t) -> flow [b, n, mel]``
    (`dit.py:116-280`). The compute dtype is ``compute_dtype``, or the
    parameters' dtype when that is None (serving, where the wrapper casts
    the parameters)."""

    def __init__(self, arch: ArchConfig, text_num_embeds: int = 256, mel_dim: int = 100,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        if arch.scan_layers:
            raise ValueError("scan_layers=True is the JAX package's compile-time workaround "
                             "and is not ported: build the unrolled form")
        _remat(arch)
        self.arch = arch
        self.mel_dim = mel_dim
        self.compute_dtype = compute_dtype
        text_dim = arch.text_dim if arch.text_dim is not None else mel_dim
        self.time_embed = TimestepEmbedding(arch.dim)
        self.text_embed = TextEmbedding(text_num_embeds, text_dim,
                                        conv_layers=arch.conv_layers,
                                        mask_padding=arch.text_mask_padding)
        self.input_embed = InputEmbedding(mel_dim, text_dim, arch.dim)
        self.transformer_blocks = nn.ModuleList(
            [DiTBlock(arch.dim, arch.heads, arch.dim_head, arch.ff_mult,
                      quantized=arch.quantized, qk_norm=arch.qk_norm,
                      pe_attn_head=arch.pe_attn_head)
             for _ in range(arch.depth)])
        if arch.long_skip_connection:
            self.long_skip_connection = nn.Linear(arch.dim * 2, arch.dim, bias=False)
        self.norm_out = AdaLayerNormFinal(arch.dim)
        self.proj_out = nn.Linear(arch.dim, mel_dim)
        self._rope: dict[tuple[int, torch.device], torch.Tensor] = {}

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.proj_out.weight.dtype

    def rope(self, seq_len: int, device: torch.device) -> torch.Tensor:
        """Rotary angles ``[seq_len, dim_head]`` fp32, kept per bucket so the
        Euler loop never copies them from the host."""
        key = (seq_len, torch.device(device))
        if key not in self._rope:
            # setdefault: threads that race here all take the one table kept
            self._rope.setdefault(key, rotary_freqs(seq_len, self.arch.dim_head,
                                                    device=device))
        return self._rope[key]

    @full_fp32
    def embed_text(self, text: torch.Tensor, seq_len: int,
                   drop_text: torch.Tensor) -> torch.Tensor:
        """Text embedding at ``seq_len`` frames, computed once per sample call."""
        return self.text_embed(text, seq_len, drop_text, self.dtype)

    @full_fp32
    def run(self, x: torch.Tensor, cond: torch.Tensor, text_embed: torch.Tensor,
            time: torch.Tensor, drop_audio_cond: torch.Tensor,
            mask: torch.Tensor | None = None, dropout_keys=None,
            deterministic: bool = False) -> torch.Tensor:
        """Forward from a precomputed text embedding (the Euler-loop hot path).
        ``dropout_keys`` (training with dropout): per block, the keys of its
        three dropout sites, each two 32-bit words."""
        batch, seq_len = x.shape[0], x.shape[1]
        if time.ndim == 0:
            time = time.expand(batch)
        if self.training and self.arch.quantized:
            raise ValueError("a quantized DiT serves only: call .eval() (int8 models are "
                             "not trained)")
        rate = self.arch.dropout if self.training and not deterministic else 0.0
        if rate > 0.0 and (dropout_keys is None
                           or len(dropout_keys) != len(self.transformer_blocks)):
            raise ValueError("a training forward with dropout needs the dropout keys of "
                             f"all {len(self.transformer_blocks)} blocks")
        if rate == 0.0:
            dropout_keys = [(None, None, None)] * len(self.transformer_blocks)
        x, cond, text_embed = (t.to(self.dtype) for t in (x, cond, text_embed))
        t = self.time_embed(time, self.dtype)
        h = self.input_embed(x, cond, text_embed, drop_audio_cond, mask=mask)
        rope = self.rope(seq_len, x.device)
        residual = h
        remat = self.training and torch.is_grad_enabled() and _remat(self.arch)
        for block, keys in zip(self.transformer_blocks, dropout_keys):
            if remat:
                h = checkpoint(block, h, t, mask, rope, rate, keys, use_reentrant=False)
            else:
                h = block(h, t, mask, rope, rate, keys)
        if self.arch.long_skip_connection:
            h = linear(torch.cat([h, residual], dim=-1), self.long_skip_connection)
        h = self.norm_out(h, t)
        return linear(h.to(self.proj_out.weight.dtype), self.proj_out).float()

    def forward(self, x: torch.Tensor, cond: torch.Tensor, text: torch.Tensor,
                time: torch.Tensor, drop_audio_cond: torch.Tensor, drop_text: torch.Tensor,
                mask: torch.Tensor | None = None, dropout_keys=None,
                deterministic: bool = False) -> torch.Tensor:
        """The whole DiT (the JAX ``__call__``): text embedding at x's length,
        then :meth:`run`."""
        return self.run(x, cond, self.embed_text(text, x.shape[1], drop_text), time,
                        drop_audio_cond, mask, dropout_keys, deterministic)
