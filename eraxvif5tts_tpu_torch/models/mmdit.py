"""MMDiT backbone: SD3-style dual-stream joint attention (port of
`eraxvif5tts_tpu/models/mmdit.py`).

A text stream and an audio stream, each with its own AdaLN-zero modulation,
meet in one joint attention over the concatenated sequence; the last block is
``context_pre_only`` (its text stream ends after the attention's input).
Kept from the JAX package:

- the text stream keeps its own length (the text bucket): the absolute
  position table is clamped at ``TEXT_MAX_POS`` and the filler mask is taken
  *before* the CFG drop (`mmdit.py:36-61`);
- each stream is rotated outside the attention by its own positions, with
  cos / sin cast to the compute dtype (`mmdit.py:117-122`), and the kernel
  runs without rotary;
- the joint order is text first (`mmdit.py:124-137`): the key mask is then a
  contiguous prefix, ``[all-valid text | prefix-valid audio]``, which reaches
  the serving attention kernel as per-sample key lengths ``nt + mel_lens``.
  With the text bucket and the mel bucket both multiples of 64 the joint
  length is too, up to 2048 + 4096 = 6144 (`ops/serving_attention.py`
  ``MAX_N``);
- the feed-forward takes an input normalised and modulated outside
  (``ff_norm_*``: layernorm without affine, eps 1e-6), then
  ``FeedForward.project``: no fused projection kernel runs in an MMDiT
  (`mmdit.py:201-216`);
- ``embed_text`` / ``run`` / ``forward`` as the DiT's, so ``CFM.sample``
  embeds the text once before the Euler loop.

Module and parameter names follow the reference torch schema
(`compression/convert.py` ``mmdit_rules``), so a reference checkpoint loads
with ``load_state_dict(strict=True)``.

Training (``module.train()``, the JAX ``deterministic=False``) runs the
joint attention through the training attention (`ops/train_attention.py`,
kernel 4, whose domain reaches the joint 2048 + 4096) on the same
``[b, nt + n, h, d]`` q, k, v and prefix key mask as the eval path, at
dropout 0: fp32 parameters, computing in ``compute_dtype`` (bf16 on the
card) or in fp32, ``proj_out`` in its parameters' dtype as a flax ``Dense``
without a dtype. The JAX MMDiT trains only at dropout 0: at any dropout
> 0 its joint attention calls ``hash_dropout``, which
`eraxvif5tts_tpu/models/mmdit.py` never imports (`:157`), and raises
``NameError``; the port refuses dropout > 0 in training with a
``ValueError`` before any kernel runs (ROADMAP queue 3) and takes the
dropout keys without using them. There is no activation checkpointing: the
JAX MMDiT has no ``nn.remat`` (unlike its DiT), so neither has the port's.

``arch.quantized`` builds the int8 W8A8 serving MMDiT (`ops/quant.py`, the
JAX ``quantized`` path): :class:`~eraxvif5tts_tpu_torch.ops.quant.QuantLinear`
for the six q / k / v projections of both streams, ``to_out`` and
``to_out_c``, and both feed-forwards' projections, which run the
QuantLinear chain or, with ``ERAX_INT8_FF=1``, the one-kernel ``int8_ff``
(kernel 5) on the mel stream's rows (``ff_x``) and the text stream's
(``ff_c``). It serves only, in eval mode. ``scan_layers`` raises as in the
other backbones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eraxvif5tts_tpu_torch.configs import ArchConfig
from eraxvif5tts_tpu_torch.models.modules import (
    AdaLayerNorm,
    AdaLayerNormFinal,
    ConvPositionEmbedding,
    FeedForward,
    RMSNorm,
    TimestepEmbedding,
    full_fp32,
    layer_norm,
    linear,
)
from eraxvif5tts_tpu_torch.ops.attention import (
    dot_product_attention,
    head_dim_route,
    plain_train_attention,
)
from eraxvif5tts_tpu_torch.ops.quant import QuantLinear
from eraxvif5tts_tpu_torch.ops.rotary import (
    abs_pos_embedding_table,
    apply_rotary_heads,
    rotary_freqs,
)
from eraxvif5tts_tpu_torch.ops.train_attention import train_attention

TEXT_MAX_POS = 1024  # reference `mmdit.py:37`


class MMTextEmbedding(nn.Module):
    """Char embedding + absolute sin position over the text's own length
    (`mmdit.py:36-61`). ``text`` ids are -1 padded; +1 makes 0 the filler."""

    def __init__(self, text_num_embeds: int, out_dim: int, mask_padding: bool = True):
        super().__init__()
        self.mask_padding = mask_padding
        self.text_embed = nn.Embedding(text_num_embeds + 1, out_dim)
        self.register_buffer(
            "freqs_cis", torch.from_numpy(abs_pos_embedding_table(out_dim, TEXT_MAX_POS)),
            persistent=False)

    def forward(self, text: torch.Tensor, drop_text: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        text = text + 1
        filler = text == 0  # before the CFG drop
        text = torch.where(drop_text[:, None], torch.zeros_like(text), text)
        embed = self.text_embed(text).to(dtype)
        pos = torch.arange(text.shape[1], device=text.device).clamp(max=TEXT_MAX_POS - 1)
        embed = embed + self.freqs_cis.to(dtype)[pos][None]
        if self.mask_padding:
            embed = embed.masked_fill(filler[..., None], 0.0)
        return embed


class AudioEmbedding(nn.Module):
    """Linear(cat(x, cond)) + conv position embedding (`mmdit.py:64-80`)."""

    def __init__(self, mel_dim: int, out_dim: int):
        super().__init__()
        self.linear = nn.Linear(2 * mel_dim, out_dim)
        self.conv_pos_embed = ConvPositionEmbedding(out_dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                drop_audio_cond: torch.Tensor) -> torch.Tensor:
        cond = cond.masked_fill(drop_audio_cond[:, None, None], 0.0)
        h = linear(torch.cat([x, cond], dim=-1), self.linear)
        return self.conv_pos_embed(h) + h


class JointAttention(nn.Module):
    """Joint attention over the concatenated (text, audio) streams
    (`mmdit.py:83-162`): six projections, q / k RMS norms per stream under
    ``qk_norm="rms_norm"``, each stream rotated by its own angles, the serving
    attention without rotary (eval mode) or the training attention at dropout
    0 (training mode) on ``[b, nt + n, h, d]``, then ``to_out`` and, unless
    ``context_pre_only``, ``to_out_c``. Padded audio rows are zeroed after the
    output projection. ``quantized``: every projection a
    :class:`QuantLinear`."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_pre_only: bool = False,
                 qk_norm: str | None = None, quantized: bool = False):
        super().__init__()
        if qk_norm not in (None, "rms_norm"):
            raise ValueError(f"unimplemented qk_norm: {qk_norm!r}")
        inner = heads * dim_head
        dense = QuantLinear if quantized else nn.Linear
        self.heads, self.dim_head, self.context_pre_only = heads, dim_head, context_pre_only
        for name in ("to_q", "to_k", "to_v", "to_q_c", "to_k_c", "to_v_c"):
            setattr(self, name, dense(dim, inner))
        if qk_norm is not None:
            self.q_norm, self.k_norm = RMSNorm(dim_head), RMSNorm(dim_head)
            self.c_q_norm, self.c_k_norm = RMSNorm(dim_head), RMSNorm(dim_head)
        else:
            self.q_norm = self.k_norm = self.c_q_norm = self.c_k_norm = None
        self.to_out = nn.ModuleList([dense(inner, dim), nn.Dropout(0.0)])
        self.to_out_c = None if context_pre_only else dense(inner, dim)

    def _heads(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return linear(x, layer).view(x.shape[0], x.shape[1], self.heads, self.dim_head)

    def forward(self, x: torch.Tensor, c: torch.Tensor, mask: torch.Tensor | None,
                rope: torch.Tensor, c_rope: torch.Tensor):
        b, n, _ = x.shape
        nt = c.shape[1]
        q, k, v = (self._heads(layer, x) for layer in (self.to_q, self.to_k, self.to_v))
        cq, ck, cv = (self._heads(layer, c) for layer in (self.to_q_c, self.to_k_c, self.to_v_c))
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
            cq, ck = self.c_q_norm(cq), self.c_k_norm(ck)
        q, k = apply_rotary_heads(q, rope), apply_rotary_heads(k, rope)
        cq, ck = apply_rotary_heads(cq, c_rope), apply_rotary_heads(ck, c_rope)
        # text first: the joint key mask is a contiguous prefix
        q, k, v = (torch.cat(pair, dim=1) for pair in ((cq, q), (ck, k), (cv, v)))
        key_valid = None if mask is None else F.pad(mask, (nt, 0), value=True)
        if self.training:  # at dropout 0: MMDiT.run refuses any other rate
            route = head_dim_route(self.dim_head, q.device)
            attend = train_attention if route == "kernel" else plain_train_attention
            out = attend(q, k, v, key_valid=key_valid)
        else:
            out = dot_product_attention(q, k, v, key_valid=key_valid)
        out = out.reshape(b, nt + n, -1)
        x_out = linear(out[:, nt:], self.to_out[0])
        c_out = None if self.context_pre_only else linear(out[:, :nt], self.to_out_c)
        if mask is not None:
            x_out = x_out.masked_fill(~mask[..., None], 0.0)
        return x_out, c_out


class MMDiTBlock(nn.Module):
    """Dual-stream block (`mmdit.py:165-217`): AdaLN-zero on each stream (the
    text stream's ``AdaLayerNormFinal`` in the ``context_pre_only`` block),
    joint attention, then each stream's gated feed-forward on its unfused
    layernorm + modulate."""

    def __init__(self, dim: int, heads: int, dim_head: int, ff_mult: int = 4,
                 context_pre_only: bool = False, qk_norm: str | None = None,
                 quantized: bool = False):
        super().__init__()
        self.context_pre_only = context_pre_only
        self.attn_norm_c = AdaLayerNormFinal(dim) if context_pre_only else AdaLayerNorm(dim)
        self.attn_norm_x = AdaLayerNorm(dim)
        self.attn = JointAttention(dim, heads, dim_head, context_pre_only, qk_norm, quantized)
        self.ff_c = (None if context_pre_only
                     else FeedForward(dim, mult=ff_mult, quantized=quantized))
        self.ff_x = FeedForward(dim, mult=ff_mult, quantized=quantized)

    @staticmethod
    def _ff(ff: FeedForward, h: torch.Tensor, shift: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
        return ff.project(layer_norm(h) * (1 + scale[:, None]) + shift[:, None])

    def forward(self, x: torch.Tensor, c: torch.Tensor, t: torch.Tensor,
                mask: torch.Tensor | None, rope: torch.Tensor, c_rope: torch.Tensor):
        if self.context_pre_only:
            norm_c = self.attn_norm_c(c, t)
        else:
            norm_c, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.attn_norm_c(c, t)
        norm_x, x_gate_msa, x_shift_mlp, x_scale_mlp, x_gate_mlp = self.attn_norm_x(x, t)
        x_attn, c_attn = self.attn(norm_x, norm_c, mask, rope, c_rope)
        c_out = None
        if not self.context_pre_only:
            c = c + c_gate_msa[:, None] * c_attn
            c_out = c + c_gate_mlp[:, None] * self._ff(self.ff_c, c, c_shift_mlp, c_scale_mlp)
        x = x + x_gate_msa[:, None] * x_attn
        x = x + x_gate_mlp[:, None] * self._ff(self.ff_x, x, x_shift_mlp, x_scale_mlp)
        return c_out, x


class MMDiT(nn.Module):
    """Flow-prediction MMDiT: ``(x, cond, text, t) -> flow [b, n, mel]``
    (`mmdit.py:220-281`). The compute dtype is ``compute_dtype``, or the
    parameters' dtype when that is None (serving, where the wrapper casts
    the parameters)."""

    def __init__(self, arch: ArchConfig, text_num_embeds: int = 256, mel_dim: int = 100,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        if arch.scan_layers:
            raise ValueError("scan_layers=True is the JAX package's compile-time workaround "
                             "and is not ported: build the unrolled form")
        self.arch = arch
        self.mel_dim = mel_dim
        self.compute_dtype = compute_dtype
        self.time_embed = TimestepEmbedding(arch.dim)
        self.text_embed = MMTextEmbedding(text_num_embeds, arch.dim,
                                          mask_padding=arch.text_mask_padding)
        self.audio_embed = AudioEmbedding(mel_dim, arch.dim)
        self.transformer_blocks = nn.ModuleList(
            [MMDiTBlock(arch.dim, arch.heads, arch.dim_head, arch.ff_mult,
                        context_pre_only=i == arch.depth - 1, qk_norm=arch.qk_norm,
                        quantized=arch.quantized)
             for i in range(arch.depth)])
        self.norm_out = AdaLayerNormFinal(arch.dim)
        self.proj_out = nn.Linear(arch.dim, mel_dim)
        self._rope: dict[tuple[int, torch.device], torch.Tensor] = {}

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.proj_out.weight.dtype

    def rope(self, seq_len: int, device: torch.device) -> torch.Tensor:
        """Rotary angles ``[seq_len, dim_head]`` fp32 of one stream, kept per
        length so the Euler loop never copies them from the host."""
        key = (seq_len, torch.device(device))
        if key not in self._rope:
            # setdefault: threads that race here all take the one table kept
            self._rope.setdefault(key, rotary_freqs(seq_len, self.arch.dim_head,
                                                    device=device))
        return self._rope[key]

    @full_fp32
    def embed_text(self, text: torch.Tensor, seq_len: int,
                   drop_text: torch.Tensor) -> torch.Tensor:
        """The text stream at the text's own (bucket) length; ``seq_len`` is
        unused, as in the JAX MMDiT (`mmdit.py:249-251`)."""
        return self.text_embed(text, drop_text, self.dtype)

    @full_fp32
    def run(self, x: torch.Tensor, cond: torch.Tensor, text_embed: torch.Tensor,
            time: torch.Tensor, drop_audio_cond: torch.Tensor,
            mask: torch.Tensor | None = None, dropout_keys=None,
            deterministic: bool = False) -> torch.Tensor:
        """Forward from a precomputed text stream (the Euler-loop hot path).
        In training mode ``arch.dropout`` must be 0 and ``dropout_keys`` go
        unused (see the module docstring); ``deterministic`` (a training-mode
        forward without dropout) changes nothing here."""
        if self.training:
            if self.arch.quantized:
                raise ValueError("a quantized MMDiT serves only: call .eval() (int8 models are "
                                 "not trained)")
            if self.arch.dropout > 0.0:
                raise ValueError(
                    f"MMDiT training at dropout {self.arch.dropout} is refused: the JAX MMDiT "
                    "cannot train at dropout > 0 (eraxvif5tts_tpu/models/mmdit.py:157 calls "
                    "hash_dropout, which the module never imports, and raises NameError; "
                    "ROADMAP queue 3, the JAX MMDiT's missing hash_dropout import); train "
                    "with dropout=0.0")
        batch, seq_len = x.shape[0], x.shape[1]
        if time.ndim == 0:
            time = time.expand(batch)
        x, cond, c = (t.to(self.dtype) for t in (x, cond, text_embed))
        t = self.time_embed(time, self.dtype)
        h = self.audio_embed(x, cond, drop_audio_cond)
        rope, c_rope = self.rope(seq_len, x.device), self.rope(c.shape[1], x.device)
        for block in self.transformer_blocks:
            c, h = block(h, c, t, mask, rope, c_rope)
        h = self.norm_out(h, t)
        return linear(h.to(self.proj_out.weight.dtype), self.proj_out).float()

    def forward(self, x: torch.Tensor, cond: torch.Tensor, text: torch.Tensor,
                time: torch.Tensor, drop_audio_cond: torch.Tensor, drop_text: torch.Tensor,
                mask: torch.Tensor | None = None, dropout_keys=None,
                deterministic: bool = False) -> torch.Tensor:
        """The whole MMDiT (the JAX ``__call__``): the text stream, then
        :meth:`run`."""
        return self.run(x, cond, self.embed_text(text, x.shape[1], drop_text), time,
                        drop_audio_cond, mask, dropout_keys, deterministic)
