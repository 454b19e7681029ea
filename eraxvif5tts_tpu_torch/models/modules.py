"""Transformer building blocks of the DiT and the UNetT (port of
`eraxvif5tts_tpu/models/modules.py`).

Parameter names follow the reference torch checkpoint schema
(`compression/convert.py` ``dit_rules`` / ``unett_rules``), so a reference
state dict loads with ``load_state_dict(strict=True)``.

Conventions, as in the JAX package:

- sequence tensors are ``[b, n, d]``; boolean masks mark VALID positions and
  are contiguous prefixes (``lens_to_mask``);
- the compute dtype is the dtype of the input; parameters are cast to it at
  use (a no-op for the served backbone, whose parameters the wrapper holds in
  the compute dtype; training keeps fp32 parameters and computes in bf16, and
  autograd carries the gradients through the casts to the fp32 parameters;
  the vocoder keeps fp32 parameters);
- layernorm statistics are fp32.

Two modes, as the JAX package's ``deterministic`` flag: in eval mode
(serving) :class:`Attention` calls the masked serving attention (rotary fused
into the kernel when every head is rotated; with ``pe_attn_head`` the first
heads are rotated here and the kernel runs without rotary) and
:class:`FeedForward` the normalised, modulated input projection kernel; in
training mode (``module.train()``, the JAX ``deterministic=False``) q and k
are rotated outside the kernel, attention runs through the training kernels
with attention dropout, the feed-forward takes the unfused path, and the
attention output and the FF hidden state get position-hash dropout. The
dropout rate is an argument of the forward (the DiT passes its
``arch.dropout``), and each site is seeded by a key of two 32-bit words that
the caller draws before the forward (3 per block): an activation-checkpoint
recompute then reproduces every mask. The JAX package's grouped-convolution tap loop (a TPU speed trick)
is a plain ``F.conv1d(groups=16)`` here.

A quantized block (``quantized=True``, the JAX ``quantized`` int8 W8A8
serving path, eval mode only) holds :class:`QuantLinear` for the four
attention projections and both FF projections. Its attention keeps the
serving kernel with rotary fused; its FF takes the layernorm + modulate
unfused, then the two-``QuantLinear`` chain (bf16 outputs, tanh-GELU in
bf16), or the one-kernel ``int8_ff`` with ``ERAX_INT8_FF=1`` — never the
``ln_mod_matmul`` kernel (`modules.py:457-462`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from eraxvif5tts_tpu_torch.ops.attention import dot_product_attention
from eraxvif5tts_tpu_torch.ops.dropout import hash_dropout
from eraxvif5tts_tpu_torch.ops.fused_matmul import ln_mod_matmul
from eraxvif5tts_tpu_torch.ops.quant import QuantLinear
from eraxvif5tts_tpu_torch.ops.quant_ff import int8_ff, use_int8_ff
from eraxvif5tts_tpu_torch.ops.rotary import apply_rotary_heads
from eraxvif5tts_tpu_torch.ops.train_attention import attention_seed, train_attention


def linear(x: torch.Tensor, layer: nn.Linear | QuantLinear) -> torch.Tensor:
    """``layer(x)`` computed in x's dtype (a :class:`QuantLinear` quantizes x
    itself)."""
    if isinstance(layer, QuantLinear):
        return layer(x)
    bias = layer.bias.to(x.dtype) if layer.bias is not None else None
    return F.linear(x, layer.weight.to(x.dtype), bias)


def conv1d(x: torch.Tensor, layer: nn.Conv1d) -> torch.Tensor:
    """``layer(x)`` over ``x [b, c, n]`` computed in x's dtype."""
    return F.conv1d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype),
                    stride=layer.stride, padding=layer.padding,
                    dilation=layer.dilation, groups=layer.groups)


def layer_norm(x: torch.Tensor, layer: nn.LayerNorm | None = None) -> torch.Tensor:
    """Layernorm over the last axis in fp32 (eps 1e-6), returned in x's dtype;
    scale-free when ``layer`` is None."""
    weight = layer.weight.float() if layer is not None else None
    bias = layer.bias.float() if layer is not None else None
    return F.layer_norm(x.float(), x.shape[-1:], weight, bias, 1e-6).to(x.dtype)


class SinusPositionEmbedding(nn.Module):
    """Sinusoidal embedding, scale 1000, fp32 (`modules.py:32-44`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                          * -(math.log(10000.0) / (half - 1)))
        args = 1000.0 * x[:, None].float() * freqs[None, :]
        return torch.cat([args.sin(), args.cos()], dim=-1)


class TimestepEmbedding(nn.Module):
    """Sinus embedding -> Linear -> SiLU -> Linear (`modules.py:47-59`)."""

    def __init__(self, dim: int, freq_embed_dim: int = 256):
        super().__init__()
        self.sinus = SinusPositionEmbedding(freq_embed_dim)
        self.time_mlp = nn.Sequential(nn.Linear(freq_embed_dim, dim), nn.SiLU(),
                                      nn.Linear(dim, dim))

    def forward(self, timestep: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        hidden = self.sinus(timestep).to(dtype)
        hidden = F.silu(linear(hidden, self.time_mlp[0]))
        return linear(hidden, self.time_mlp[2])


class GRN(nn.Module):
    """Global response normalisation over the sequence axis (`modules.py:62-73`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gx = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return self.gamma.to(x.dtype) * (x * nx) + self.beta.to(x.dtype) + x


class ConvNeXtV2Block(nn.Module):
    """Depthwise conv7 -> LN -> Linear -> GELU -> GRN -> Linear, residual
    (`modules.py:93-119`)."""

    def __init__(self, dim: int, intermediate_dim: int):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.grn = GRN(intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        x = conv1d(x.transpose(1, 2), self.dwconv).transpose(1, 2)
        x = layer_norm(x, self.norm)
        x = F.gelu(linear(x, self.pwconv1))
        x = self.grn(x)
        return residual + linear(x, self.pwconv2)


class ConvPositionEmbedding(nn.Module):
    """Two grouped conv1d (k=31, groups=16) + Mish, masked before and after
    (`modules.py:157-180`)."""

    def __init__(self, dim: int, kernel_size: int = 31, groups: int = 16):
        super().__init__()
        self.conv1d = nn.Sequential(
            nn.Conv1d(dim, dim, kernel_size, groups=groups, padding=kernel_size // 2),
            nn.Mish(),
            nn.Conv1d(dim, dim, kernel_size, groups=groups, padding=kernel_size // 2),
            nn.Mish(),
        )

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if mask is not None:
            x = x.masked_fill(~mask[..., None], 0.0)
        h = x.transpose(1, 2)
        h = F.mish(conv1d(h, self.conv1d[0]))
        h = F.mish(conv1d(h, self.conv1d[2]))
        x = h.transpose(1, 2)
        if mask is not None:
            x = x.masked_fill(~mask[..., None], 0.0)
        return x


class RMSNorm(nn.Module):
    """RMS norm with a learnable scale, statistics in fp32 (`modules.py:183-194`;
    the q / k norm of ``qk_norm="rms_norm"``). The scale is cast to x's dtype
    at use, as every parameter of the port is."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps).to(x.dtype) * self.weight.to(x.dtype)


class XRMSNorm(nn.Module):
    """x_transformers-style RMSNorm of the UNetT, ``x / max(|x|, 1e-12) *
    sqrt(d) * g`` with the norm in fp32 (`models/unett.py:28-42`). On the
    fused serving path the caller reads ``g`` and folds it into
    ``ln_mod_matmul(norm="rms")``'s ``scale``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = x.float().square().sum(dim=-1, keepdim=True).sqrt()
        normed = x / norm.clamp(min=1e-12).to(x.dtype)
        return normed * (self.dim ** 0.5) * self.g.to(x.dtype)


class AdaLayerNorm(nn.Module):
    """AdaLN-zero: SiLU -> Linear -> 6-way modulation (`modules.py:197-219`).
    Returns the modulated attention input and (gate_msa, shift_mlp,
    scale_mlp, gate_mlp)."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, dim * 6)

    def forward(self, x: torch.Tensor, emb: torch.Tensor):
        mod = linear(F.silu(emb), self.linear)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        out = layer_norm(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        return out, gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormFinal(nn.Module):
    """Final AdaLN, chunk order (scale, shift) (`modules.py:240-260`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, dim * 2)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        scale, shift = linear(F.silu(emb), self.linear).chunk(2, dim=-1)
        return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


class FeedForward(nn.Module):
    """The feed-forward of a block. :meth:`forward` takes the block's pre-norm
    input: norm + modulate + Linear + tanh-GELU, dropout, Linear. In eval mode
    the first four are one kernel (`ln_mod_matmul`, the fused serving branch,
    `modules.py:289-307`, `:485-496`): ``norm="ln"`` for the DiT's AdaLN,
    ``norm="rms"`` for the UNetT with ``scale = g - 1`` and ``shift = 0``
    (`unett.py:77-81`). In training mode, and quantized, the layernorm +
    modulate is unfused and :meth:`project` does the rest: Linear, tanh-GELU,
    dropout, Linear (`modules.py:322-329`, `:498-500`), or quantized the int8
    chain or ``int8_ff`` (`modules.py:309-329`). The UNetT's unfused branch
    normalises with its own :class:`XRMSNorm` and calls :meth:`project`. Keys
    ``ff.0.0`` / ``ff.2`` as in the reference."""

    def __init__(self, dim: int, mult: int = 4, quantized: bool = False):
        super().__init__()
        inner = int(dim * mult)
        dense = QuantLinear if quantized else nn.Linear
        self.quantized = quantized
        self.ff = nn.Sequential(
            nn.Sequential(dense(dim, inner), nn.GELU(approximate="tanh")),
            nn.Dropout(0.0),
            dense(inner, dim),
        )

    def forward(self, x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                dropout_rate: float = 0.0, dropout_key=None, norm: str = "ln") -> torch.Tensor:
        project_in = self.ff[0][0]
        if not self.training and not self.quantized:
            h = ln_mod_matmul(x, scale.contiguous(), shift.contiguous(), project_in.weight,
                              project_in.bias, activation="gelu_tanh", norm=norm)
            return linear(h, self.ff[2])
        if norm != "ln":
            raise ValueError(f"the unfused feed-forward normalises with the layernorm only, "
                             f"got norm={norm!r}: normalise outside and call project()")
        h = layer_norm(x) * (1 + scale[:, None]) + shift[:, None]
        return self.project(h, dropout_rate, dropout_key)

    def project(self, h: torch.Tensor, dropout_rate: float = 0.0,
                dropout_key=None) -> torch.Tensor:
        """Linear, tanh-GELU, dropout, Linear of a normalised input."""
        project_in, project_out = self.ff[0][0], self.ff[2]
        if self.quantized:
            if use_int8_ff():
                return int8_ff(h, project_in.weight_q, project_in.weight_scale,
                               project_in.bias, project_out.weight_q,
                               project_out.weight_scale, project_out.bias)
            return project_out(F.gelu(project_in(h), approximate="tanh"))
        h = F.gelu(linear(h, project_in), approximate="tanh")
        return linear(hash_dropout(h, dropout_rate, dropout_key), project_out)


class Attention(nn.Module):
    """Self-attention with optional RMS norm of q and k per head
    (``qk_norm="rms_norm"``), rotary on every head or on the first
    ``pe_attn_head`` heads, and padded query rows zeroed after the output
    projection (`modules.py:332-434`). In eval mode rotary on every head is
    fused into the serving kernel; with ``pe_attn_head`` q and k are rotated
    here (cos/sin in the compute dtype, `modules.py:386-390`) and the kernel
    runs without rotary. In training mode q and k are always rotated here,
    the training kernels apply attention dropout, and the output projection
    gets position-hash dropout. ``mask [b, n]`` must be a contiguous prefix;
    ``dropout_keys`` are the (attention, output) keys of a training call at
    ``dropout_rate``."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, quantized: bool = False,
                 qk_norm: str | None = None, pe_attn_head: int | None = None):
        super().__init__()
        if qk_norm not in (None, "rms_norm"):
            raise ValueError(f"unimplemented qk_norm: {qk_norm!r}")
        inner = heads * dim_head
        dense = QuantLinear if quantized else nn.Linear
        self.heads, self.dim_head, self.pe_attn_head = heads, dim_head, pe_attn_head
        self.to_q = dense(dim, inner)
        self.to_k = dense(dim, inner)
        self.to_v = dense(dim, inner)
        if qk_norm is not None:
            self.q_norm = RMSNorm(dim_head)
            self.k_norm = RMSNorm(dim_head)
        else:
            self.q_norm = self.k_norm = None
        self.to_out = nn.ModuleList([dense(inner, dim), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                rope: torch.Tensor | None = None, dropout_rate: float = 0.0,
                dropout_keys=(None, None)) -> torch.Tensor:
        b, n, _ = x.shape
        shape = (b, n, self.heads, self.dim_head)
        q = linear(x, self.to_q).view(shape)
        k = linear(x, self.to_k).view(shape)
        v = linear(x, self.to_v).view(shape)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if not self.training:
            if rope is not None and self.pe_attn_head is not None:
                q = apply_rotary_heads(q, rope, self.pe_attn_head)
                k = apply_rotary_heads(k, rope, self.pe_attn_head)
                rope = None
            out = dot_product_attention(q, k, v, key_valid=mask, rope=rope)
            out = linear(out.reshape(b, n, -1), self.to_out[0])
        else:
            if rope is not None:
                q = apply_rotary_heads(q, rope, self.pe_attn_head)
                k = apply_rotary_heads(k, rope, self.pe_attn_head)
            seed = attention_seed(dropout_keys[0]) if dropout_rate > 0.0 else 0
            out = train_attention(q, k, v, key_valid=mask, dropout_rate=dropout_rate, seed=seed)
            out = linear(out.reshape(b, n, -1), self.to_out[0])
            out = hash_dropout(out, dropout_rate, dropout_keys[1])
        if mask is not None:
            out = out.masked_fill(~mask[..., None], 0.0)
        return out


class DiTBlock(nn.Module):
    """AdaLN-zero pre-norm attention + gated feed-forward (`modules.py:437-501`).
    ``dropout_keys`` (training at ``dropout_rate``): the keys of the block's
    three dropout sites, attention weights, attention output and FF hidden
    state, in the order the JAX block draws them."""

    def __init__(self, dim: int, heads: int, dim_head: int, ff_mult: int = 4,
                 quantized: bool = False, qk_norm: str | None = None,
                 pe_attn_head: int | None = None):
        super().__init__()
        self.attn_norm = AdaLayerNorm(dim)
        self.attn = Attention(dim, heads=heads, dim_head=dim_head, quantized=quantized,
                              qk_norm=qk_norm, pe_attn_head=pe_attn_head)
        self.ff = FeedForward(dim, mult=ff_mult, quantized=quantized)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                mask: torch.Tensor | None = None,
                rope: torch.Tensor | None = None, dropout_rate: float = 0.0,
                dropout_keys=(None, None, None)) -> torch.Tensor:
        norm, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.attn_norm(x, t)
        x = x + gate_msa[:, None] * self.attn(norm, mask, rope, dropout_rate, dropout_keys[:2])
        return x + gate_mlp[:, None] * self.ff(x, scale_mlp, shift_mlp, dropout_rate,
                                               dropout_keys[2])
