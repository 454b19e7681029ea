"""Int8 W8A8 serving: per-channel int8 weights, per-row int8 activations.

Port of `eraxvif5tts_tpu/ops/quant.py` (``compute_dtype="int8"``, opt-in):

- weights: symmetric per-output-channel int8, ``scale = max(amax, 1e-8) / 127``
  in fp32, codes ``clip(round(w / scale), -127, 127)`` with a true division
  and round-half-to-even, folded from the fp checkpoint once at load
  (:func:`quantize_weight`, :func:`quantize_state_dict`);
- activations: the same scheme per row, on the fly (no calibration pass);
- the int8 x int8 -> int32 product, dequantized in fp32
  (``acc * a_scale * w_scale``), then cast to the compute dtype; the bias is
  added after the cast, in the compute dtype.

Weights are ``nn.Linear``'s ``[out, in]``: the amax runs over ``in``, the JAX
``axis=0`` of its ``[in, out]`` kernel. These GEMMs are ones the JAX package
leaves to XLA, outside any Pallas kernel, so the product is ``torch._int_mm``
(cuBLASLt on the card). On a CUDA tensor it takes ``K``, ``N`` multiples of
8 (anything else raises) and ``M > 16`` rows: fewer are padded with zero
rows, which leaves the sums of the others exact.

The quality gate (:func:`quant_divergence`, :data:`INT8_REL_MSE_THRESHOLD`) is
the JAX package's, on the port's sampler.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from eraxvif5tts_tpu_torch.compression.convert import dit_rules, mmdit_rules, unett_rules

# the Dense names `quantize_params` quantizes (`ops/quant.py` `_QUANT_SUFFIXES`;
# copied: that module imports jax). Not "skip_proj" (UNetT), as there; that
# was the one indexed name (`skip_proj_<i>`), so a plain match suffices.
QUANT_SUFFIXES = ("to_q", "to_k", "to_v", "to_out", "project_in", "project_out",
                  "to_q_c", "to_k_c", "to_v_c", "to_out_c")

# 1 % relative mel MSE, int8 against bf16 on the same weights (`ops/quant.py:157`,
# where its calibration is written down)
INT8_REL_MSE_THRESHOLD = 1e-2


def quantize_rows(x32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of fp32 ``x32`` per row (last axis) and the fp32
    scales ``[..., 1]``."""
    amax = x32.abs().amax(dim=-1, keepdim=True)
    # a true division on every device: PyTorch divides a CUDA tensor by a
    # Python scalar as a product with its reciprocal, which moves the scale by
    # an ulp and flips codes at ties
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8), scale


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``w [out, in]`` -> (int8 ``w_q [out, in]``, fp32 per-output-channel
    ``scale [out]``)."""
    w_q, scale = quantize_rows(w.float())
    return w_q, scale[:, 0]


def int_mm(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int32 ``a_q [..., K] @ w_q[N, K]^T`` over int8 operands (``torch._int_mm``
    on 2-D views)."""
    k = a_q.shape[-1]
    a2 = a_q.reshape(-1, k)
    n = w_q.shape[0]
    rows = a2.shape[0]
    if a_q.device.type == "cuda":
        if k % 8 or n % 8:
            raise ValueError(f"int8 GEMM on {a_q.device}: torch._int_mm takes K, N multiples "
                             f"of 8, got K={k}, N={n}")
        if rows <= 16:
            a2 = torch.nn.functional.pad(a2, (0, 0, 0, 17 - rows))
    return torch._int_mm(a2, w_q.t())[:rows].view(*a_q.shape[:-1], n)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x [..., in] @ dequant(w_q [out, in])^T`` with dynamic per-row
    activation quantization; ``[..., out]`` in ``out_dtype``."""
    x_q, a_scale = quantize_rows(x.float())
    return (int_mm(x_q, w_q).float() * a_scale * w_scale).to(out_dtype)


class QuantLinear(nn.Module):
    """The ``QuantDense`` counterpart: ``int8_matmul(x, weight_q, weight_scale)``
    in x's dtype, plus the bias in x's dtype. ``weight_q`` (int8 ``[out, in]``)
    and ``weight_scale`` (fp32 ``[out]``) are buffers: they are read, never
    trained, and a dtype cast of the module must not touch them."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight_q", torch.zeros(out_features, in_features,
                                                     dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_matmul(x, self.weight_q, self.weight_scale, out_dtype=x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)


def quantized_weight_keys(depth: int, backbone: str = "DiT") -> list[str]:
    """The backbone's reference-schema keys of the Linear weights that
    `quantize_params` quantizes: every rule of `dit_rules`, `unett_rules` or
    `mmdit_rules` whose flax path is the ``kernel`` of a Dense named in
    :data:`QUANT_SUFFIXES`. In a DiT block or a UNetT layer:
    ``attn.to_{q,k,v}``, ``attn.to_out.0``, ``ff.ff.0.0`` and ``ff.ff.2``; the
    UNetT's ``skip_proj`` stays unquantized. In an MMDiT block also the text
    stream's ``attn.to_{q,k,v}_c``, ``attn.to_out_c``, ``ff_c.ff.0.0`` and
    ``ff_c.ff.2``, which the last block (``context_pre_only``) has not."""
    rules = {"DiT": lambda depth: dit_rules(depth, conv_layers=0),
             "UNetT": lambda depth: unett_rules(depth, conv_layers=0),
             "MMDiT": mmdit_rules}.get(backbone)
    if rules is None:
        raise ValueError(f"int8 quantization of backbone {backbone!r} is not ported "
                         "(DiT | UNetT | MMDiT)")
    return [key for key, path, _, _ in rules(depth)
            if path[-1] == "kernel" and path[-2] in QUANT_SUFFIXES]


def quantize_state_dict(state_dict: dict[str, torch.Tensor], depth: int,
                        backbone: str = "DiT") -> dict[str, torch.Tensor]:
    """A backbone's state dict in the reference schema -> the quantized
    backbone's: each weight of :func:`quantized_weight_keys` replaced by
    ``weight_q`` / ``weight_scale`` (the `quantize_params` counterpart);
    every other entry is passed through."""
    out = dict(state_dict)
    for key in quantized_weight_keys(depth, backbone):
        stem = key[:-len("weight")]
        out[stem + "weight_q"], out[stem + "weight_scale"] = quantize_weight(out.pop(key))
    return out


def cast_for_serving(module: nn.Module) -> nn.Module:
    """The int8 serving dtypes, in place: every floating-point matrix (and
    higher-rank tensor) bf16, vectors (biases, weight scales) fp32, int8
    codes as they are — the JAX wrapper's cast of a quantized tree
    (`wrapper.py:282-285`)."""
    return module._apply(lambda t: t.to(torch.bfloat16)
                         if t.is_floating_point() and t.ndim > 1 else t)


# ---------------------------------------------------------------------------
# quality gate


def fixed_inputs(num_channels: int, vocab: int, max_duration: int = 512,
                 text_len: int = 32, prompt_frames: int = 128, seed: int = 7) -> dict:
    """The gate's deterministic prompt, text, lengths, sampler noise and
    forward input (numpy). The JAX fixture (`ops/quant.py` `_fixed_inputs`
    and the keys 3 and 11 of `quant_divergence`) draws the same shapes from
    ``jax.random``, but for the text's filler; this one draws from a seeded
    numpy generator, so the two gates score the same statistic on different
    draws (tests pass the JAX draws in through ``inputs``)."""
    rng = np.random.default_rng(seed)
    # the text padded with -1 to a multiple of 64 ids (the JAX fixture pads 8):
    # the MMDiT's joint sequence, text then mel, stays 64-aligned for the
    # serving attention kernel. The DiT and the UNetT cut or pad the ids to
    # the mel length with 0, which a -1 filler is after +1, so their readings
    # are those of any other filler length.
    text = np.full((1, -(-text_len // 64) * 64), -1, np.int64)
    text[0, :text_len] = rng.integers(0, vocab, text_len)
    return {
        "cond": (0.3 * rng.standard_normal((1, prompt_frames, num_channels))).astype(np.float32),
        "text": text,
        "duration": np.array([max_duration - 64]),
        "lens": np.array([prompt_frames]),
        "noise": rng.standard_normal((max_duration, num_channels)).astype(np.float32),
        "x_in": (0.5 * rng.standard_normal((1, max_duration, num_channels))).astype(np.float32),
    }


def quant_divergence(cfm_bf16, cfm_int8, steps: int = 16, max_duration: int = 512,
                     text_len: int = 32, prompt_frames: int = 128,
                     inputs: dict | None = None) -> dict:
    """int8-against-bf16 divergence on a fixed prompt and noise: the relative
    mel MSE over the generated region, the log-spectral distance (dB) and the
    relative MSE of one backbone forward. ``passes_gate`` applies
    :data:`INT8_REL_MSE_THRESHOLD`. ``inputs`` defaults to :func:`fixed_inputs`."""
    if max_duration - 64 <= prompt_frames:
        raise ValueError(
            f"max_duration={max_duration} leaves no generated region to score "
            f"(needs > prompt_frames+64 = {prompt_frames + 64})")
    dit = cfm_bf16.transformer
    d = cfm_bf16.num_channels
    if inputs is None:
        vocab = min(dit.text_embed.text_embed.num_embeddings - 1, 100)
        inputs = fixed_inputs(d, vocab, max_duration, text_len, prompt_frames)
    device = dit.proj_out.weight.device
    t = {k: torch.as_tensor(np.array(v)).to(device) for k, v in inputs.items()}

    outs, fwd = {}, {}
    cond_full = torch.nn.functional.pad(t["cond"], (0, 0, 0, max_duration - prompt_frames))
    no_drop = torch.zeros(1, dtype=torch.bool, device=device)
    mask = torch.arange(max_duration, device=device)[None] < max_duration - 64
    with torch.inference_mode():
        for name, cfm in (("bf16", cfm_bf16), ("int8", cfm_int8)):
            mel = cfm.sample(t["cond"], t["text"], t["duration"], t["lens"], noise=t["noise"],
                             steps=steps, max_duration=max_duration)
            outs[name] = mel[0, prompt_frames:max_duration - 64].double().cpu().numpy()
            pred = cfm.transformer(t["x_in"], cond_full, t["text"],
                                   torch.full((1,), 0.5, device=device), no_drop, no_drop, mask)
            fwd[name] = pred.double().cpu().numpy()

    a, b = outs["int8"], outs["bf16"]
    rel_mse = float(np.mean((a - b) ** 2) / max(np.mean(b * b), 1e-12))
    # mels are log-magnitude already: LSD = rms frame-wise dB difference
    lsd_db = float(np.mean(np.sqrt(np.mean((20 / np.log(10) * (a - b)) ** 2, axis=-1))))
    forward_rel_mse = float(np.mean((fwd["int8"] - fwd["bf16"]) ** 2)
                            / max(np.mean(fwd["bf16"] ** 2), 1e-12))
    return {"rel_mse": rel_mse, "lsd_db": lsd_db, "forward_rel_mse": forward_rel_mse,
            "passes_gate": rel_mse <= INT8_REL_MSE_THRESHOLD}
