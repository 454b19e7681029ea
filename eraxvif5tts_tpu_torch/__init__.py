"""PyTorch/CUDA port of EraXviF5TTS for NVIDIA Hopper (H100).

A second package beside the JAX reference `eraxvif5tts_tpu`, with the same
layout (`configs/`, `text/`, `audio/`, `ops/`, `models/`, `compression/`,
`infer/`, `serving/`, `training/`) so each module's counterpart is easy to
find. It imports `torch` and never `jax` or `flax`, and nothing of the
reference package: the host modules it needs (configs, text frontend, audio
IO, checkpoint key rules) are its own copies.

The Pallas kernels of the reference are hand-written CUDA C++ for `sm_90a`
(`csrc/`), built with `nvcc` at first use (`ops/_cuda.py`):

- `ops/serving_attention.py` — masked softmax attention, with or without
  fused rotary;
- `ops/fused_matmul.py` — `ln_mod_matmul`, the normalised (layernorm or RMS)
  and modulated FF input projection with a tanh-GELU epilogue, and
  `matmul_gate_res`, the gated residual projection;
- `ops/train_attention.py` — flash training attention with position-hash
  dropout (forward, dq, dk/dv);
- `ops/quant_ff.py` — the one-kernel int8 W8A8 feed-forward.

Each has a plain PyTorch version beside it, used for CPU tensors and to check
the kernel on the card.
"""

__version__ = "0.1.0"
