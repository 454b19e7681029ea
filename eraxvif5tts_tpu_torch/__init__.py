"""PyTorch/CUDA port of EraXviF5TTS for NVIDIA Hopper (H100).

A second package beside the JAX reference `eraxvif5tts_tpu`, with the same
layout (`ops/`, `models/`, `infer/`, `serving/`) so each module's counterpart
is easy to find. It imports `torch` and never `jax` or `flax`; the jax-free
host modules of the reference package (configs, text frontend, audio IO,
checkpoint key rules) are reused by import.

The two Pallas kernels of the serving path are hand-written CUDA C++ for
`sm_90a` (`csrc/`), built with `nvcc` at first use (`ops/_cuda.py`):

- `ops/serving_attention.py` — masked softmax attention with fused rotary;
- `ops/fused_matmul.py` — `ln_mod_matmul`, the AdaLN-modulated FF input
  projection with a tanh-GELU epilogue.

Each has a plain PyTorch version beside it, used for CPU tensors and to check
the kernel on the card.
"""

__version__ = "0.1.0"
