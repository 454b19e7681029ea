"""Tensor ops of the port: masks, rotary, mel/ISTFT and the two CUDA kernels'
wrappers (`serving_attention`, `fused_matmul`)."""
