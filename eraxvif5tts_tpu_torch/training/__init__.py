"""CFM training on PyTorch (port of `eraxvif5tts_tpu/training`)."""
