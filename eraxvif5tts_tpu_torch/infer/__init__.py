"""Inference layer of the port: the `F5TTSWrapper` zero-shot cloning API."""
