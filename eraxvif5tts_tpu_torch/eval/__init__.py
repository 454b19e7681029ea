"""Evaluation harness on PyTorch (port of `eraxvif5tts_tpu/eval`): batched
inference over test sets + WER / SIM / UTMOS scoring (reference
`src/f5_tts/eval/*`)."""
