"""Host-side audio utilities: WAV IO, resampling, silence detection (the
port's own copy of `eraxvif5tts_tpu/audio/{io,resample,silence}.py`; numpy and
scipy only)."""

from eraxvif5tts_tpu_torch.audio.io import read_wav, write_wav  # noqa: F401
from eraxvif5tts_tpu_torch.audio.resample import resample  # noqa: F401
from eraxvif5tts_tpu_torch.audio.silence import (  # noqa: F401
    clip_reference_audio,
    detect_leading_silence,
    remove_silence_edges,
    split_on_silence,
)
