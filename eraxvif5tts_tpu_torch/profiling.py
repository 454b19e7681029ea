"""Tracing / profiling utilities (port of `eraxvif5tts_tpu/profiling.py`):
``torch.profiler`` traces in place of ``jax.profiler``'s, a device sync, and
the explicit RTF / first-chunk meter (a host copy of the JAX package's;
`tests/test_torch_hostcopies.py` holds it to the original)."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (a ``*.pt.trace.json`` Chrome trace, viewable in TensorBoard or Perfetto):
    host activity always, the CUDA device's when one is present. Yields the
    profiler (``key_averages()`` reads the same events). ``log_dir``
    defaults to ``eraxvif5tts_trace`` under the temporary directory."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "eraxvif5tts_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def force_sync(x: torch.Tensor) -> None:
    """Wait until the work that produces ``x`` is done: a device sync of
    ``x``'s CUDA device, else a fetch of one element to the host."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
        return
    if x.ndim > 0:
        x = x[(0,) * x.ndim]
    x.item()


@dataclass
class RTFMeter:
    """Accumulates synthesis wall-time vs audio duration (the serving KPI)."""

    sample_rate: int = 24000
    total_audio_samples: int = 0
    total_wall_seconds: float = 0.0
    chunks: list[float] = field(default_factory=list)
    first_chunk_latencies: list[float] = field(default_factory=list)
    _t0: Optional[float] = None
    _first_seen: bool = False

    def start_request(self) -> None:
        self._t0 = time.perf_counter()
        self._first_seen = False

    def record_chunk(self, n_samples: int) -> None:
        assert self._t0 is not None, "call start_request() first"
        now = time.perf_counter()
        if not self._first_seen:
            self.first_chunk_latencies.append(now - self._t0)
            self._first_seen = True
        self.total_audio_samples += n_samples

    def end_request(self) -> None:
        assert self._t0 is not None
        self.total_wall_seconds += time.perf_counter() - self._t0
        self._t0 = None

    @property
    def rtf(self) -> float:
        audio = self.total_audio_samples / self.sample_rate
        return audio / max(self.total_wall_seconds, 1e-9)

    def summary(self) -> dict:
        lat = sorted(self.first_chunk_latencies)
        return {
            "rtf": round(self.rtf, 3),
            "audio_seconds": round(self.total_audio_samples / self.sample_rate, 2),
            "wall_seconds": round(self.total_wall_seconds, 2),
            "first_chunk_p50_ms": round(1000 * lat[len(lat) // 2], 1) if lat else None,
            "requests": len(self.first_chunk_latencies),
        }

    def dump(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.summary(), f, indent=2)
