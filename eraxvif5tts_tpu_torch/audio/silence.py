"""Silence detection / reference-audio clipping (numpy port of the pydub logic).

Behavior parity with reference `src/f5_tts/infer/utils_infer.py:273-328`
(``remove_silence_edges``, ``preprocess_ref_audio_text`` clipping cascade) using the
same dB thresholds (-50/-40/-42 dBFS), silence windows (1000/100 ms), keep_silence
(1000 ms) and the 6 s / 12 s accumulation budget.

dBFS here is measured against full scale 1.0 for float waveforms in [-1, 1]
(pydub measures against the int max — identical after normalization).
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-12


def _window_dbfs(wav: np.ndarray, sr: int, win_ms: int, step_ms: int) -> tuple[np.ndarray, np.ndarray]:
    """RMS dBFS of sliding windows. Returns (start_samples, dbfs)."""
    win = max(1, int(sr * win_ms / 1000))
    step = max(1, int(sr * step_ms / 1000))
    if len(wav) < win:
        starts = np.zeros(1, np.int64)
        rms = np.sqrt(np.mean(np.square(wav))) if len(wav) else 0.0
        return starts, np.asarray([20.0 * np.log10(max(rms, _EPS))])
    sq = np.concatenate([[0.0], np.cumsum(np.square(wav, dtype=np.float64))])
    starts = np.arange(0, len(wav) - win + 1, step, dtype=np.int64)
    mean_sq = (sq[starts + win] - sq[starts]) / win
    dbfs = 10.0 * np.log10(np.maximum(mean_sq, _EPS**2))
    return starts, dbfs


def detect_silence(
    wav: np.ndarray, sr: int, min_silence_len: int = 1000,
    silence_thresh: float = -50.0, seek_step: int = 10,
) -> list[tuple[int, int]]:
    """Silent ranges in samples (windows of ``min_silence_len`` ms below threshold)."""
    starts, dbfs = _window_dbfs(wav, sr, min_silence_len, seek_step)
    win = int(sr * min_silence_len / 1000)
    silent = dbfs < silence_thresh
    ranges: list[tuple[int, int]] = []
    for s, is_sil in zip(starts, silent):
        if not is_sil:
            continue
        end = int(s) + win
        if ranges and int(s) <= ranges[-1][1]:
            ranges[-1] = (ranges[-1][0], end)
        else:
            ranges.append((int(s), end))
    return ranges


def detect_nonsilent(
    wav: np.ndarray, sr: int, min_silence_len: int = 1000,
    silence_thresh: float = -50.0, seek_step: int = 10,
) -> list[tuple[int, int]]:
    silent = detect_silence(wav, sr, min_silence_len, silence_thresh, seek_step)
    out: list[tuple[int, int]] = []
    pos = 0
    for s, e in silent:
        if s > pos:
            out.append((pos, s))
        pos = max(pos, e)
    if pos < len(wav):
        out.append((pos, len(wav)))
    return out


def split_on_silence(
    wav: np.ndarray, sr: int, min_silence_len: int = 1000,
    silence_thresh: float = -50.0, keep_silence: int = 1000, seek_step: int = 10,
) -> list[np.ndarray]:
    """Non-silent chunks padded with up to ``keep_silence`` ms of surrounding silence."""
    keep = int(sr * keep_silence / 1000)
    chunks = []
    for s, e in detect_nonsilent(wav, sr, min_silence_len, silence_thresh, seek_step):
        chunks.append(wav[max(0, s - keep) : min(len(wav), e + keep)])
    return chunks


def detect_leading_silence(
    wav: np.ndarray, sr: int, silence_threshold: float = -42.0, chunk_ms: int = 10
) -> int:
    """Samples of leading silence (10 ms chunks below threshold, pydub semantics)."""
    chunk = max(1, int(sr * chunk_ms / 1000))
    pos = 0
    while pos + chunk <= len(wav):
        rms = np.sqrt(np.mean(np.square(wav[pos : pos + chunk], dtype=np.float64)))
        if 20.0 * np.log10(max(rms, _EPS)) > silence_threshold:
            break
        pos += chunk
    return pos


def remove_silence_edges(wav: np.ndarray, sr: int, silence_threshold: float = -42.0) -> np.ndarray:
    """Trim leading (10 ms chunks) and trailing (1 ms steps) silence
    (`utils_infer.py:273-286`)."""
    start = detect_leading_silence(wav, sr, silence_threshold)
    wav = wav[start:]
    ms = max(1, sr // 1000)
    end = len(wav)
    while end >= ms:
        rms = np.sqrt(np.mean(np.square(wav[end - ms : end], dtype=np.float64)))
        if 20.0 * np.log10(max(rms, _EPS)) > silence_threshold:
            break
        end -= ms
    return wav[:end]


def clip_reference_audio(wav: np.ndarray, sr: int, clip_short: bool = True) -> np.ndarray:
    """Reference-prompt clipping cascade (`utils_infer.py:297-328`):

    1. accumulate long-silence-split chunks until 6 s reached and the next chunk would
       exceed 12 s; 2. retry with short-silence splits if still > 12 s; 3. hard-clip to
       12 s; finally trim edges (-42 dBFS) and append 50 ms of silence.
    """
    def accumulate(chunks: list[np.ndarray]) -> np.ndarray:
        acc = np.zeros(0, dtype=np.float32)
        for chunk in chunks:
            if len(acc) > 6 * sr and len(acc) + len(chunk) > 12 * sr:
                break
            acc = np.concatenate([acc, chunk])
        return acc

    wav = np.asarray(wav, dtype=np.float32).reshape(-1)
    if clip_short:
        clipped = accumulate(split_on_silence(wav, sr, 1000, -50.0, 1000, 10))
        if len(clipped) > 12 * sr:
            clipped = accumulate(split_on_silence(wav, sr, 100, -40.0, 1000, 10))
        if len(clipped) > 12 * sr:
            clipped = clipped[: 12 * sr]
        wav = clipped
    wav = remove_silence_edges(wav, sr)
    return np.concatenate([wav, np.zeros(int(0.05 * sr), dtype=np.float32)])
