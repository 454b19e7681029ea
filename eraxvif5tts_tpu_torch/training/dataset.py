"""Data pipeline: frame-budget batching into bucketed shapes (the port's
own copy of `eraxvif5tts_tpu/training/dataset.py`; numpy, no torch).

Parity targets (reference `src/f5_tts/model/dataset.py`):
- ``CustomDataset`` rows ``{audio_path | mel, text, duration, phoneme}`` backed by an
  HF-datasets arrow file + ``duration.json`` (`dataset.py:82-165, 245-305`).
- ``DynamicBatchSampler`` (`dataset.py:168-239`): sort samples by frame length,
  greedily pack batches up to ``frames_threshold`` frames and ``max_samples``
  sequences, drop residual if requested, epoch-seeded shuffle of *batches*.
- ``collate_fn`` (`dataset.py:308-333`): pad mels to the batch max, return text ids,
  lengths, phonemes.

As in the JAX package, ``collate`` pads the frame axis up to a *bucket*
width (the next bucket >= batch max), so every batch shape comes from a
small set: the two packages give the same batches, array for array. HF
``datasets`` is imported by :func:`load_dataset` alone (the machine with
the card may lack it: build a :class:`CustomDataset` from rows there).
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from eraxvif5tts_tpu_torch.text.tokenizer import list_str_to_idx

TRAIN_FRAME_BUCKETS = (256, 512, 1024, 2048, 4096)
TRAIN_TEXT_BUCKETS = (64, 128, 256, 512, 1024)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class Sample:
    text: str | list[str]
    duration_frames: int
    mel: Optional[np.ndarray] = None  # [n, n_mels] precomputed
    audio_path: Optional[str] = None
    phoneme: Optional[str] = None


def numpy_log_mel(wav: np.ndarray, sample_rate: int = 24000, n_fft: int = 1024,
                  hop_length: int = 256, win_length: int = 1024,
                  n_mel_channels: int = 100,
                  mel_spec_type: str = "vocos") -> np.ndarray:
    """Host-side log-mel, numerically matching ``ops/stft.MelSpectrogram``
    (reference ``MelSpec``, `modules.py:104-143`). Returns ``[n_frames, n_mels]``.

    numpy on purpose: the data-loading path computes mels per sample at ragged
    lengths, on the host, while the card runs the previous update."""
    from eraxvif5tts_tpu_torch.ops.mel import hann_window, mel_filterbank

    wav = np.asarray(wav, np.float64).reshape(-1)
    win = hann_window(win_length).astype(np.float64)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        win = np.pad(win, (pad, n_fft - win_length - pad))
    if mel_spec_type == "vocos":
        pad = n_fft // 2
        eps = 0.0
        variant = "htk"
    elif mel_spec_type == "bigvgan":
        pad = (n_fft - hop_length) // 2
        eps = 1e-9
        variant = "slaney"
    else:
        raise ValueError(f"unknown mel_spec_type: {mel_spec_type!r}")
    wav = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(wav) - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = wav[idx] * win[None, :]
    spec = np.fft.rfft(frames, axis=-1)
    mag = np.sqrt(spec.real ** 2 + spec.imag ** 2 + eps)  # [n_frames, bins]
    fb = mel_filterbank(sample_rate, n_fft, n_mel_channels, variant=variant)
    mel = mag @ fb.T  # [n_frames, n_mels]
    return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)


class CustomDataset:
    """Arrow/HF-datasets-backed dataset. Mels come from (in priority order)
    precomputed ``mel_spec`` rows, a custom ``mel_loader``, or on-the-fly
    computation from ``audio_path`` (the reference computes them on the fly
    too, `dataset.py:82-165`)."""

    def __init__(
        self,
        rows,  # HF dataset / list of dicts with text/duration (+ mel_spec | audio_path)
        durations: Optional[list[float]] = None,
        hop_length: int = 256,
        target_sample_rate: int = 24000,
        preprocessed_mel: bool = False,
        mel_loader: Optional[Callable[[dict], np.ndarray]] = None,
        mel_spec_kwargs: Optional[dict] = None,
    ):
        self.rows = rows
        self.hop_length = hop_length
        self.target_sample_rate = target_sample_rate
        self.preprocessed_mel = preprocessed_mel
        self.mel_loader = mel_loader
        self.mel_spec_kwargs = mel_spec_kwargs or {}
        if durations is not None:
            self.durations = list(durations)
        else:
            self.durations = [float(r["duration"]) for r in rows]

    def __len__(self) -> int:
        return len(self.rows)

    def frame_length(self, idx: int) -> int:
        return int(self.durations[idx] * self.target_sample_rate / self.hop_length)

    def _mel_from_audio(self, path: str) -> Optional[np.ndarray]:
        from eraxvif5tts_tpu_torch.audio.io import read_wav
        from eraxvif5tts_tpu_torch.audio.resample import resample

        if not path or not os.path.isfile(path):
            return None
        wav, sr = read_wav(path)
        wav = wav.mean(axis=0)
        if sr != self.target_sample_rate:
            wav = resample(wav, sr, self.target_sample_rate)
        ms = self.mel_spec_kwargs
        return numpy_log_mel(
            wav, sample_rate=self.target_sample_rate,
            n_fft=ms.get("n_fft", 1024), hop_length=self.hop_length,
            win_length=ms.get("win_length", 1024),
            n_mel_channels=ms.get("n_mel_channels", 100),
            mel_spec_type=ms.get("mel_spec_type", "vocos"),
        )

    def __getitem__(self, idx: int) -> Sample:
        row = self.rows[idx]
        mel = None
        if self.preprocessed_mel and "mel_spec" in row:
            mel = np.asarray(row["mel_spec"], dtype=np.float32)
            if mel.shape[0] != self.frame_length(idx) and mel.shape[0] < mel.shape[-1]:
                mel = mel.T  # stored [n_mels, n] -> [n, n_mels]
        elif self.mel_loader is not None:
            mel = self.mel_loader(row)
        elif row.get("audio_path"):
            mel = self._mel_from_audio(row["audio_path"])
        return Sample(
            text=row["text"],
            duration_frames=self.frame_length(idx),
            mel=mel,
            audio_path=row.get("audio_path"),
            phoneme=row.get("phoneme"),
        )


class HFDataset:
    """On-the-fly mel extraction from HF audio rows, 0.3-30 s filter
    (reference `dataset.py:17-79`)."""

    def __init__(
        self,
        hf_dataset,
        mel_fn: Callable[[np.ndarray, int], np.ndarray],  # (wav, sr) -> mel [n, d]
        target_sample_rate: int = 24000,
        hop_length: int = 256,
        min_seconds: float = 0.3,
        max_seconds: float = 30.0,
    ):
        self.data = hf_dataset
        self.mel_fn = mel_fn
        self.target_sample_rate = target_sample_rate
        self.hop_length = hop_length
        self.min_seconds = min_seconds
        self.max_seconds = max_seconds

    def __len__(self) -> int:
        return len(self.data)

    def frame_length(self, idx: int) -> int:
        row = self.data[idx]
        audio = row["audio"]
        dur = len(audio["array"]) / audio["sampling_rate"]
        return int(dur * self.target_sample_rate / self.hop_length)

    def __getitem__(self, idx: int) -> Sample:
        row = self.data[idx]
        audio = row["audio"]
        wav = np.asarray(audio["array"], dtype=np.float32)
        sr = audio["sampling_rate"]
        dur = len(wav) / sr
        if not (self.min_seconds <= dur <= self.max_seconds):
            # out-of-range rows loop to a neighbor (reference filters at access time)
            return self[(idx + 1) % len(self)]
        mel = self.mel_fn(wav, sr)
        return Sample(text=row["text"], duration_frames=mel.shape[0], mel=mel)


def load_dataset(
    dataset_name: str,
    tokenizer: str = "pinyin",
    dataset_type: str = "CustomDataset",
    data_dir: str = "./data",
    mel_spec_kwargs: dict | None = None,
) -> CustomDataset:
    """Load ``{data_dir}/{name}_{tokenizer}/raw.arrow`` + ``duration.json``
    (reference `dataset.py:245-305`)."""
    import datasets as hf_datasets

    base = os.path.join(data_dir, f"{dataset_name}_{tokenizer}")
    if not os.path.isdir(base):
        base = os.path.join(data_dir, dataset_name)
    arrow = os.path.join(base, "raw.arrow")
    if os.path.isfile(arrow):
        rows = hf_datasets.Dataset.from_file(arrow)
    else:
        rows = hf_datasets.load_from_disk(os.path.join(base, "raw"))
    dur_file = os.path.join(base, "duration.json")
    durations = None
    if os.path.isfile(dur_file):
        with open(dur_file, "r", encoding="utf-8") as f:
            durations = json.load(f)["duration"]
    kwargs = mel_spec_kwargs or {}
    return CustomDataset(
        rows,
        durations=durations,
        hop_length=kwargs.get("hop_length", 256),
        target_sample_rate=kwargs.get("target_sample_rate", 24000),
        mel_spec_kwargs=kwargs,
    )


class DynamicBatchSampler:
    """Frame-budget batch packer (`dataset.py:168-239`).

    Sorts sample indices by frame length, packs batches up to ``frames_threshold``
    total frames (and ``max_samples`` sequences), then shuffles the *batches* with an
    epoch-seeded RNG so every epoch sees a new batch order while keeping
    length-homogeneous packing (minimal padding per batch).
    """

    def __init__(
        self,
        frame_lengths: Sequence[int],
        frames_threshold: int,
        max_samples: int = 0,
        random_seed: Optional[int] = None,
        drop_residual: bool = False,
    ):
        self.frames_threshold = frames_threshold
        self.max_samples = max_samples
        self.random_seed = random_seed
        indices = sorted(range(len(frame_lengths)), key=lambda i: frame_lengths[i])

        self.batches: list[list[int]] = []
        batch: list[int] = []
        batch_frames = 0
        for idx in indices:
            frames = frame_lengths[idx]
            if batch_frames + frames <= frames_threshold and (
                max_samples == 0 or len(batch) < max_samples
            ):
                batch.append(idx)
                batch_frames += frames
            else:
                if batch:
                    self.batches.append(batch)
                if frames <= frames_threshold:
                    batch = [idx]
                    batch_frames = frames
                else:  # single over-budget sample gets its own batch
                    self.batches.append([idx])
                    batch = []
                    batch_frames = 0
        if batch and not drop_residual:
            self.batches.append(batch)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self) -> Iterator[list[int]]:
        order = list(range(len(self.batches)))
        if self.random_seed is not None:
            random.Random(self.random_seed + self.epoch).shuffle(order)
        for i in order:
            yield self.batches[i]


def sample_phonemes(s: Sample) -> list[str]:
    """A sample's phoneme tokens: its phoneme column, else its text
    phonemized (the reference warns and falls back to text tokens,
    `trainer.py:857-864`)."""
    from eraxvif5tts_tpu_torch.text.phoneme import phonemize

    if s.phoneme:
        return list(s.phoneme.split() if isinstance(s.phoneme, str) else s.phoneme)
    return phonemize(s.text if isinstance(s.text, str) else "".join(map(str, s.text)))


def collate(
    samples: list[Sample],
    vocab_char_map: dict[str, int],
    frame_buckets: Sequence[int] = TRAIN_FRAME_BUCKETS,
    text_buckets: Sequence[int] = TRAIN_TEXT_BUCKETS,
    tokenize: Optional[Callable[[str | list[str]], list[str]]] = None,
    pad_batch_to: Optional[int] = None,
    phoneme_map: Optional[dict[str, int]] = None,
) -> dict[str, np.ndarray]:
    """Pad a batch to bucketed static shapes -> {'mel', 'text', 'lens'} numpy arrays
    (+ 'phoneme' ids when ``phoneme_map`` is given and samples carry phonemes).

    ``pad_batch_to`` optionally pads the batch axis (repeating the last sample with
    lens=0 weighting left to the loss mask) so the batch size is also static.
    """
    assert all(s.mel is not None for s in samples), "collate needs materialized mels"
    n_mels = samples[0].mel.shape[-1]
    max_frames = max(s.mel.shape[0] for s in samples)
    width = _bucket(max_frames, frame_buckets)

    token_lists = []
    for s in samples:
        toks = tokenize(s.text) if tokenize else (
            list(s.text) if isinstance(s.text, str) else s.text
        )
        token_lists.append(toks)
    max_text = max((len(t) for t in token_lists), default=1)
    text_width = _bucket(max_text, text_buckets)

    b = len(samples)
    rows = b if pad_batch_to is None else max(pad_batch_to, b)
    mel = np.zeros((rows, width, n_mels), np.float32)
    lens = np.zeros((rows,), np.int32)
    for i, s in enumerate(samples):
        n = min(s.mel.shape[0], width)
        mel[i, :n] = s.mel[:n]
        lens[i] = n
    text = np.full((rows, text_width), -1, np.int32)
    ids = list_str_to_idx(token_lists, vocab_char_map, pad_to=text_width)
    text[:b, :] = ids

    out = {"mel": mel, "text": text, "lens": lens}
    if phoneme_map is not None:
        from eraxvif5tts_tpu_torch.text.phoneme import phoneme_to_indices

        ph_lists = [phoneme_to_indices(sample_phonemes(s), phoneme_map, grow=True)
                    for s in samples]
        ph_width = _bucket(max((len(p) for p in ph_lists), default=1), text_buckets)
        phoneme = np.zeros((rows, ph_width), np.int32)
        for i, ids_ in enumerate(ph_lists):
            phoneme[i, : min(len(ids_), ph_width)] = ids_[:ph_width]
        out["phoneme"] = phoneme
    return out


def prefetch_batches(gen, depth: int = 2):
    """Overlap host batch prep (mel FFT + collate) with device compute.

    A daemon producer thread runs ``gen`` ahead of the consumer through a
    bounded queue, the counterpart of the reference DataLoader's
    ``num_workers`` overlap (`trainer.py:1137-1170`): while the card runs
    update N, the producer builds batch N+1. ``depth`` bounds host memory
    (batches are tens of MB at the reference frame budget).

    Exceptions in the producer re-raise in the consumer; abandoning the
    iterator early (mid-epoch interrupt) unblocks and stops the producer.
    """
    import queue as _queue
    import threading

    q: _queue.Queue = _queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()

    def _put(item) -> bool:
        """Stop-aware bounded put; False when the consumer abandoned us."""
        while True:
            try:
                q.put(item, timeout=0.2)
                return True
            except _queue.Full:
                if stop.is_set():
                    return False

    def _run():
        try:
            for item in gen:
                if not _put(item):
                    return
            _put(_END)
        except BaseException as e:  # noqa: BLE001 — propagate to consumer
            _put(e)

    t = threading.Thread(target=_run, daemon=True, name="batch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
