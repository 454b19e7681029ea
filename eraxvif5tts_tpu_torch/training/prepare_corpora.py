"""Corpus-specific dataset preparation (reference `src/f5_tts/train/datasets/
prepare_{emilia,libritts,wenetspeech4tts}.py`; the port's own copy of
`eraxvif5tts_tpu/training/prepare_corpora.py`).

All three emit the same triple-file layout consumed by ``load_dataset``:
``raw.arrow`` (or ``raw/`` HF dataset) + ``duration.json`` + ``vocab.txt``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Iterable

from eraxvif5tts_tpu_torch.training.prepare import build_vocab, repetition_found, wav_duration_seconds

# Emilia character filters (non-target-script characters observed in dirty rows;
# reference `prepare_emilia.py:34,110`).
EMILIA_ZH_FILTERS = ["い", "て"]
EMILIA_EN_FILTERS = ["ا", "い", "て"]


def _write_outputs(rows: list[dict], durations: list[float], vocab: Iterable[str],
                   save_dir: str) -> dict:
    import datasets as hf_datasets

    os.makedirs(save_dir, exist_ok=True)
    ds = hf_datasets.Dataset.from_list(rows)
    ds.save_to_disk(os.path.join(save_dir, "raw"))
    try:
        from datasets.arrow_writer import ArrowWriter

        writer = ArrowWriter(path=os.path.join(save_dir, "raw.arrow"))
        for row in rows:
            writer.write(row)
        writer.finalize()
    except Exception:
        pass
    with open(os.path.join(save_dir, "duration.json"), "w", encoding="utf-8") as f:
        json.dump({"duration": durations}, f)
    vocab_lines = list(vocab)
    with open(os.path.join(save_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab_lines) + "\n")
    return {"samples": len(rows), "total_hours": sum(durations) / 3600.0,
            "vocab_size": len(vocab_lines)}


def prepare_libritts(dataset_dir: str, save_dir: str,
                     subsets: tuple[str, ...] = ("train-clean-100", "train-clean-360",
                                                 "train-other-500"),
                     min_seconds: float = 0.4, max_seconds: float = 30.0) -> dict:
    """LibriTTS layout: ``{subset}/{speaker}/{chapter}/*.wav`` with sibling
    ``.normalized.txt`` transcripts (reference `prepare_libritts.py:15-29`)."""
    rows, durations = [], []
    vocab_set: set[str] = set()
    for subset in subsets:
        base = Path(dataset_dir) / subset
        if not base.is_dir():
            print(f"WARNING: subset dir not found, skipping: {base}")
            continue
        for wav in base.rglob("*.wav"):
            text_path = wav.with_suffix(".normalized.txt")
            if not text_path.is_file():
                continue
            text = text_path.read_text(encoding="utf-8").strip()
            try:
                duration = wav_duration_seconds(str(wav))
            except Exception:
                continue
            if not (min_seconds <= duration <= max_seconds):
                continue
            rows.append({"audio_path": str(wav), "text": text, "duration": duration})
            durations.append(duration)
            vocab_set.update(text)
    return _write_outputs(rows, durations, build_vocab(vocab_set), save_dir)


def prepare_emilia(dataset_dir: str, save_dir: str, languages: tuple[str, ...] = ("ZH", "EN"),
                   min_seconds: float = 0.4, max_seconds: float = 30.0) -> dict:
    """Emilia layout: per-language dirs with sibling ``.jsonl`` metadata; applies the
    script filters + ``repetition_found`` (reference `prepare_emilia.py:114-140`)."""
    from eraxvif5tts_tpu_torch.text.pinyin import convert_char_to_pinyin

    rows, durations = [], []
    vocab_set: set[str] = set()
    for lang in languages:
        base = Path(dataset_dir) / lang
        if not base.is_dir():
            print(f"WARNING: language dir not found, skipping: {base}")
            continue
        filters = EMILIA_ZH_FILTERS if lang == "ZH" else EMILIA_EN_FILTERS
        for jsonl in sorted(base.glob("*.jsonl")):
            with open(jsonl, "r", encoding="utf-8") as f:
                for line in f:
                    try:
                        obj = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    text = obj.get("text", "")
                    duration = float(obj.get("duration", 0.0))
                    if not (min_seconds <= duration <= max_seconds):
                        continue
                    if any(ch in text for ch in filters):
                        continue
                    if lang == "ZH" and repetition_found(text):
                        continue
                    if lang == "EN" and repetition_found(text, length=4):
                        continue
                    wav = obj.get("wav", "")
                    audio_path = wav if os.path.isabs(wav) else str(base / wav)
                    if lang == "ZH":
                        tokens = convert_char_to_pinyin([text])[0]
                        vocab_set.update(tokens)
                    else:
                        vocab_set.update(text)
                    rows.append({"audio_path": audio_path, "text": text,
                                 "duration": duration})
                    durations.append(duration)
    return _write_outputs(rows, durations, build_vocab(vocab_set), save_dir)


def prepare_wenetspeech4tts(dataset_dir: str, save_dir: str,
                            subsets: tuple[str, ...] = ("Premium",),
                            min_seconds: float = 0.4, max_seconds: float = 30.0) -> dict:
    """WenetSpeech4TTS layout: ``{subset}/wavs/*.wav`` + per-utterance ``.txt``
    transcript lists (reference `prepare_wenetspeech4tts.py`)."""
    from eraxvif5tts_tpu_torch.text.pinyin import convert_char_to_pinyin

    rows, durations = [], []
    vocab_set: set[str] = set()
    for subset in subsets:
        base = Path(dataset_dir) / subset
        if not base.is_dir():
            print(f"WARNING: subset dir not found, skipping: {base}")
            continue
        for wav in base.rglob("*.wav"):
            txt = wav.with_suffix(".txt")
            if not txt.is_file():
                continue
            text = txt.read_text(encoding="utf-8").strip().split("\t")[-1]
            try:
                duration = wav_duration_seconds(str(wav))
            except Exception:
                continue
            if not (min_seconds <= duration <= max_seconds):
                continue
            tokens = convert_char_to_pinyin([text])[0]
            vocab_set.update(tokens)
            rows.append({"audio_path": str(wav), "text": text, "duration": duration})
            durations.append(duration)
    return _write_outputs(rows, durations, build_vocab(vocab_set), save_dir)
