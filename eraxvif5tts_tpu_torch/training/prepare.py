"""Dataset preparation: metadata.csv + wavs -> (raw.arrow, duration.json, vocab.txt)
(the port's own copy of `eraxvif5tts_tpu/training/prepare.py`; host code).

Parity with reference `src/f5_tts/train/datasets/prepare_csv_wavs.py` /
`prepare_ljspeech.py:14-50`: the same triple-file output layout consumed by
``load_dataset``; pinyin conversion for zh text; duration probing from the wav
headers (no ffprobe dependency); `prepare_emilia.py`'s repetition filter.
"""

from __future__ import annotations

import csv
import json
import os
import wave as wave_mod
from collections import defaultdict
from typing import Iterable, Optional

from eraxvif5tts_tpu_torch.text.pinyin import convert_char_to_pinyin


def repetition_found(text: str, length: int = 2, tolerance: int = 10) -> bool:
    """Dirty-data filter (reference `model/utils.py:290-298`)."""
    pattern_count: dict[str, int] = defaultdict(int)
    for i in range(len(text) - length + 1):
        pattern_count[text[i : i + length]] += 1
    return any(count > tolerance for count in pattern_count.values())


def wav_duration_seconds(path: str) -> float:
    with wave_mod.open(path, "rb") as f:
        return f.getnframes() / f.getframerate()


def build_vocab(texts: Iterable[list[str] | str]) -> list[str]:
    """Sorted unique token list; space goes first (reference vocab layout)."""
    tokens: set[str] = set()
    for t in texts:
        tokens.update(t)
    tokens.discard(" ")
    return [" "] + sorted(tokens)


def prepare_csv_wavs(
    input_dir: str,
    output_dir: str,
    pretrained_vocab: Optional[str] = None,
    use_pinyin: bool = True,
    min_seconds: float = 0.3,
    max_seconds: float = 30.0,
    filter_repetitions: bool = False,
) -> dict:
    """``{input_dir}/metadata.csv`` (`path|text`) + wavs -> arrow/duration/vocab.

    Returns a summary dict. Output layout matches reference
    `prepare_csv_wavs.py` so `load_dataset` (and the reference trainer) can read it.
    """
    import datasets as hf_datasets

    meta_path = os.path.join(input_dir, "metadata.csv")
    rows = []
    durations = []
    texts_for_vocab = []
    skipped = 0
    with open(meta_path, "r", encoding="utf-8-sig", newline="") as f:
        reader = csv.reader(f, delimiter="|")
        for parts in reader:
            if len(parts) < 2:
                continue
            rel_path, text = parts[0].strip(), parts[1].strip()
            audio_path = rel_path if os.path.isabs(rel_path) else os.path.join(input_dir, rel_path)
            if not os.path.isfile(audio_path):
                skipped += 1
                continue
            try:
                dur = wav_duration_seconds(audio_path)
            except Exception:
                skipped += 1
                continue
            if not (min_seconds <= dur <= max_seconds):
                skipped += 1
                continue
            if filter_repetitions and repetition_found(text):
                skipped += 1
                continue
            tokens = convert_char_to_pinyin([text])[0] if use_pinyin else list(text)
            rows.append({"audio_path": audio_path, "text": text, "duration": dur})
            durations.append(dur)
            texts_for_vocab.append(tokens)

    os.makedirs(output_dir, exist_ok=True)
    ds = hf_datasets.Dataset.from_list(rows)
    ds.save_to_disk(os.path.join(output_dir, "raw"))
    # also write the single-file arrow layout the reference uses
    arrow_path = os.path.join(output_dir, "raw.arrow")
    try:
        from datasets.arrow_writer import ArrowWriter

        writer = ArrowWriter(path=arrow_path)
        for row in rows:
            writer.write(row)
        writer.finalize()
    except Exception:
        if os.path.exists(arrow_path):
            os.remove(arrow_path)

    with open(os.path.join(output_dir, "duration.json"), "w", encoding="utf-8") as f:
        json.dump({"duration": durations}, f)

    if pretrained_vocab and os.path.isfile(pretrained_vocab):
        with open(pretrained_vocab, "r", encoding="utf-8") as f:
            vocab_lines = f.read().splitlines()
    else:
        vocab_lines = build_vocab(texts_for_vocab)
    with open(os.path.join(output_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab_lines) + "\n")

    return {"samples": len(rows), "skipped": skipped,
            "total_hours": sum(durations) / 3600.0, "vocab_size": len(vocab_lines)}


def prepare_phonemes(
    metadata_path: str,
    output_path: str,
    language: str = "vi",
    normalize_fn=None,
    shuffle: bool = False,
    seed: int = 0,
) -> dict:
    """metadata.csv (``audio|...|text`` lines) -> phoneme jsonl for duration training.

    Parity with reference `src/f5_tts/model/preprocess_phoneme.py`: the text is
    the last ``|`` field, normalized (vinorm ``TTSnorm`` when available — pass
    ``normalize_fn`` to override or inject), phonemized, and written as one
    ``{"text", "phonemes", "audio"}`` jsonl line per sample. The reference's
    tail-token fixups are kept: drop an empty trailing token, drop a bare
    trailing ``"."``, collapse a trailing ``".."`` to ``"."``; samples with
    fewer than 2 phonemes (or any per-line failure) are skipped, not fatal.
    """
    from eraxvif5tts_tpu_torch.text.phoneme import phonemize

    if normalize_fn is None:
        try:  # optional Vietnamese text normalizer (reference uses vinorm)
            from vinorm import TTSnorm as normalize_fn  # type: ignore
        except ImportError:
            normalize_fn = lambda s: s  # noqa: E731

    with open(metadata_path, "r", encoding="utf-8") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if shuffle:
        import random as _rnd

        _rnd.Random(seed).shuffle(lines)

    written, skipped = 0, 0
    with open(output_path, "w", encoding="utf-8") as out:
        for line in lines:
            try:
                content = normalize_fn(line.split("|")[-1].strip())
                phoneme = phonemize(str(content), language=language)
                if phoneme and phoneme[-1] == "":
                    phoneme = phoneme[:-1]
                if phoneme and phoneme[-1] == ".":
                    phoneme = phoneme[:-1]
                elif phoneme and phoneme[-1] == "..":
                    phoneme[-1] = "."
                if len(phoneme) < 2:
                    skipped += 1
                    continue
                out.write(json.dumps({
                    "text": content,
                    "phonemes": phoneme,
                    "audio": line.split("|")[0],
                }, ensure_ascii=False) + "\n")
                written += 1
            except Exception:
                skipped += 1
    return {"written": written, "skipped": skipped, "output": output_path}


def prepare_ljspeech(ljspeech_dir: str, output_dir: str, **kw) -> dict:
    """LJSpeech layout (metadata.csv with `id|text|normalized`) -> same outputs
    (reference `prepare_ljspeech.py:14-50`)."""
    meta = os.path.join(ljspeech_dir, "metadata.csv")
    staged = os.path.join(output_dir, "_lj_metadata.csv")
    os.makedirs(output_dir, exist_ok=True)
    with open(meta, "r", encoding="utf-8") as f, open(staged, "w", encoding="utf-8") as out:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) >= 3:
                wav = os.path.join(ljspeech_dir, "wavs", parts[0] + ".wav")
                out.write(f"{wav}|{parts[2]}\n")
    stage_dir = os.path.dirname(staged)
    os.replace(staged, os.path.join(stage_dir, "metadata.csv"))
    return prepare_csv_wavs(stage_dir, output_dir, use_pinyin=False, **kw)


def main(argv=None) -> dict:
    """The ``eraxvif5tts-torch-prepare`` command: one subcommand per layout;
    prints and returns the summary."""
    import argparse

    ap = argparse.ArgumentParser(prog="eraxvif5tts-torch-prepare")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("csv_wavs", help="metadata.csv + wavs -> arrow/duration/vocab")
    p1.add_argument("input_dir")
    p1.add_argument("output_dir")
    p1.add_argument("--pretrained-vocab")
    p1.add_argument("--no-pinyin", action="store_true")
    p2 = sub.add_parser("ljspeech", help="LJSpeech layout -> arrow/duration/vocab")
    p2.add_argument("ljspeech_dir")
    p2.add_argument("output_dir")
    p3 = sub.add_parser("phonemes",
                        help="metadata.csv -> phoneme jsonl (duration training)")
    p3.add_argument("metadata")
    p3.add_argument("output")
    p3.add_argument("--language", default="vi")
    p3.add_argument("--shuffle", action="store_true")
    # public-corpus preparers (reference `train/datasets/prepare_{emilia,
    # libritts,wenetspeech4tts}.py`) share the size/filter flags
    corpora = ("emilia", "libritts", "wenetspeech4tts")
    for name, default_subsets in (
        ("emilia", "ZH,EN"),
        ("libritts", "train-clean-100,train-clean-360,train-other-500"),
        ("wenetspeech4tts", "Premium"),
    ):
        pc = sub.add_parser(name, help=f"{name} layout -> arrow/duration/vocab")
        pc.add_argument("dataset_dir")
        pc.add_argument("output_dir")
        pc.add_argument("--subsets", default=default_subsets,
                        help="comma-separated"
                        + (" language dirs" if name == "emilia" else " subsets"))
        pc.add_argument("--min-seconds", type=float, default=0.4)
        pc.add_argument("--max-seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    if args.cmd == "csv_wavs":
        summary = prepare_csv_wavs(args.input_dir, args.output_dir,
                                   pretrained_vocab=args.pretrained_vocab,
                                   use_pinyin=not args.no_pinyin)
    elif args.cmd == "ljspeech":
        summary = prepare_ljspeech(args.ljspeech_dir, args.output_dir)
    elif args.cmd in corpora:
        from eraxvif5tts_tpu_torch.training import prepare_corpora

        fn = getattr(prepare_corpora, f"prepare_{args.cmd}")
        subsets = tuple(s.strip() for s in args.subsets.split(",") if s.strip())
        kw = {"languages" if args.cmd == "emilia" else "subsets": subsets}
        summary = fn(args.dataset_dir, args.output_dir,
                     min_seconds=args.min_seconds, max_seconds=args.max_seconds, **kw)
    else:
        summary = prepare_phonemes(args.metadata, args.output,
                                   language=args.language, shuffle=args.shuffle)
    print(summary)
    return summary


if __name__ == "__main__":
    main()
