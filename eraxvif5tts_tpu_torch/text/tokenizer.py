"""Character vocabulary tokenizer.

Behavior parity with reference `src/f5_tts/model/utils.py:118-241` (`get_tokenizer`):
- one token per line of ``vocab.txt``;
- a first line consisting of exactly one space is kept as the space token (lines are
  stripped of line endings first, then whitespace-stripped except for that case);
- duplicate tokens keep their first index;
- returned map is ``{token: index}`` with indices assigned in order of first
  appearance.

And with `utils.py:81-95`:
- ``list_str_to_idx``: per-character lookup (unknown -> 0), right-padded with -1;
- ``list_str_to_bytes``: UTF-8 byte ids (ByT5 style), right-padded with -1.
"""

from __future__ import annotations

import os

import numpy as np


def read_vocab(vocab_file_path: str) -> dict[str, int]:
    vocab_char_map: dict[str, int] = {}
    with open(vocab_file_path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            content = line.rstrip("\n\r")
            # Preserve a leading single-space line as the literal space token.
            token = content if (i == 0 and content == " ") else content.strip()
            if token not in vocab_char_map:
                vocab_char_map[token] = len(vocab_char_map)
    if not vocab_char_map:
        raise ValueError(f"vocabulary file {vocab_file_path!r} produced zero tokens")
    return vocab_char_map


def get_tokenizer(
    path_or_dataset_name: str,
    tokenizer_type: str = "custom",
    base_data_path: str = "./data",
) -> tuple[dict[str, int], int]:
    """Resolve and read a vocab file; returns ``(char_map, vocab_size)``.

    ``tokenizer_type="custom"`` expects a direct path to ``vocab.txt`` (or a directory
    containing one); ``"pinyin"``/``"char"`` resolve
    ``{base}/{name}_{type}/vocab.txt`` with a ``{base}/{name}/vocab.txt`` fallback.
    """
    if tokenizer_type == "custom":
        if os.path.isfile(path_or_dataset_name):
            vocab_path = path_or_dataset_name
        elif os.path.isdir(path_or_dataset_name) and os.path.isfile(
            os.path.join(path_or_dataset_name, "vocab.txt")
        ):
            vocab_path = os.path.join(path_or_dataset_name, "vocab.txt")
        else:
            raise FileNotFoundError(
                f"custom tokenizer: {path_or_dataset_name!r} is not a vocab file/dir"
            )
    elif tokenizer_type in ("pinyin", "char"):
        vocab_path = os.path.join(
            base_data_path, f"{path_or_dataset_name}_{tokenizer_type}", "vocab.txt"
        )
        if not os.path.isfile(vocab_path):
            fallback = os.path.join(base_data_path, path_or_dataset_name, "vocab.txt")
            if os.path.isfile(fallback):
                vocab_path = fallback
            else:
                raise FileNotFoundError(
                    f"vocab not found for dataset {path_or_dataset_name!r} "
                    f"(tried {vocab_path!r} and {fallback!r})"
                )
    else:
        raise ValueError(f"unknown tokenizer type: {tokenizer_type!r}")

    char_map = read_vocab(vocab_path)
    return char_map, len(char_map)


def _pad_token_lists(token_lists: list[list[int]], padding_value: int, pad_to: int | None) -> np.ndarray:
    max_len = max((len(t) for t in token_lists), default=0)
    if pad_to is not None:
        if max_len > pad_to:
            raise ValueError(f"text length {max_len} exceeds pad_to={pad_to}")
        max_len = pad_to
    out = np.full((len(token_lists), max_len), padding_value, dtype=np.int32)
    for i, toks in enumerate(token_lists):
        out[i, : len(toks)] = toks
    return out


def list_str_to_idx(
    text: list[str] | list[list[str]],
    vocab_char_map: dict[str, int],
    padding_value: int = -1,
    pad_to: int | None = None,
) -> np.ndarray:
    """Tokenize a batch of strings (or pre-split token lists) -> int32 ``[b, nt]``.

    Unknown characters map to 0; right-padding is -1 (the model shifts ids by +1 and
    treats 0 as the filler token, reference `backbones/dit.py:50`). ``pad_to`` forces a
    static width for the text buckets.
    """
    ids = [[vocab_char_map.get(c, 0) for c in t] for t in text]
    return _pad_token_lists(ids, padding_value, pad_to)


def list_str_to_bytes(
    text: list[str], padding_value: int = -1, pad_to: int | None = None
) -> np.ndarray:
    """UTF-8 byte tokenizer (used when no vocab map is given, `utils.py:81-84`)."""
    ids = [list(bytes(t, "utf-8")) for t in text]
    return _pad_token_lists(ids, padding_value, pad_to)
