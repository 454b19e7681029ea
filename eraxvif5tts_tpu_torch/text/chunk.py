"""Sentence-aware text chunking with a UTF-8 byte budget.

Behavior parity with reference `src/f5_tts/infer/utils_infer.py:70-97` (`chunk_text`):
split on ASCII sentence punctuation followed by whitespace, or CJK/Vietnamese
full-width punctuation, then greedily pack sentences into chunks whose UTF-8 byte
length stays within ``max_chars``. A trailing single-byte sentence gets a joining
space appended before packing.
"""

from __future__ import annotations

import re

_SPLIT_RE = re.compile(r"(?<=[;:,.!?])\s+|(?<=[；：，。！？])")


def _hard_split(piece: str, max_chars: int) -> list[str]:
    """Split a single over-budget piece: at whitespace where possible, else at
    raw character boundaries (UTF-8 budget kept whole). The reference never
    needs this — dynamic shapes absorb an unbreakable 300-char token — but the
    static text buckets here require every chunk to fit, and erroring on
    pathological input would be worse than an extra chunk boundary."""
    out: list[str] = []
    current = ""
    for word in piece.split(" "):
        while len(word.encode("utf-8")) > max_chars:  # unbreakable overlong word
            if current:
                out.append(current.strip())
                current = ""
            take = len(word)
            while len(word[:take].encode("utf-8")) > max_chars:
                take -= 1
            out.append(word[:take])
            word = word[take:]
        joined = (current + " " + word).strip() if current else word
        if len(joined.encode("utf-8")) <= max_chars:
            current = joined
        else:
            out.append(current.strip())
            current = word
    if current.strip():
        out.append(current.strip())
    return out


def chunk_text(text: str, max_chars: int = 135, hard_max: int | None = None) -> list[str]:
    """Reference semantics by default: a single sentence longer than
    ``max_chars`` stays whole. ``hard_max`` (used by the wrapper with its text
    bucket budget) additionally hard-splits any such piece so every chunk fits
    a static shape."""
    chunks: list[str] = []
    current = ""
    for sentence in _SPLIT_RE.split(text):
        piece = sentence + " " if sentence and len(sentence[-1].encode("utf-8")) == 1 else sentence
        if len(current.encode("utf-8")) + len(sentence.encode("utf-8")) <= max_chars:
            current += piece
        else:
            if current:
                chunks.append(current.strip())
            current = piece
    if current:
        chunks.append(current.strip())
    if hard_max is None:
        return chunks
    return [part for c in chunks
            for part in (_hard_split(c, hard_max)
                         if len(c.encode("utf-8")) > hard_max else [c])]
