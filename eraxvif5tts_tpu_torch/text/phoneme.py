"""Vietnamese phonemization + phoneme-index mapping (the port's own copy of
`eraxvif5tts_tpu/text/phoneme.py`).

Parity with reference `src/f5_tts/model/alignment_utils.py:10-102`: prefers
``viphoneme`` (vi2IPA), then espeak ``phonemizer``, falling back to character-level
"phonemes" — the fallback keeps the whole duration/alignment pipeline functional in
dependency-free environments (this is also what the reference does when its optional
imports fail).

``phoneme_to_indices`` grows the map dynamically: index 0 is reserved for padding,
unseen phonemes get the next free index.
"""

from __future__ import annotations

try:  # optional
    from viphoneme import vi2IPA

    _HAS_VIPHONEME = True
except ImportError:  # pragma: no cover
    _HAS_VIPHONEME = False

try:  # optional
    from phonemizer import phonemize as _espeak_phonemize

    _HAS_ESPEAK = True
except ImportError:  # pragma: no cover
    _HAS_ESPEAK = False


def phonemize(text: str, language: str = "vi") -> list[str]:
    """Text -> phoneme token list."""
    if _HAS_VIPHONEME and language == "vi":
        ipa = vi2IPA(text)
        return [p for p in ipa.split() if p]
    if _HAS_ESPEAK:
        out = _espeak_phonemize(text, language=language, backend="espeak", strip=True)
        return [p for p in out.split() if p]
    # character fallback: each non-space character is one token
    return [c for c in text if not c.isspace()]


class PhonemeMap(dict):
    """Phoneme -> index map with an optional hard index ceiling.

    ``max_index`` bounds the ids a growing map may assign: the duration
    predictor's embedding table has a fixed ``vocab_size``, and an id past it
    has no row (`models/duration.py` gives it NaN, as the JAX package does),
    so growth past the table must raise — the same policy the wrapper applies
    to text embeddings."""

    def __init__(self, *args, max_index: int | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_index = max_index


def phoneme_to_indices(
    phonemes: list[str], phoneme_map: dict[str, int], grow: bool = True
) -> list[int]:
    """Phonemes -> int ids; 0 = pad. Grows the map for unseen phonemes when allowed.

    Raises when growth would exceed ``phoneme_map.max_index`` (set by the
    training CLIs to the predictor's embedding-table bound)."""
    limit = getattr(phoneme_map, "max_index", None)
    ids = []
    for p in phonemes:
        if p not in phoneme_map:
            if not grow:
                continue
            new_idx = len(phoneme_map) + 1  # 0 reserved for padding
            if limit is not None and new_idx > limit:
                raise ValueError(
                    f"phoneme map needs index {new_idx} for {p!r} but the "
                    f"duration predictor's embedding table only holds ids "
                    f"<= {limit} — the corpus has more distinct phonemes than "
                    f"the predictor vocab; rebuild it with a larger vocab_size"
                )
            phoneme_map[p] = new_idx
        ids.append(phoneme_map[p])
    return ids


def text_to_phoneme_indices(
    text: str, phoneme_map: dict[str, int], language: str = "vi", grow: bool = False
) -> list[int]:
    return phoneme_to_indices(phonemize(text, language), phoneme_map, grow=grow)
