"""Chinese -> pinyin conversion for mixed-language text.

Behavior parity with reference `src/f5_tts/model/utils.py:243-284`
(`convert_char_to_pinyin`): jieba-segment the text; pure-ASCII segments pass through
as characters (with a joining space inserted between word segments); pure-CJK segments
become TONE3 pinyin tokens each preceded by a space; mixed segments are handled
per-character. ``pypinyin`` is optional — without it CJK characters pass through as
themselves (the Vietnamese serving path never needs pinyin).
"""

from __future__ import annotations

_CUSTOM_TRANS = str.maketrans({";": ",", "“": '"', "”": '"', "‘": "'", "’": "'"})

try:  # optional dependency
    from pypinyin import Style, lazy_pinyin

    def _to_pinyin(seg: str) -> list[str]:
        return lazy_pinyin(seg, style=Style.TONE3, tone_sandhi=True)

    _HAS_PYPINYIN = True
except ImportError:  # pragma: no cover - environment without pypinyin
    def _to_pinyin(seg: str) -> list[str]:
        return list(seg)

    _HAS_PYPINYIN = False

try:  # optional dependency
    import jieba

    _HAS_JIEBA = True
except ImportError:  # pragma: no cover
    _HAS_JIEBA = False


def _is_chinese(c: str) -> bool:
    return "㄀" <= c <= "鿿"


def _segment(text: str) -> list[str]:
    if _HAS_JIEBA:
        if not jieba.dt.initialized:
            jieba.default_logger.setLevel(50)
            jieba.initialize()
        return list(jieba.cut(text))
    # Fallback: whitespace segmentation keeps the ASCII path semantics.
    out: list[str] = []
    for word in text.split(" "):
        if word:
            out.append(word)
    return out


def convert_char_to_pinyin(text_list: list[str], polyphone: bool = True) -> list[list[str]]:
    final: list[list[str]] = []
    for text in text_list:
        char_list: list[str] = []
        text = text.translate(_CUSTOM_TRANS)
        for seg in _segment(text):
            seg_bytes = len(seg.encode("utf-8"))
            if seg_bytes == len(seg):  # pure ASCII: characters pass through
                if char_list and seg_bytes > 1 and char_list[-1] not in " :'\"":
                    char_list.append(" ")
                char_list.extend(seg)
            elif polyphone and seg_bytes == 3 * len(seg):  # pure east-asian
                seg_pinyin = _to_pinyin(seg)
                for ch, py in zip(seg, seg_pinyin):
                    if _is_chinese(ch):
                        char_list.append(" ")
                    char_list.append(py)
            else:  # mixed content: per character
                for ch in seg:
                    if ord(ch) < 256:
                        char_list.extend(ch)
                    elif _is_chinese(ch):
                        char_list.append(" ")
                        char_list.extend(_to_pinyin(ch))
                    else:
                        char_list.append(ch)
        final.append(char_list)
    return final
