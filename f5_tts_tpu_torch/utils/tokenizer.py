"""Host-side text processing, a copy of the JAX package's
`utils/tokenizer.py`: byte and char-vocab tokenizers and pinyin conversion.

Token semantics the pretrained weights depend on: OOV chars map to 0, batch
padding is -1, and the text embedding shifts ids by +1 so -1 becomes the
filler token 0.

jieba and pypinyin are optional and imported lazily: jieba segments only
text with a character of its Han class, and `_cut_non_han` gives exactly
`jieba.cut`'s segments for all other text.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np


def list_str_to_tensor(text: list[str], padding_value: int = -1) -> np.ndarray:
    """UTF-8 byte tokenizer -> int32 array [b, nt]. Token-list inputs are
    joined back to a string first."""
    seqs = [list(bytes(t if isinstance(t, str) else "".join(t), "UTF-8")) for t in text]
    return _pad_int_sequences(seqs, padding_value)


def list_str_to_idx(
    text: list[str] | str,
    vocab_char_map: dict[str, int],
    padding_value: int = -1,
) -> np.ndarray:
    """Char-vocab tokenizer -> int32 array [b, nt]; OOV -> 0. Also accepts a
    bare string."""
    if isinstance(text, str):
        text = [text]
    seqs = [[vocab_char_map.get(c, 0) for c in t] for t in text]
    return _pad_int_sequences(seqs, padding_value)


def _pad_int_sequences(seqs: list[list[int]], padding_value: int) -> np.ndarray:
    max_len = max((len(s) for s in seqs), default=0)
    out = np.full((len(seqs), max_len), padding_value, dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out


def load_vocab(path: str | Path) -> dict[str, int]:
    """Load a newline-separated vocab file into {char: idx}."""
    vocab = {v: i for i, v in enumerate(Path(path).read_text().split("\n"))}
    if len(vocab) == 0:
        raise ValueError(f"Could not load vocab from {path}")
    return vocab


_ZH_PUNCT = "。，、；：？！《》【】—…"


def convert_char_to_pinyin(text_list: list[str], polyphone: bool = True) -> list[list[str]]:
    """Segment mixed ZH/EN text into the char/pinyin token stream the
    pretrained vocab expects. Segments come from `jieba.cut` for text with a
    character of jieba's Han class and from `_cut_non_han` for all other
    text; pypinyin is imported only for segments with CJK characters."""
    quote_trans = str.maketrans({"“": '"', "”": '"', "‘": "'", "’": "'"})
    custom_trans = str.maketrans({";": ","})

    final_text_list = []
    for text in text_list:
        char_list: list[str] = []
        text = text.translate(quote_trans).translate(custom_trans)
        for seg in _cut(text):
            seg_byte_len = len(bytes(seg, "UTF-8"))
            if seg_byte_len == len(seg):  # pure alphabets and symbols
                if char_list and seg_byte_len > 1 and char_list[-1] not in " :'\"":
                    char_list.append(" ")
                char_list.extend(seg)
            elif polyphone and seg_byte_len == 3 * len(seg):  # pure CJK
                for c in _lazy_pinyin(seg):
                    if c not in _ZH_PUNCT:
                        char_list.append(" ")
                    char_list.append(c)
            else:  # mixed
                for c in seg:
                    if ord(c) < 256:
                        char_list.extend(c)
                    elif c not in _ZH_PUNCT:
                        char_list.append(" ")
                        char_list.extend(_lazy_pinyin(c))
                    else:
                        char_list.append(c)
        final_text_list.append(char_list)
    return final_text_list


def _cut(text: str):
    """`jieba.cut(text)`: by jieba for text with a character of its Han
    class, which raises ImportError without jieba, else by `_cut_non_han`."""
    if not _JIEBA_HAN.search(text):
        return _cut_non_han(text)
    try:
        import jieba
    except ImportError as e:
        raise ImportError("jieba is required to segment Chinese text; install f5-tts-tpu[zh]") from e
    jieba.setLogLevel(20)
    return jieba.cut(text)


# jieba's default `cut` for text without its Han class: blocks of these
# characters are cut at its dictionary's words and its `finalseg` runs; every
# other character is a segment of its own, but "\r\n" is one
_JIEBA_HAN = re.compile(r"[\u4E00-\u9FD5]")
_JIEBA_BLOCK = re.compile(r"([\u4E00-\u9FD5a-zA-Z0-9+#&._%-]+)")
_JIEBA_SKIP = re.compile(r"(\r\n|\s)")
_JIEBA_FINALSEG = re.compile(r"([a-zA-Z0-9]+(?:\.\d+)?%?)")
# the only words of jieba's dictionary without a Han character; no two of
# them can overlap, so matching them left to right is the segmentation
# jieba's route search finds
_JIEBA_WORDS = re.compile(r"AT&T|C\+\+|c\+\+|C#|c#")


def _cut_non_han(text: str) -> list[str]:
    """`jieba.cut(text)` for text without a character of jieba's Han class
    (U+4E00-U+9FD5), without jieba."""
    segments: list[str] = []
    for blk in _JIEBA_BLOCK.split(text):
        if not blk:
            continue
        if _JIEBA_BLOCK.fullmatch(blk):
            at = 0
            for word in _JIEBA_WORDS.finditer(blk):
                segments += _finalseg(blk[at:word.start()])
                segments.append(word.group())
                at = word.end()
            segments += _finalseg(blk[at:])
        else:
            for x in _JIEBA_SKIP.split(blk):
                segments += [x] if _JIEBA_SKIP.fullmatch(x) else list(x)
    return segments


def _finalseg(stretch: str) -> list[str]:
    """jieba's segments of a stretch of a block between dictionary words:
    `finalseg`'s runs and what lies between them."""
    return [x for x in _JIEBA_FINALSEG.split(stretch) if x]


def _is_han(c: str) -> bool:
    o = ord(c)
    return (
        # CJK Unified + Ext-A, minus the Yijing hexagram symbols embedded in
        # the range (U+4DC0-U+4DFF are not Han; they must pass through
        # without requiring pypinyin)
        (0x3400 <= o <= 0x9FFF and not 0x4DC0 <= o <= 0x4DFF)
        or o in (0x3005, 0x3007)    # iteration mark, ideographic zero
        or 0xF900 <= o <= 0xFAFF    # compatibility ideographs
        # assigned supplementary blocks only (Ext-B..H + compat supplement,
        # ending at Ext-H U+323AF); the planes beyond are unassigned
        or 0x20000 <= o <= 0x323AF
    )


def _lazy_pinyin(seg: str) -> list[str]:
    """pypinyin's lazy_pinyin, imported lazily. Every 3-byte UTF-8
    character reaches it, not only Chinese; pypinyin passes non-Han input
    through as one group, and so does this function without pypinyin,
    which raises the install hint only for Han characters."""
    try:
        from pypinyin import Style, lazy_pinyin
    except ImportError as e:  # pragma: no cover - environment dependent
        if any(_is_han(c) for c in seg):
            raise ImportError(
                "pypinyin is required for Chinese text; install f5-tts-tpu[zh]"
            ) from e
        return [seg]
    return lazy_pinyin(seg, style=Style.TONE3, tone_sandhi=True)
