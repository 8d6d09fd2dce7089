"""Host-side text tokenizers, a copy of the JAX package's `utils/tokenizer.py`
(byte and char-vocab tokenizers; pinyin conversion is not ported yet).

Token semantics the pretrained weights depend on: OOV chars map to 0, batch
padding is -1, and the text embedding shifts ids by +1 so -1 becomes the
filler token 0.
"""

from __future__ import annotations

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
