"""The port's pinyin conversion (`f5_tts_tpu_torch/utils/tokenizer.py`
`convert_char_to_pinyin`) against the JAX package's, which always
segments with jieba.

The port gives jieba only text with a character of jieba's Han class; all
other text is cut by its own segmenter, whose segments must be exactly
jieba's: a hypothesis test hides jieba from the port and holds its tokens
to the JAX function's with jieba. The tests that compare with the JAX
function skip without jieba, and text that needs pypinyin skips where it
is missing.
"""

import sys
from unittest import mock

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from f5_tts_tpu.utils.tokenizer import convert_char_to_pinyin as jax_convert
from f5_tts_tpu_torch.utils import tokenizer as tok

TEXTS = [
    "Some call me nature, others call me mother nature.",
    "hello,world", "3.5% of C++ users", "now... and then", "AT&T and c# users; x--y__z",
    "line one\r\nline two\tand\nthree", "“quoted” and ‘single’ — with a dash…",
    "café naïve façade", "e.g. v1.2.3-rc_4 at 12:30", "Mixed: résumé—draft…ok?",
    "", "   ", "a", "C++C#c++", "100%!", "well.. ok.", "x+y=z & a#b", "wait—what…",
]
ALPHABET = (
    [chr(c) for c in range(0x20, 0x7F)] + ["\t", "\n", "\r", "\r\n"]
    + [chr(c) for c in range(0xA0, 0x100)] + list("—…“”‘’;")
)
WORDS = ["C++", "c++", "AT&T", "c#", "C#", "3.5%", "\r\n", "..."]


@pytest.mark.parametrize("text", TEXTS)
def test_matches_jax_with_jieba(text):
    pytest.importorskip("jieba")
    assert tok.convert_char_to_pinyin([text]) == jax_convert([text])


@settings(max_examples=400, deadline=None, database=None, derandomize=True)
@given(st.lists(st.one_of(st.sampled_from(ALPHABET), st.sampled_from(WORDS)), max_size=40).map("".join))
def test_without_jieba_matches_jax_with_jieba(text):
    jieba = pytest.importorskip("jieba")
    expected = jax_convert([text])
    segments = list(jieba.cut(text))
    with mock.patch.dict(sys.modules, {"jieba": None}):
        assert tok._cut_non_han(text) == segments
        assert tok.convert_char_to_pinyin([text]) == expected


@pytest.mark.parametrize("text", TEXTS)
def test_fixed_texts_without_jieba(text):
    pytest.importorskip("jieba")
    expected = jax_convert([text])
    with mock.patch.dict(sys.modules, {"jieba": None}):
        assert tok.convert_char_to_pinyin([text]) == expected


def test_han_text_without_jieba_raises():
    with mock.patch.dict(sys.modules, {"jieba": None}):
        with pytest.raises(ImportError, match=r"f5-tts-tpu\[zh\]"):
            tok.convert_char_to_pinyin(["hello 你好"])
        # Han characters outside jieba's Han class pass through its segmenter
        # and reach pypinyin on their own, as with jieba
        assert tok._cut_non_han("a㐀b") == ["a", "㐀", "b"]


def test_non_han_three_byte_characters_need_no_pypinyin():
    """Em dashes and ellipses take the CJK branch (3 bytes each) and pass
    through unchanged without pypinyin; Han characters raise its install
    hint."""
    with mock.patch.dict(sys.modules, {"pypinyin": None}):
        assert tok._lazy_pinyin("—…") == ["—…"]
        with pytest.raises(ImportError, match=r"pypinyin is required"):
            tok._lazy_pinyin("你")
        assert tok.convert_char_to_pinyin(["wait—what…"]) == [list("wait—") + [" "] + list("what…")]


def test_han_text_is_cut_by_jieba():
    """Text with a character of jieba's Han class goes to jieba itself."""
    jieba = pytest.importorskip("jieba")
    for text in ["我爱 Python 和 C++。", "中文English混合，3.5%的人"]:
        assert list(tok._cut(text)) == list(jieba.cut(text))


@pytest.mark.parametrize("text", ["你好，世界！", "我爱 Python 和 C++。", "中文English混合，3.5%的人"])
def test_chinese_matches_jax(text):
    pytest.importorskip("pypinyin")
    assert tok.convert_char_to_pinyin([text]) == jax_convert([text])
