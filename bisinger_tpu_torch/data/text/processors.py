"""The port's copy of `bisinger_tpu/data/text/processors.py`.

Per-language txt processors: raw transcript -> phone string.

Behavioural equivalents of the reference's
`train_bisinger/data_gen/tts/txt_processors/{en,zh_g2pM}.py`:

  - registry keyed by language name (the binarizer picks a processor from
    the dataset config);
  - EN (`en.py:12-78`): number normalization -> word tokens -> CMU
    phones, with `|` separating words;
  - ZH (`zh_g2pM.py:15-67`): NSW normalization -> per-hanzi pinyin ->
    shengmu/yunmu split, with jieba word boundaries marked `#` and `|`
    between characters.

The reference depends on g2p_en/nltk and g2pM/jieba/pypinyin; here the
lexicon + rule G2P from `data.text.english` and the structured pinyin
tables from `data.text.pinyin` are used instead, with pypinyin/jieba
picked up when installed. Host-side, pure Python.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple, Type

from bisinger_tpu_torch.data.text.english import EnglishLexicon
from bisinger_tpu_torch.data.text.pinyin import is_valid_pinyin, split_pinyin
from bisinger_tpu_torch.data.text.text_norm import normalize_chinese

REGISTERED_TXT_PROCESSORS: Dict[str, Type] = {}


def register_txt_processor(name: str):
    def _register(cls):
        REGISTERED_TXT_PROCESSORS[name] = cls
        return cls

    return _register


def get_txt_processor_cls(name: str):
    return REGISTERED_TXT_PROCESSORS[name]


class BaseTxtProcessor:
    @classmethod
    def process(cls, txt: str) -> Tuple[List[str], str]:
        """-> (phone tokens incl. separators, normalized text)."""
        raise NotImplementedError


# ---------------------------------------------------------------- English
_EN_ONES = (
    "zero one two three four five six seven eight nine ten eleven twelve "
    "thirteen fourteen fifteen sixteen seventeen eighteen nineteen"
).split()
_EN_TENS = (
    "zero ten twenty thirty forty fifty sixty seventy eighty ninety"
).split()


def english_number_reading(n: int) -> str:
    """123 -> 'one hundred twenty three' (reference normalizes numbers
    via the `inflect`-style path in g2p_en)."""
    if n < 0:
        return "minus " + english_number_reading(-n)
    if n < 20:
        return _EN_ONES[n]
    if n < 100:
        return (_EN_TENS[n // 10] + (" " + _EN_ONES[n % 10] if n % 10 else "")).strip()
    for div, unit in ((10**9, "billion"), (10**6, "million"), (10**3, "thousand"), (100, "hundred")):
        if n >= div:
            rest = n % div
            head = english_number_reading(n // div) + " " + unit
            return head + (" " + english_number_reading(rest) if rest else "")
    return str(n)


def _normalize_english_numbers(text: str) -> str:
    return re.sub(r"\d+", lambda m: english_number_reading(int(m.group(0))), text)


@register_txt_processor("en")
class EnTxtProcessor(BaseTxtProcessor):
    """English: numbers -> words, word tokens -> CMU phones, `|` between
    words (reference `txt_processors/en.py:12-78`)."""

    lexicon = EnglishLexicon()

    @classmethod
    def process(cls, txt: str) -> Tuple[List[str], str]:
        txt = _normalize_english_numbers(txt.lower())
        txt = re.sub(r"[^a-z' ]", " ", txt)
        words = [w for w in txt.split() if w]
        phs: List[str] = []
        for i, w in enumerate(words):
            if i > 0:
                phs.append("|")
            phs.extend(cls.lexicon.lookup(w))
        return phs, " ".join(words)


# ---------------------------------------------------------------- Chinese
_HANZI_RE = re.compile(r"[一-鿿]")


def _jieba_boundaries(txt: str) -> List[int]:
    """Index set of character positions that END a jieba word (reference
    marks them `#`, `zh_g2pM.py:30-45`)."""
    try:
        import jieba

        ends, pos = set(), 0
        for w in jieba.cut(txt):
            pos += len(w)
            ends.add(pos - 1)
        return sorted(ends)
    except ImportError:
        return list(range(len(txt)))  # every char its own word


def _hanzi_pinyin_seq(txt: str) -> List[str]:
    try:
        from pypinyin import lazy_pinyin

        return lazy_pinyin(txt, strict=False)
    except ImportError as e:
        raise RuntimeError(
            "pypinyin not installed; feed pinyin text (e.g. 'ni hao') to "
            "ZhTxtProcessor.process_pinyin instead of hanzi"
        ) from e


@register_txt_processor("zh_g2pM")
@register_txt_processor("zh")
class ZhTxtProcessor(BaseTxtProcessor):
    """Chinese: NSW normalize -> per-char pinyin -> shengmu/yunmu split,
    `|` between syllables, `#` at jieba word ends (reference
    `txt_processors/zh_g2pM.py:15-67`)."""

    @classmethod
    def process(cls, txt: str) -> Tuple[List[str], str]:
        txt = normalize_chinese(txt)
        chars = [c for c in txt if _HANZI_RE.match(c)]
        clean = "".join(chars)
        if not clean:
            return [], ""
        pinyins = _hanzi_pinyin_seq(clean)
        word_ends = set(_jieba_boundaries(clean))
        return cls._emit(pinyins, word_ends), clean

    @classmethod
    def process_pinyin(cls, syllables: List[str]) -> List[str]:
        """Pinyin-annotated path (no pypinyin needed); every syllable is
        its own word."""
        bad = [s for s in syllables if not is_valid_pinyin(s)]
        if bad:
            raise ValueError(f"not pinyin: {bad}")
        return cls._emit(syllables, set(range(len(syllables))))

    @staticmethod
    def _emit(pinyins: List[str], word_ends) -> List[str]:
        phs: List[str] = []
        for i, py in enumerate(pinyins):
            if i > 0:
                phs.append("|")
            sm, ym = split_pinyin(py)
            if sm:
                phs.append(sm)
            phs.append(ym)
            if i in word_ends:
                phs.append("#")
        return phs
