"""The port's copy of `bisinger_tpu/data/text/pinyin.py`, unchanged.

Pinyin -> CMU-phone conversion (BiSinger unified phone set).

The reference maps pinyin syllables to an extended CMU phone inventory via
a lexicon file (`inference/cmu_dicts/rm-lexicon-cn.txt`, built from
`assets/pinyin_cmu_map.txt`). The mapping table below reproduces that
convention — including BiSinger's non-standard consonant phones J/Q/X/Y
for the palatal initials — as structured initial/final tables instead of
a flat 400-line lexicon.

Host-side, pure Python.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

# initials (shengmu) -> CMU-ish consonants (BiSinger convention,
# assets/pinyin_cmu_map.txt)
INITIALS = {
    "b": ["B"], "p": ["P"], "m": ["M"], "f": ["F"],
    "d": ["D"], "t": ["T"], "n": ["N"], "l": ["L"],
    "g": ["G"], "k": ["K"], "h": ["HH"],
    "j": ["J"], "q": ["Q"], "x": ["X"],
    "zh": ["JH"], "ch": ["CH"], "sh": ["SH"], "r": ["R"],
    "z": ["Z"], "c": ["T", "S"], "s": ["S"],
    "y": ["Y"], "w": ["W"],
}

# finals (yunmu) -> CMU vowel sequences (BiSinger convention)
FINALS = {
    "a": ["AA"], "ai": ["AY"], "an": ["AE", "N"], "ang": ["AE", "NG"],
    "ao": ["AW"],
    "e": ["ER"], "ei": ["EY"], "en": ["AH", "N"], "eng": ["AH", "NG"],
    "er": ["AA", "R"],
    "i": ["IY"], "ia": ["IY", "AA"], "ian": ["IY", "AE", "N"],
    "iang": ["IY", "AE", "NG"], "iao": ["IY", "AW"], "ie": ["IY", "EH"],
    "in": ["IY", "N"], "ing": ["IY", "NG"], "iong": ["IY", "UH", "NG"],
    "iou": ["IY", "UH"], "iu": ["IY", "UH"],
    "o": ["AO"], "ong": ["UH", "NG"], "ou": ["OW"],
    "u": ["UW"], "ua": ["UW", "AA"], "uai": ["UW", "AY"],
    "uan": ["UW", "AE", "N"], "uang": ["UW", "AE", "NG"],
    "uei": ["UW", "IY"], "ui": ["UW", "IY"],
    "uen": ["UW", "AH", "N"], "un": ["UW", "AH", "N"],
    "uo": ["UW", "AO"],
    "v": ["IY", "UW"], "ve": ["IY", "EH"], "vn": ["UW", "AH", "N"],
    "van": ["UW", "AE", "N"],
    "ue": ["IY", "EH"],  # jue/que/xue written without umlaut
}

_MULTI_INITIALS = ("zh", "ch", "sh")


def split_pinyin(syllable: str) -> Tuple[Optional[str], str]:
    """'zhang' -> ('zh', 'ang'); 'an' -> (None, 'an')."""
    s = syllable.lower().strip().rstrip("12345")
    for ini in _MULTI_INITIALS:
        if s.startswith(ini):
            return ini, s[len(ini):]
    if s and s[0] in INITIALS and len(s) > 1:
        return s[0], s[1:]
    return None, s


def pinyin_to_cmu(syllable: str) -> List[str]:
    """One pinyin syllable -> CMU phone list. Raises KeyError on
    unmappable finals."""
    ini, fin = split_pinyin(syllable)
    # u after j/q/x/y is really ü
    if ini in ("j", "q", "x", "y") and fin in ("u", "uan", "un", "ue"):
        fin = {"u": "v", "uan": "van", "un": "vn", "ue": "ve"}[fin]
    phones: List[str] = []
    if ini is not None:
        phones += INITIALS[ini]
    phones += FINALS[fin]
    return phones


def is_valid_pinyin(syllable: str) -> bool:
    try:
        pinyin_to_cmu(syllable)
        return True
    except KeyError:
        return False


def all_pinyin_syllables() -> List[str]:
    """Enumerate valid initial+final combinations (superset of real
    Mandarin syllables — used to build lexicons)."""
    out = set(FINALS)
    for ini in INITIALS:
        for fin in FINALS:
            out.add(ini + fin)
    return sorted(out)
