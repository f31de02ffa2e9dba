"""The port's copy of `bisinger_tpu/data/text/english.py`, unchanged.

English text frontend: word -> CMU phones, syllabification, and
syllable<->phone alignment.

The reference uses an external CMU lexicon file + spacy_syllables
(`inference/m4singer/bisinger/a-m4-detect.py:30-136`; its rm-lexicon-en
paths point at the authors' machine and are not shipped). This module
provides:

  - a bundled lexicon (`assets/en_lexicon.txt`, ~700 high-frequency +
    lyric-vocabulary entries, ARPABET no-stress), extendable from a
    user-supplied `lexicon.txt` ("WORD PH PH ..." lines, stress digits
    stripped — the real CMU dict drops in directly);
  - morphological lookup for inflected OOVs ('s/s/es/ed/ing/er/est
    stripped, base re-looked-up, suffix phones attached by voicing
    rules) before falling back to rule G2P;
  - a rule-based grapheme-to-phoneme fallback for true OOV words;
  - a rule-based syllable splitter (vowel-group nuclei with onset
    maximization) replacing spacy_syllables;
  - `map_syllables_to_phones`: syllable<->phone alignment. mode="robust"
    (default) uses nucleus-anchored distribution; mode="ref" replicates
    the reference's consonant-boundary walk
    (`get_syllable_cmuph_mapping`, `a-m4-detect.py:85-136`) exactly,
    conformance-tested against the reference's own function.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

CMU_VOWELS = {
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
    "IH", "IY", "OW", "OY", "UH", "UW",
}

# Small built-in lexicon (common singing-lyric words); extend via file.
_BUILTIN_LEXICON = {
    "a": "AH", "i": "AY", "you": "Y UW", "me": "M IY", "my": "M AY",
    "the": "DH AH", "of": "AH V", "to": "T UW", "in": "IH N",
    "it": "IH T", "it's": "IH T S", "is": "IH Z", "and": "AE N D",
    "love": "L AH V", "baby": "B EY B IY", "heart": "HH AA R T",
    "life": "L AY F", "time": "T AY M", "night": "N AY T",
    "day": "D EY", "world": "W ER L D", "circle": "S ER K AH L",
    "hello": "HH AH L OW", "forever": "F ER EH V ER",
    "never": "N EH V ER", "always": "AO L W EY Z",
    "with": "W IH DH", "for": "F AO R", "on": "AA N", "oh": "OW",
    "oooh": "UW", "la": "L AA", "yeah": "Y AE", "be": "B IY",
    "so": "S OW", "we": "W IY", "all": "AO L", "one": "W AH N",
    "superstar": "S UW P ER S T AA R", "enough": "IH N AH F",
    "lovers": "L AH V ER Z", "dream": "D R IY M", "sing": "S IH NG",
    "song": "S AO NG", "like": "L AY K", "know": "N OW",
    "want": "W AA N T", "when": "W EH N", "where": "W EH R",
    "will": "W IH L", "can": "K AE N", "say": "S EY", "see": "S IY",
}

_G2P_DIGRAPHS = [
    ("tch", ["CH"]), ("sch", ["SH"]), ("ough", ["AO"]), ("igh", ["AY"]),
    ("tion", ["SH", "AH", "N"]), ("sion", ["ZH", "AH", "N"]),
    ("ch", ["CH"]), ("sh", ["SH"]), ("th", ["TH"]), ("ph", ["F"]),
    ("wh", ["W"]), ("ck", ["K"]), ("ng", ["NG"]), ("qu", ["K", "W"]),
    ("ee", ["IY"]), ("ea", ["IY"]), ("oo", ["UW"]), ("ou", ["AW"]),
    ("ow", ["OW"]), ("ai", ["EY"]), ("ay", ["EY"]), ("oy", ["OY"]),
    ("oi", ["OY"]), ("au", ["AO"]), ("aw", ["AO"]), ("ar", ["AA", "R"]),
    ("er", ["ER"]), ("ir", ["ER"]), ("ur", ["ER"]), ("or", ["AO", "R"]),
]
_G2P_SINGLE = {
    "a": ["AE"], "b": ["B"], "c": ["K"], "d": ["D"], "e": ["EH"],
    "f": ["F"], "g": ["G"], "h": ["HH"], "i": ["IH"], "j": ["JH"],
    "k": ["K"], "l": ["L"], "m": ["M"], "n": ["N"], "o": ["AA"],
    "p": ["P"], "q": ["K"], "r": ["R"], "s": ["S"], "t": ["T"],
    "u": ["AH"], "v": ["V"], "w": ["W"], "x": ["K", "S"], "y": ["Y"],
    "z": ["Z"],
}


_ASSET_LEXICON = os.path.join(os.path.dirname(__file__), "assets", "en_lexicon.txt")

# suffix voicing classes for morphological attachment
_VOICELESS = {"P", "T", "K", "F", "TH"}
_SIBILANT = {"S", "Z", "SH", "ZH", "CH", "JH"}


class EnglishLexicon:
    def __init__(self, lexicon_path: Optional[str] = None):
        self.dict: Dict[str, List[str]] = {
            w: p.split() for w, p in _BUILTIN_LEXICON.items()
        }
        for path in (_ASSET_LEXICON, lexicon_path):
            if path and os.path.exists(path):
                with open(path) as f:
                    for line in f:
                        if line.startswith("#"):
                            continue
                        parts = line.split()
                        if len(parts) >= 2:
                            word = parts[0].lower()
                            phones = [re.sub(r"\d", "", p) for p in parts[1:]]
                            self.dict[word] = phones

    def lookup(self, word: str) -> List[str]:
        word = word.lower().strip()
        if word in self.dict:
            return list(self.dict[word])
        morphed = self._morph_lookup(word)
        if morphed is not None:
            return morphed
        return g2p_fallback(word)

    def oov(self, word: str) -> bool:
        """True when the word resolves through rule G2P (no dictionary
        or morphological hit)."""
        w = word.lower().strip()
        return w not in self.dict and self._morph_lookup(w) is None

    # -- morphology --------------------------------------------------------
    def _base_forms(self, stem: str) -> List[str]:
        """Candidate dictionary bases for a stripped stem: as-is,
        restored silent e (mak -> make), undoubled final consonant
        (runn -> run), y-restoration (carri -> carry)."""
        cands = [stem, stem + "e"]
        if len(stem) >= 2 and stem[-1] == stem[-2] and stem[-1] not in "aeiou":
            cands.append(stem[:-1])
        if stem.endswith("i"):
            cands.append(stem[:-1] + "y")
        return cands

    def _lookup_base(self, stem: str) -> Optional[List[str]]:
        for cand in self._base_forms(stem):
            if cand in self.dict:
                return list(self.dict[cand])
        return None

    def _s_suffix(self, phones: List[str]) -> List[str]:
        last = phones[-1] if phones else ""
        if last in _SIBILANT:
            return phones + ["IH", "Z"]
        if last in _VOICELESS:
            return phones + ["S"]
        return phones + ["Z"]

    def _morph_lookup(self, word: str) -> Optional[List[str]]:
        if len(word) < 3:
            return None
        if word.endswith("'s"):
            base = self._lookup_base(word[:-2])
            return self._s_suffix(base) if base else None
        if word.endswith("es"):
            base = self._lookup_base(word[:-2])
            if base:
                return self._s_suffix(base)
        if word.endswith("s") and not word.endswith("ss"):
            base = self._lookup_base(word[:-1])
            if base:
                return self._s_suffix(base)
        if word.endswith("ed"):
            base = self._lookup_base(word[:-2])
            if base:
                last = base[-1]
                if last in ("T", "D"):
                    return base + ["AH", "D"]
                if last in _VOICELESS:
                    return base + ["T"]
                return base + ["D"]
        if word.endswith("ing"):
            base = self._lookup_base(word[:-3])
            if base:
                return base + ["IH", "NG"]
        if word.endswith("est"):
            base = self._lookup_base(word[:-3])
            if base:
                return base + ["AH", "S", "T"]
        if word.endswith("er"):
            base = self._lookup_base(word[:-2])
            if base:
                return base + ["ER"]
        if word.endswith("ly"):
            base = self._lookup_base(word[:-2])
            if base:
                return base + ["L", "IY"]
        return None


def g2p_fallback(word: str) -> List[str]:
    """Rule-based letter-to-sound for OOV words; final silent 'e' dropped."""
    w = re.sub(r"[^a-z']", "", word.lower()).replace("'", "")
    if len(w) > 2 and w.endswith("e") and w[-2] not in "aeiou":
        w = w[:-1]
    phones: List[str] = []
    i = 0
    while i < len(w):
        for pat, ph in _G2P_DIGRAPHS:
            if w.startswith(pat, i):
                phones += ph
                i += len(pat)
                break
        else:
            phones += _G2P_SINGLE.get(w[i], [])
            i += 1
    # collapse doubled consonants: 'll' -> L L -> L
    out: List[str] = []
    for p in phones:
        if out and out[-1] == p and p not in CMU_VOWELS:
            continue
        out.append(p)
    return out or ["AH"]


_VOWEL_RE = re.compile(r"[aeiouy]+")

# legal English two-letter onset clusters (kept intact at syllable starts)
_LEGAL_ONSETS = {
    "bl", "br", "ch", "cl", "cr", "dr", "fl", "fr", "gl", "gr", "kl", "kr",
    "ph", "pl", "pr", "sc", "sh", "sk", "sl", "sm", "sn", "sp", "st", "sw",
    "th", "tr", "tw", "wh", "wr",
}


def syllabify(word: str) -> List[str]:
    """Rule-based orthographic syllable split: one syllable per vowel
    group, intervocalic consonants split before the last one (onset
    maximization for singletons)."""
    w = word.lower()
    groups = list(_VOWEL_RE.finditer(w))
    if len(groups) <= 1:
        return [w]
    # drop final silent-e nucleus: 'circle' -> cir-cle not cir-cl-e
    if len(groups) >= 2 and groups[-1].group() == "e" and groups[-1].end() == len(w):
        groups = groups[:-1]
        if len(groups) == 1:
            return [w]
    bounds = [0]
    for g1, g2 in zip(groups[:-1], groups[1:]):
        cons_start, cons_end = g1.end(), g2.start()
        n_cons = cons_end - cons_start
        if n_cons <= 1:
            bounds.append(cons_start)  # V.CV
        elif w[cons_end - 2 : cons_end] in _LEGAL_ONSETS:
            bounds.append(cons_end - 2)  # VC.CCV (legal onset cluster)
        else:
            bounds.append(cons_end - 1)  # VC.CV
    bounds.append(len(w))
    return [w[a:b] for a, b in zip(bounds[:-1], bounds[1:]) if w[a:b]]


def _syllable_onset_phone(syllable: str) -> str:
    """The CMU phone the reference expects a syllable to start with
    (`get_cmuph_for_consonan`, `a-m4-detect.py:67-81`): a few hardcoded
    syllables, 'c' -> K, otherwise the first letter uppercased."""
    if syllable in ("ces", "cem"):
        return "S"
    if syllable == "ship":
        return "SH"
    if syllable == "yond":
        return "AA"
    if syllable == "out":
        return "AW"
    if syllable in ("in", "ing"):
        return "IH"
    if syllable[0] == "c":
        return "K"
    return syllable[0].upper()


_REF_FIXED = {
    "enough": [["IH"], ["N", "AH"], ["F"]],
    "lovers": [["L", "AH"], ["V", "ER", "Z"]],
}
_REF_RESPELL = {
    ("fam", "i"): ("fa", "mi"),
    ("nev", "er"): ("ne", "ver"),
    ("ev", "er"): ("e", "ver"),
    ("voic", "es"): ("voi", "ces"),
}


def _map_syllables_ref(
    syllables: List[str], phones: List[str]
) -> Optional[List[List[str]]]:
    """Reference algorithm (`get_syllable_cmuph_mapping`,
    `a-m4-detect.py:85-136`): walk the phone list, closing the current
    syllable when the phone equals the NEXT syllable's expected onset
    phone. Returns None when the walk runs off the end (the reference
    would IndexError) so the caller can fall back to the robust mode."""
    syllables = list(syllables)
    if syllables[0] == "enough":
        return [list(p) for p in _REF_FIXED["enough"]]
    if syllables[0] == "lovers":
        return [list(p) for p in _REF_FIXED["lovers"]]
    if syllables[:3] == ["for", "ev", "er"]:
        return [["F", "ER"], ["EH"], ["V", "ER"]]
    fix = _REF_RESPELL.get(tuple(syllables[:2]))
    if fix is not None:
        syllables[:2] = list(fix)

    mapping: List[List[str]] = []
    idx_slb = 0
    idx_ph = 0
    current: List[str] = []
    while idx_slb != len(syllables) - 1:
        if idx_ph >= len(phones):
            return None  # reference would crash here
        onset = _syllable_onset_phone(syllables[idx_slb + 1])
        if phones[idx_ph] != onset:
            current.append(phones[idx_ph])
        else:
            mapping.append(current)
            idx_slb += 1
            current = [phones[idx_ph]]
        idx_ph += 1
    current.extend(phones[idx_ph:])
    mapping.append(current)
    return mapping


def map_syllables_to_phones(
    syllables: List[str], phones: List[str], mode: str = "robust"
) -> List[List[str]]:
    """Distribute CMU phones across syllables. mode="ref" replicates the
    reference's consonant-boundary walk exactly (falling back to robust
    when that walk would crash); mode="robust" (default): each syllable
    owns one vowel nucleus plus surrounding consonants (onset goes with
    the following syllable), with an even-split fallback when nuclei
    don't line up."""
    if mode == "ref" and syllables:
        # no len>1 gate: the reference's fixed-word cases ("enough",
        # "lovers") fire even for single-syllable inputs, returning more
        # groups than syllables — conformance-tested against the
        # reference's own function in tests/test_text_processors.py
        ref = _map_syllables_ref(syllables, phones)
        if ref is not None:
            return ref
    n = len(syllables)
    if n <= 1:
        return [list(phones)]
    vowel_idx = [i for i, p in enumerate(phones) if p in CMU_VOWELS]
    if len(vowel_idx) < n:
        # not enough nuclei: chunk evenly
        per = max(1, len(phones) // n)
        out = [phones[i * per : (i + 1) * per] for i in range(n - 1)]
        out.append(phones[(n - 1) * per :])
        return [c or [phones[-1]] for c in out]
    # if there are extra nuclei, merge the tail ones into the last syllable
    nuclei = vowel_idx[: n - 1] + [vowel_idx[n - 1]]
    out = []
    start = 0
    for k in range(n - 1):
        # boundary: right before the consonant that onsets the next nucleus
        next_nucleus = nuclei[k + 1]
        boundary = next_nucleus
        # give a single intervocalic consonant to the next syllable
        while boundary - 1 > nuclei[k] and phones[boundary - 1] not in CMU_VOWELS:
            boundary -= 1
        # keep at least the nucleus in this syllable
        boundary = max(boundary, nuclei[k] + 1)
        # coda: if more than one consonant, keep all but one here
        n_cons = next_nucleus - boundary
        if n_cons > 1:
            boundary = next_nucleus - 1
        out.append(phones[start:boundary])
        start = boundary
    out.append(phones[start:])
    return out
