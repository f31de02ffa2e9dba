"""The port's score front end (`bisinger_tpu_torch/data/text`,
`utils/text_encoder.py`) against the JAX package's, and the flagship's
phone set and speaker map.

The front end is host code on both sides, so every comparison is exact:
token ids, MIDI ids, durations as float32, slur and language flags, the
phone string and `total_sec` of each item.
"""

import json
import os
import sys

import numpy as np
import pytest

from bisinger_tpu.data import synthetic
from bisinger_tpu.data.text import english as j_english
from bisinger_tpu.data.text import frontend as j_frontend
from bisinger_tpu.data.text import pinyin as j_pinyin
from bisinger_tpu.utils import text_encoder as j_text_encoder
from bisinger_tpu_torch.data.text import english, frontend, pinyin
from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR
from bisinger_tpu_torch.utils import text_encoder

# the encoders of tests/test_frontend.py: make_frontend's and TestMelisma's
TEST_PHONES = sorted(set(
    ["<SP>", "<AP>"]
    + [p for s in ["wo", "xi", "huan", "ni"] for p in j_pinyin.pinyin_to_cmu(s)]
    + ["S", "ER", "K", "AH", "L", "DH", "T", "IH", "Z", "OW", "AY", "V",
       "F", "L", "AY", "EH", "UW", "AA", "R", "P", "B", "IY", "M", "EY"]))
MELISMA_PHONES = ["AY", "AE", "N", "T", "S", "B", "IY", "UW", "AH", "F", "L", "JH", "AA", "NG",
                  "Y", "<AP>", "<SP>"]

# every score of tests/test_frontend.py, plus a phoneme-level score, a
# speaker, hanzi-free pinyin with every multi-phone initial, and a melisma
# over more syllables than notes
SCORES = {
    "mixed": (TEST_PHONES, dict(text="SP wo xi huan ni circle",
                                notes="rest | C4 | D4 | E4 | F4 | G4 A4",
                                notes_duration="0.2 | 0.3 | 0.3 | 0.3 | 0.3 | 0.2 0.3")),
    "cn_slur": (TEST_PHONES, dict(text="wo", notes="C4 D4", notes_duration="0.3 0.2")),
    "en_melisma": (TEST_PHONES, dict(text="oooh", notes="C4 D4 E4",
                                     notes_duration="0.2 0.2 0.2")),
    "bpm": (TEST_PHONES, dict(text="wo", notes="C4", notes_duration="0.25", bpm=120)),
    "zero_initial": (MELISMA_PHONES, dict(text="ai", notes="C4 D4", notes_duration="0.3 0.3")),
    "multi_phone_initial": (MELISMA_PHONES, dict(text="cai", notes="C4 D4",
                                                 notes_duration="0.3 0.3")),
    "full_yunmu": (MELISMA_PHONES, dict(text="zhang", notes="C4 D4", notes_duration="0.3 0.3")),
    "more_syllables_than_notes": (MELISMA_PHONES, dict(text="beautiful", notes="C4 D4",
                                                       notes_duration="0.3 0.3")),
    "total_sec": (MELISMA_PHONES, dict(text="zhang ai", notes="C4 D4 | E4",
                                       notes_duration="0.3 0.2 | 0.4")),
    "initials": (TEST_PHONES, dict(text="AP zhi chi shi ci qu superstar", spk_name="b",
                                   notes="rest | C4 | D4 | E4 | F4 | G4 | A4 B4 C5",
                                   notes_duration="0.1 | 0.2 | 0.2 | 0.2 | 0.2 | 0.2 | "
                                                  "0.1 0.1 0.2", speechsing=0)),
    "phoneme_level": (TEST_PHONES, dict(input_type="phoneme", ph_seq="<SP> W AO SP N IY",
                                        note_seq="rest C4 C4 rest D#4/Eb4 D#4/Eb4",
                                        note_dur_seq="0.1 0.3 0.3 0.05 0.4 0.4",
                                        is_slur_seq="0 0 0 0 0 1", lang_seq="1 1 1 1 1 1",
                                        item_name="ph")),
}
SPK_MAP = {"a": 0, "b": 3}


def _pair(phones):
    jenc = j_text_encoder.TokenTextEncoder(vocab_list=phones, replace_oov=",")
    enc = text_encoder.TokenTextEncoder(vocab_list=phones, replace_oov=",")
    return j_frontend.BilingualFrontend(jenc), frontend.BilingualFrontend(enc)


def _assert_items_equal(got, ref):
    assert got.keys() == ref.keys()
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert type(got[key]) is type(value) and got[key] == value, key


@pytest.mark.parametrize("name", sorted(SCORES))
def test_frontend_item_equals_jax(name):
    phones, score = SCORES[name]
    jfe, fe = _pair(phones)
    ref = jfe(dict(score), SPK_MAP)
    _assert_items_equal(fe(dict(score), SPK_MAP), ref)
    assert len(ref["ph_token"]) >= 1


def test_frontend_raises_as_jax():
    jfe, fe = _pair(TEST_PHONES)
    bad = dict(text="wo ni", notes="C4", notes_duration="0.3")
    with pytest.raises(ValueError) as jerr:
        jfe(bad)
    with pytest.raises(ValueError) as err:
        fe(bad)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="bad note"):
        fe(dict(text="wo", notes="H4", notes_duration="0.3"))


def test_hanzi_without_pypinyin_raises_as_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "pypinyin", None)  # import fails, as where it is absent
    jfe, fe = _pair(TEST_PHONES)
    score = dict(text="我 ni", notes="C4 | D4", notes_duration="0.3 | 0.3")
    with pytest.raises(RuntimeError) as jerr:
        jfe(score)
    with pytest.raises(RuntimeError) as err:
        fe(score)
    assert str(err.value) == str(jerr.value) and "pypinyin" in str(err.value)


def test_pinyin_tables_equal_jax():
    syllables = pinyin.all_pinyin_syllables()
    assert syllables == j_pinyin.all_pinyin_syllables() and len(syllables) > 300
    for s in syllables + ["wo3", "lv", "nue", "xx"]:
        assert pinyin.is_valid_pinyin(s) == j_pinyin.is_valid_pinyin(s), s
        if j_pinyin.is_valid_pinyin(s):
            assert pinyin.pinyin_to_cmu(s) == j_pinyin.pinyin_to_cmu(s), s
            assert pinyin.split_pinyin(s) == j_pinyin.split_pinyin(s), s


def test_english_equals_jax_over_the_lexicon():
    lex, jlex = english.EnglishLexicon(), j_english.EnglishLexicon()
    assert lex.dict == jlex.dict and len(lex.dict) > 900
    words = sorted(lex.dict) + ["zorbly", "singing", "dreamed", "lovers", "church"]
    for w in words:
        phones = lex.lookup(w)
        assert phones == jlex.lookup(w), w
        assert english.g2p_fallback(w) == j_english.g2p_fallback(w), w
        syl = english.syllabify(w)
        assert syl == j_english.syllabify(w), w
        assert (english.map_syllables_to_phones(syl, phones)
                == j_english.map_syllables_to_phones(syl, phones)), w


def test_flagship_phone_set_and_speakers_are_the_binarizers():
    """artifacts/flagship/{phone_set,spk_map}.json as the binarizer wrote
    them for the flagship's corpus (`make_synthetic_corpus(raw, 512,
    seed=0)`, scripts/train_flagship.py:149): the sorted set of the
    corpus's phones (`binarizer.py:367-378`), and its singers numbered in
    sorted order (`binarizer.py:380-387`). The phone set plus the three
    reserved ids fills the token embedding of diff_params.npz."""
    phones = sorted(set(synthetic._CN_PHONES + synthetic._EN_PHONES + [synthetic._SIL]))
    with open(os.path.join(FLAGSHIP_DIR, "phone_set.json")) as f:
        assert json.load(f) == phones
    with open(os.path.join(FLAGSHIP_DIR, "spk_map.json")) as f:
        assert json.load(f) == {"Alto-1": 0, "Tenor-1": 1}
    with np.load(os.path.join(FLAGSHIP_DIR, "diff_params.npz")) as z:
        rows = z["fs2/token_embed/embed/embedding"].shape[0]
    assert len(phones) + 3 == rows == 24
    enc = text_encoder.build_phone_encoder(FLAGSHIP_DIR)
    jenc = j_text_encoder.build_phone_encoder(FLAGSHIP_DIR)
    assert enc.vocab_size == rows
    # scores spell silence SP; the frontend writes <SP>; other spellings go
    # through replace_oov to <UNK>, as in the JAX package
    line = "<SP> SP sh ang W AO , <pad>"
    assert enc.encode(line) == jenc.encode(line)
    assert enc.encode("<SP> SP") == [3, 2]
