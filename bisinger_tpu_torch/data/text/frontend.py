"""The port's copy of `bisinger_tpu/data/text/frontend.py`; only its imports differ.

Bilingual (CN/EN) score frontend: lyrics + notes -> model inputs.

Behavioural port of the reference's standalone bilingual inference
preprocessing (`inference/m4singer/bisinger/a-m4-detect.py:44-497`):

  - word-level input: `text` tokens (pinyin syllables / hanzi / English
    words / AP / SP), `notes` and `notes_duration` strings with `|`
    separating the per-word note windows;
  - CJK regex language tagging (CN=1, EN=0);
  - CN words -> pinyin -> CMU phones (`data.text.pinyin`); extra notes on
    a word repeat the yunmu phones with is_slur=1 (`:292-316`);
  - EN words -> syllables -> CMU phones with the reference's three slur
    rules (`:333-375`): per-syllable notes, repeated single-phone
    syllable melisma, or one note for the whole word — plus the
    last-syllable split when notes = syllables+1;
  - note names -> MIDI ids ('rest' -> 0), BPM beats -> seconds
    (`:44-59`);
  - phoneme-level direct input (`ph_seq`/`note_seq`/... keys).

Host-side, pure Python, no external NLP deps.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np

from bisinger_tpu_torch.data.text.english import (
    EnglishLexicon,
    map_syllables_to_phones,
    syllabify,
)
from bisinger_tpu_torch.data.text.pinyin import (
    INITIALS,
    is_valid_pinyin,
    pinyin_to_cmu,
    split_pinyin,
)

CHINESE = 1
ENGLISH = 0

# EN phones absent from the monolingual (train_m4singer) CN phone sets,
# substituted with the nearest CN-trained phone. "system2" is the
# pinyin-split model's table (`train_m4singer/bisinger-inference/
# a-m4.py:393-411`); "system1" the averaged-split model's
# (`a-m4-avg.py:393-414`, which also drops the '^' zero-initial marker).
EN_PHONE_SUBST = {
    "system2": {"TH": "S", "Y": "IY", "IH": "AY", "DH": "Z", "V": "W", "OY": "OW"},
    "system1": {
        "TH": "S", "Y": "IY", "IH": "AY", "DH": "Z",
        "V": "UW", "W": "UW", "OY": "OW",
    },
}

_CJK_RE = re.compile(r"[一-鿿]+")

_NOTE_OFFSETS = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}


def contains_chinese(text: str) -> bool:
    return _CJK_RE.search(text) is not None


def note_to_midi(note: str) -> int:
    """'C4' -> 60, 'A#3/Bb3' -> 58, 'rest' -> 0 (librosa.note_to_midi
    convention)."""
    if note in ("rest", "0", ""):
        return 0
    note = note.split("/")[0].strip()
    m = re.match(r"^([A-Ga-g])([#b♯♭]*)(-?\d+)$", note)
    if not m:
        raise ValueError(f"bad note {note!r}")
    pitch = _NOTE_OFFSETS[m.group(1).upper()]
    for acc in m.group(2):
        pitch += 1 if acc in "#♯" else -1
    octave = int(m.group(3))
    return 12 * (octave + 1) + pitch


def beats_to_seconds(bpm: float, beats: str) -> str:
    """'0.2 | 1 | 1 0.5' at given BPM -> seconds string with the same `|`
    structure (quarter note = 1 beat unit scaled by 4, reference
    `:44-59`)."""
    second_per_beat = 60.0 / bpm
    words = [w.strip() for w in beats.split("|") if w.strip()]
    out = []
    for w in words:
        vals = [float(x) for x in w.split()]
        out.append(" ".join(f"{second_per_beat * v * 4:.4f}" for v in vals))
    return "|".join(out)


def hanzi_to_pinyin(token: str) -> List[str]:
    """Hanzi -> pinyin syllables. Uses pypinyin when available; otherwise
    raises with guidance (score inputs may use pinyin directly)."""
    try:
        from pypinyin import lazy_pinyin

        return lazy_pinyin(token, strict=False)
    except ImportError as e:
        raise RuntimeError(
            "pypinyin is not installed; write Chinese lyrics as pinyin "
            "syllables (e.g. 'wo xi huan ni') instead of hanzi"
        ) from e


class BilingualFrontend:
    """Score -> {ph tokens, pitch_midi, midi_dur, is_slur, lang,
    speechsing} arrays."""

    def __init__(
        self,
        phone_encoder,
        lexicon_path: Optional[str] = None,
        phone_subst: Optional[Any] = None,
    ):
        self.encoder = phone_encoder
        self.lexicon = EnglishLexicon(lexicon_path)
        if isinstance(phone_subst, str):
            phone_subst = EN_PHONE_SUBST[phone_subst]
        self.phone_subst = phone_subst or {}

    # ---- word level -------------------------------------------------------
    def preprocess_word_level(self, inp: Dict[str, Any]) -> Dict[str, Any]:
        tokens: List[str] = inp["text"].split()
        words: List[str] = []
        language: List[int] = []
        for token in tokens:
            if contains_chinese(token):
                for py in hanzi_to_pinyin(token):
                    words.append(py)
                    language.append(CHINESE)
            elif token not in ("AP", "SP") and is_valid_pinyin(token) and (
                inp.get("assume_pinyin", True)
            ) and not token.lower() in self.lexicon.dict:
                # bare pinyin syllable written in latin letters
                words.append(token)
                language.append(CHINESE)
            else:
                words.append(token)
                language.append(ENGLISH)

        note_windows = [x.strip() for x in inp["notes"].split("|") if x.strip()]
        dur_windows = [
            x.strip() for x in inp["notes_duration"].split("|") if x.strip()
        ]
        if not (len(words) == len(note_windows) == len(dur_windows)):
            raise ValueError(
                f"word/notes mismatch: {len(words)} words, "
                f"{len(note_windows)} note windows, {len(dur_windows)} durations"
            )

        ph_lst: List[str] = []
        note_lst: List[str] = []
        midi_dur_lst: List[str] = []
        is_slur: List[int] = []
        lang: List[int] = []

        def emit(ph, note, dur, slur, lg):
            ph_lst.append(ph)
            note_lst.append(note)
            midi_dur_lst.append(dur)
            is_slur.append(slur)
            lang.append(lg)

        for word, lg, notes_s, durs_s in zip(
            words, language, note_windows, dur_windows
        ):
            notes = notes_s.split()
            durs = durs_s.split()
            if word in ("AP", "SP"):
                emit(f"<{word}>", notes[0], durs[0], 0, CHINESE)
            elif lg == CHINESE:
                phones = pinyin_to_cmu(word)
                for ph in phones:
                    emit(ph, notes[0], durs[0], 0, CHINESE)
                # extra notes: repeat the YUNMU with slur flags
                # (reference `:292-316`). The yunmu is phones minus the
                # initial's phones — NOT phones[1:]: zero-initial
                # syllables ('ai') have no initial at all, and 'c'/'q'…
                # map to multiple phones, so a fixed 1-phone skip would
                # drop melisma notes or leak initial phones into slurs.
                ini, _fin = split_pinyin(word)
                n_ini = len(INITIALS[ini]) if ini else 0
                yunmu = phones[n_ini:] or phones[-1:]
                for note, dur in zip(notes[1:], durs[1:]):
                    for ph in yunmu:
                        emit(ph, note, dur, 1, CHINESE)
            else:
                phones = self.lexicon.lookup(word)
                syllables = syllabify(word)
                mapping = map_syllables_to_phones(syllables, phones)
                if len(mapping) == len(notes) - 1 and len(mapping) > 0:
                    # split the last syllable across two notes (`:340-347`)
                    last = mapping[-1]
                    mapping = mapping[:-1] + [last[:2], last[1:]]
                if len(mapping) == len(notes):
                    for phs, note, dur in zip(mapping, notes, durs):
                        for ph in phs:
                            emit(ph, note, dur, 0, ENGLISH)
                elif len(mapping) == 1 and len(mapping[0]) == 1:
                    # single-phone melisma over several notes (`:356-366`)
                    ph = mapping[0][0]
                    for idx, (note, dur) in enumerate(zip(notes, durs)):
                        emit(ph, note, dur, 1 if idx else 0, ENGLISH)
                elif len(notes) == 1:
                    for phs in mapping:
                        for ph in phs:
                            emit(ph, notes[0], durs[0], 0, ENGLISH)
                else:
                    # general fallback: per-syllable, extra notes slur
                    # the last syllable's vowel tail; when there are MORE
                    # syllables than notes, the surplus syllables' phones
                    # merge onto the last note instead of silently
                    # disappearing from the zip
                    if len(mapping) > len(notes):
                        head = mapping[: len(notes) - 1]
                        tail = [p for phs in mapping[len(notes) - 1 :] for p in phs]
                        mapping = head + [tail]
                    for phs, note, dur in zip(mapping, notes, durs):
                        for ph in phs:
                            emit(ph, note, dur, 0, ENGLISH)
                    for note, dur in zip(notes[len(mapping):], durs[len(mapping):]):
                        emit(mapping[-1][-1], note, dur, 1, ENGLISH)

        if self.phone_subst:
            # map out-of-training-set EN phones and drop '^' markers
            # together with their note/dur/slur/lang entries. ENGLISH
            # rows only: unlike the reference's lang-blind
            # replace_en_with_cn (safe there because its monolingual
            # training map contains no W/Y), this repo's pinyin_to_cmu
            # DOES emit W/Y into Chinese training data (tools/meta.py),
            # so substituting them on CN rows would feed the model
            # phone sequences it never saw in training.
            rows = [
                (
                    self.phone_subst.get(ph, ph) if lg == ENGLISH else ph,
                    note, dur, slur, lg,
                )
                for ph, note, dur, slur, lg in zip(
                    ph_lst, note_lst, midi_dur_lst, is_slur, lang
                )
                if ph != "^"
            ]
            ph_lst, note_lst, midi_dur_lst, is_slur, lang = (
                [list(col) for col in zip(*rows)] if rows else ([], [], [], [], [])
            )

        return {
            "ph_seq": " ".join(ph_lst),
            "note_lst": note_lst,
            "midi_dur_lst": midi_dur_lst,
            "is_slur": is_slur,
            "lang": lang,
            "speechsing": int(inp.get("speechsing", 1)),
            # exact score duration: each note's dur counted ONCE
            # (midi_dur_lst repeats it per phone in the word, so
            # summing that overbooks the mel-frame budget 2-3x)
            "total_sec": sum(
                float(d) for w in dur_windows for d in w.split()
            ),
        }

    # ---- phoneme level ----------------------------------------------------
    def preprocess_phoneme_level(self, inp: Dict[str, Any]) -> Dict[str, Any]:
        ph_seq = inp["ph_seq"]
        note_lst = inp["note_seq"].split()
        midi_dur_lst = inp["note_dur_seq"].split()
        is_slur = [int(float(x)) for x in inp["is_slur_seq"].split()]
        lang = [int(float(x)) for x in inp["lang_seq"].split()]
        n = len(ph_seq.split())
        assert len(note_lst) == len(midi_dur_lst) == len(is_slur) == len(lang) == n
        # Phoneme-level input carries no word grid, so "count each note
        # once" cannot be reconstructed safely: consecutive words sung on
        # the same (note, dur) — repeated quarter notes are common — would
        # collapse into one note and UNDERCOUNT, silently shrinking the
        # mel-frame bucket and truncating audio. Use the conservative
        # per-row sum (a safe overestimate: multi-phone words repeat their
        # note's dur per phone, so the bucket is at worst padded, never
        # short). Word-level input computes the exact duration instead.
        total = sum(float(d) for d in midi_dur_lst)
        return {
            "ph_seq": ph_seq,
            "note_lst": note_lst,
            "midi_dur_lst": midi_dur_lst,
            "is_slur": is_slur,
            "lang": lang,
            "speechsing": int(inp.get("speechsing", 1)),
            "total_sec": total,
        }

    # ---- to model inputs --------------------------------------------------
    def __call__(
        self, inp: Dict[str, Any], spk_map: Optional[Dict[str, int]] = None
    ) -> Dict[str, Any]:
        if inp.get("input_type", "word") == "word":
            if inp.get("bpm"):
                inp = dict(inp)
                inp["notes_duration"] = beats_to_seconds(
                    float(inp["bpm"]), inp["notes_duration"]
                )
            ret = self.preprocess_word_level(inp)
        else:
            ret = self.preprocess_phoneme_level(inp)

        midis = [note_to_midi(x) for x in ret["note_lst"]]
        midi_dur = [float(x) for x in ret["midi_dur_lst"]]
        ph_token = self.encoder.encode(ret["ph_seq"])
        spk_id = 0
        if spk_map:
            spk_id = spk_map.get(inp.get("spk_name", ""), 0)
        return {
            "item_name": inp.get("item_name", "<item>"),
            "text": inp.get("text", ret["ph_seq"]),
            "ph": ret["ph_seq"],
            "ph_token": np.asarray(ph_token, dtype=np.int64),
            "pitch_midi": np.asarray(midis, dtype=np.int64),
            "midi_dur": np.asarray(midi_dur, dtype=np.float32),
            "is_slur": np.asarray(ret["is_slur"], dtype=np.int64),
            "lang": np.asarray(ret["lang"], dtype=np.int64),
            "speechsing": int(ret["speechsing"]),
            "spk_id": spk_id,
            "total_sec": float(ret.get("total_sec") or sum(midi_dur)),
        }
