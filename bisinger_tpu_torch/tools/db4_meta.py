"""The port's copy of `bisinger_tpu/tools/db4_meta.py`.

DB-4 speech-corpus meta extraction: MFA TextGrids + f0 -> score meta.

Behavioural equivalent of the reference `utils/get_meta_db4{cn,en}_wdb.py`
(~620 LoC): for each utterance, read the MFA TextGrid's word + phone
interval tiers, estimate one MIDI note per word from the median voiced f0
over the word span, and emit a BiSinger meta item

  {item_name, txt, phs, ph_dur, notes, notes_dur, is_slur,
   word_boundary, lang}

with per-phone notes/notes_dur replicated from the owning word, is_slur
all zero (speech has no melisma), `<SP>` for silent gaps (note 0), and a
word boundary on each word's last phone.

f0 comes from `data.binarizer.extract_f0` (parselmouth when installed,
numpy autocorrelation otherwise; the reference uses parselmouth
per-word, `get_meta_db4cn_wdb.py`).

Usage:
  python -m bisinger_tpu_torch.tools.db4_meta wav_dir tg_dir out.json \
      --lang 1 --singer db4 --song cn
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from bisinger_tpu_torch.data.textgrid import parse_textgrid
from bisinger_tpu_torch.utils.pitch import freq_to_midi

_SIL_WORDS = {"", "sil", "sp", "spn", "<SP>", "<AP>", "silv"}


def _find_tier(tiers: List[Dict], names: Tuple[str, ...]) -> Optional[Dict]:
    for t in tiers:
        if t["name"].lower() in names:
            return t
    return None


def word_note_from_f0(
    f0: np.ndarray, xmin: float, xmax: float, frame_rate: float
) -> int:
    """Median voiced f0 over [xmin, xmax) -> MIDI note (0 when unvoiced)."""
    a = int(xmin * frame_rate)
    b = max(int(xmax * frame_rate), a + 1)
    seg = f0[a:b]
    voiced = seg[seg > 0]
    if len(voiced) == 0:
        return 0
    return freq_to_midi(float(np.median(voiced)))


def extract_item(
    tg_text: str,
    f0: np.ndarray,
    frame_rate: float,
    item_name: str,
    txt: str,
    lang: int,
) -> Dict:
    """One utterance's TextGrid + f0 track -> meta item."""
    tiers = parse_textgrid(tg_text)
    words_tier = _find_tier(tiers, ("words", "word")) or tiers[0]
    phones_tier = _find_tier(tiers, ("phones", "phone")) or tiers[-1]

    phs: List[str] = []
    ph_dur: List[float] = []
    notes: List[int] = []
    notes_dur: List[float] = []
    wdb: List[int] = []

    phone_items = [p for p in phones_tier["items"]]

    def phones_in(xmin: float, xmax: float) -> List[Dict]:
        eps = 1e-4
        return [
            p
            for p in phone_items
            if p["xmin"] >= xmin - eps and p["xmax"] <= xmax + eps
        ]

    for w in words_tier["items"]:
        w_dur = round(w["xmax"] - w["xmin"], 4)
        if w_dur <= 0:
            continue
        is_sil = w["text"].strip().lower() in _SIL_WORDS
        if is_sil:
            phs.append("<SP>")
            ph_dur.append(w_dur)
            notes.append(0)
            notes_dur.append(w_dur)
            wdb.append(1)
            continue
        note = word_note_from_f0(f0, w["xmin"], w["xmax"], frame_rate)
        w_phones = [p for p in phones_in(w["xmin"], w["xmax"]) if p["text"].strip()]
        if not w_phones:  # no aligned phones: treat as silence
            phs.append("<SP>")
            ph_dur.append(w_dur)
            notes.append(0)
            notes_dur.append(w_dur)
            wdb.append(1)
            continue
        for j, p in enumerate(w_phones):
            phs.append(p["text"] if p["text"] else "<SP>")
            ph_dur.append(round(p["xmax"] - p["xmin"], 4))
            notes.append(note)
            notes_dur.append(w_dur)
            wdb.append(1 if j == len(w_phones) - 1 else 0)

    n = len(phs)
    return {
        "item_name": item_name,
        "txt": txt,
        "phs": phs,
        "ph_dur": ph_dur,
        "notes": notes,
        "notes_dur": notes_dur,
        "is_slur": [0] * n,
        "word_boundary": wdb,
        "lang": lang,
    }


def extract_corpus(
    wav_dir: str,
    tg_dir: str,
    out_fn: str,
    lang: int = 1,
    singer: str = "db4",
    song: str = "cn",
    transcripts: Optional[Dict[str, str]] = None,
) -> int:
    """All `<id>.TextGrid` + `<id>.wav` pairs -> line-json meta file."""
    from bisinger_tpu_torch.config import make_hparams
    from bisinger_tpu_torch.data.binarizer import extract_f0, load_wav

    hp = make_hparams()
    frame_rate = hp["audio_sample_rate"] / hp["hop_size"]
    n = 0
    with open(out_fn, "w", encoding="utf-8") as fo:
        for fn in sorted(os.listdir(tg_dir)):
            if not fn.endswith(".TextGrid"):
                continue
            item_id = fn[: -len(".TextGrid")]
            wav_fn = os.path.join(wav_dir, item_id + ".wav")
            if not os.path.exists(wav_fn):
                continue
            wav = load_wav(wav_fn, hp["audio_sample_rate"])
            n_frames = len(wav) // hp["hop_size"] + 1
            f0 = extract_f0(wav, n_frames, hp)
            with open(os.path.join(tg_dir, fn)) as f:
                tg_text = f.read()
            item = extract_item(
                tg_text,
                f0,
                frame_rate,
                item_name=f"{singer}#{song}#{item_id}",
                txt=(transcripts or {}).get(item_id, ""),
                lang=lang,
            )
            json.dump(item, fo, ensure_ascii=False)
            fo.write("\n")
            n += 1
    return n


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("wav_dir")
    parser.add_argument("tg_dir")
    parser.add_argument("out_fn")
    parser.add_argument("--lang", type=int, default=1)
    parser.add_argument("--singer", default="db4")
    parser.add_argument("--song", default="cn")
    args = parser.parse_args(sys.argv[1:])
    count = extract_corpus(
        args.wav_dir, args.tg_dir, args.out_fn, args.lang, args.singer, args.song
    )
    print(f"| extracted {count} items -> {args.out_fn}")
