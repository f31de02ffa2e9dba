"""The port's copy of `bisinger_tpu/tools/pitch_shift.py`.

Pitch-shift augmentation: speech -> pseudo-singing.

Behavioural equivalent of the reference `utils/pitch_shift.py:103-194`:
replace each word-level note window's f0 with a note from a common chord
progression (canon, 4536251, ...), rewrite the item's MIDI notes to the
new pitches, and rename the item `<singer>#<song>-shift#<id>`.

The audio path (WORLD analysis/synthesis, `pw.wav2world` +
`pw.synthesize`) is gated on pyworld being installed; the metadata path
(`shift_item_meta`) is dependency-free and is what the binarizer needs —
speechsing=2 items only require the rewritten notes plus the resynthesized
wav when building real corpora.

Usage:
  python -m bisinger_tpu_torch.tools.pitch_shift meta_in.json meta_out.json \
      [ori_wav_dir tgt_wav_dir]
"""

from __future__ import annotations

import json
import math
import random
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from bisinger_tpu_torch.utils.pitch import freq_to_midi

# C0..B0 base frequencies (reference note_to_freq tables)
_BASE_FREQ = {"C": 16.35, "D": 18.35, "E": 20.60, "F": 21.83, "G": 24.50, "A": 27.50, "B": 30.87}


def note_to_freq(note: str) -> float:
    """'C4' -> 261.6 (reference `note_to_freq`)."""
    return _BASE_FREQ[note[0]] * (2 ** int(note[1:]))


def num_to_freq(num: int, octave: int = 4) -> float:
    """Jianpu degree 1..7 (CDEFGAB) -> freq (reference `num_to_freq`)."""
    return note_to_freq("CDEFGAB"[num - 1] + str(octave))


def _prog(degrees: str) -> List[float]:
    return [num_to_freq(int(d), 4) for d in degrees]


# the reference's chord progressions (`pitch_shift.py:68-99`)
CANON = [523.25, 392.00, 440.00, 329.63, 349.23, 523.25, 293.66, 392.00]
CHORDS: List[List[float]] = [
    _prog("4536251"),
    _prog("456"),
    _prog("17654325"),
    _prog("1563451"),
    _prog("62514273"),
    _prog("63451"),
    _prog("1234567"),
    _prog("7654321"),
    _prog("6415"),
    CANON,
]


def group_notes(
    notes: Sequence, notes_dur: Sequence[float], ph_dur: Sequence[float]
) -> Tuple[List[float], List[int], List[int]]:
    """Collapse per-phone note annotations into unique note windows:
    -> (unique_note_dur, rep_count, sp_flags) (reference `:109-139` —
    a window closes when the running ph_dur sum matches notes_dur)."""
    unique_dur: List[float] = []
    rep_count: List[int] = []
    sp_flags: List[int] = []
    idx, length = 0, len(notes_dur)
    while idx < length:
        dur = notes_dur[idx]
        s, count = 0.0, 0
        closed = False
        for k in range(length - idx):
            s += ph_dur[idx + k]
            count += 1
            if math.isclose(s, dur, abs_tol=1e-3):
                unique_dur.append(dur)
                rep_count.append(count)
                sp_flags.append(1 if notes[idx] == 0 else 0)
                idx = idx + k + 1
                closed = True
                break
        if not closed:  # malformed annotation: close the window anyway
            unique_dur.append(dur)
            rep_count.append(count)
            sp_flags.append(1 if notes[idx] == 0 else 0)
            break
    return unique_dur, rep_count, sp_flags


def chord_f0_per_window(
    unique_dur: List[float], sp_flags: List[int], chord: List[float]
) -> List[float]:
    """Assign chord tones round-robin to voiced windows, 0 to SP windows
    (reference `:140-150`)."""
    new_f0: List[float] = []
    delta = 0
    for j in range(len(unique_dur)):
        if sp_flags[j] == 1:
            new_f0.append(0.0)
            delta += 1
        else:
            new_f0.append(chord[(j - delta) % len(chord)])
    return new_f0


def shift_item_meta(
    item: Dict, chord: Optional[List[float]] = None, rng: Optional[random.Random] = None
) -> Tuple[Dict, List[float], List[float]]:
    """Rewrite notes to chord MIDI and rename `<song>-shift`
    (reference `:178-193`). Returns (new_item, unique_note_dur, new_f0)
    so the audio path can reuse the windows."""
    rng = rng or random
    chord = chord if chord is not None else rng.choice(CHORDS)
    unique_dur, rep_count, sp_flags = group_notes(
        item["notes"], item["notes_dur"], item["ph_dur"]
    )
    new_f0 = chord_f0_per_window(unique_dur, sp_flags, chord)
    midis: List[int] = []
    for f, count in zip(new_f0, rep_count):
        midis += [0 if f == 0 else freq_to_midi(f)] * count
    if len(midis) != len(item["notes"]):
        raise ValueError(
            f"regrouped notes length {len(midis)} != original {len(item['notes'])}"
        )
    singer, song, item_id = item["item_name"].split("#")
    out = dict(item)
    out["notes"] = midis
    out["item_name"] = f"{singer}#{song}-shift#{item_id}"
    return out, unique_dur, new_f0


def shift_item_audio(
    wav: np.ndarray,
    sr: int,
    unique_dur: List[float],
    new_f0: List[float],
    frame_period: float = 5.0,
) -> np.ndarray:
    """WORLD resynthesis with the flat chord f0 (reference `:151-176`).
    Requires pyworld."""
    try:
        import pyworld as pw
    except ImportError as e:
        raise RuntimeError(
            "pyworld is not installed; only the metadata path "
            "(shift_item_meta) is available in this environment"
        ) from e
    x = np.ascontiguousarray(wav.astype(np.float64))
    f0, sp, ap = pw.wav2world(x, sr, frame_period=frame_period)
    fps = 1000.0 / frame_period
    shifted: List[float] = []
    for dur, f in zip(unique_dur, new_f0):
        shifted.extend([f] * int(dur * fps))
    if len(shifted) < len(f0):
        shifted.extend(f0[-(len(f0) - len(shifted)):])
    y = pw.synthesize(np.asarray(shifted[: len(f0)], np.float64), sp, ap, sr)
    y = y.astype(np.float32)
    return y / max(np.abs(y).max(), 1e-8)


def shift_meta_file(in_fn: str, out_fn: str, seed: int = 1234) -> int:
    rng = random.Random(seed)
    n = 0
    with open(in_fn, encoding="utf-8") as fi, open(out_fn, "w", encoding="utf-8") as fo:
        for line in fi:
            line = line.strip()
            if not line:
                continue
            item, _, _ = shift_item_meta(json.loads(line), rng=rng)
            json.dump(item, fo, ensure_ascii=False)
            fo.write("\n")
            n += 1
    return n


if __name__ == "__main__":
    in_fn, out_fn = sys.argv[1], sys.argv[2]
    print(f"| pitch-shifted {shift_meta_file(in_fn, out_fn)} items -> {out_fn}")
