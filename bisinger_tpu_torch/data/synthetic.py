"""Synthetic singing corpus generator (the port's copy of
`bisinger_tpu/data/synthetic.py`: the same seed writes the same meta.json
and the same wav bytes).

The build environment has no real corpus (M4Singer/DB-4 are external), so
tests, benchmarks, and the end-to-end training demo use a deterministic
synthetic corpus in exactly the BiSinger `raw_json_fn` metadata format
(reference `train_bisinger/data_gen/singing/binarize.py:321-358`):
harmonic-rich note sequences with per-phone durations, MIDI notes, slur
flags, word boundaries, language ids and speech/singing style — rendered
to real wav files so the whole binarize -> train -> infer path runs.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from bisinger_tpu_torch.utils.audio import save_wav

_CN_PHONES = ["sh", "ang", "x", "in", "h", "ao", "m", "a", "l", "i"]
_EN_PHONES = ["HH", "AH", "L", "OW", "W", "ER", "D", "S", "IY", "NG"]
_SIL = "<SP>"


def midi_to_hz(m: np.ndarray) -> np.ndarray:
    return 440.0 * 2.0 ** ((np.asarray(m, dtype=np.float64) - 69.0) / 12.0)


def render_notes(
    notes: List[int], durs: List[float], sample_rate: int, rng: np.random.RandomState
) -> np.ndarray:
    """Render a note sequence as a harmonic tone with vibrato + noise —
    enough spectral structure for mel/f0 extraction to behave like voice."""
    total = int(round(sum(durs) * sample_rate))
    f0 = np.zeros(total)
    pos = 0
    for note, dur in zip(notes, durs):
        n = int(round(dur * sample_rate))
        if note > 0:
            f0[pos : pos + n] = midi_to_hz(note)
        pos += n
    t = np.arange(total) / sample_rate
    vibrato = 1.0 + 0.005 * np.sin(2 * np.pi * 5.5 * t)
    phase = 2 * np.pi * np.cumsum(f0 * vibrato) / sample_rate
    voiced = (f0 > 0).astype(np.float64)
    wav = np.zeros(total)
    for k, amp in enumerate([0.5, 0.25, 0.12, 0.08, 0.05]):
        wav += amp * np.sin((k + 1) * phase)
    wav = wav * voiced + 0.01 * rng.randn(total)
    # amplitude envelope to avoid clicks
    env = np.minimum(1.0, np.minimum(np.arange(total), total - np.arange(total)) / 800.0)
    return (wav * env * 0.6).astype(np.float32)


def make_synthetic_corpus(
    root: str,
    n_items: int = 16,
    seed: int = 0,
    sample_rate: int = 24000,
    json_fn: str = "meta.json",
    singers: Optional[List[str]] = None,
    fmt: str = "bisinger",
):
    """Write wavs + metadata json under `root`. Returns the json path.

    fmt:
      - "bisinger" (default): json-lines BiSinger meta with
        word_boundary / lang / speechsing fields;
      - "m4_original": json-lines in the *original* monolingual M4Singer
        layout — pinyin phones only, NO word_boundary / lang / speechsing
        (reference `train_m4singer/binarize.py:303-332`);
      - "popcs": a JSON list with explicit wav_fn per item (reference
        `MidiSingingBinarizer.load_meta_data`, `binarize.py:191-218`).
    """
    rng = np.random.RandomState(seed)
    singers = singers or ["Alto-1", "Tenor-1"]
    os.makedirs(root, exist_ok=True)
    lines = []
    for i in range(n_items):
        singer = singers[i % len(singers)]
        song = f"song{i % 3}"
        sent = f"{i:04d}"
        lang_id = i % 2 if fmt == "bisinger" else 0
        phones = _EN_PHONES if lang_id else _CN_PHONES
        n_ph = rng.randint(6, 12)
        phs, ph_dur, notes, notes_dur, is_slur, wdb = [], [], [], [], [], []
        note = int(rng.randint(55, 70))
        for j in range(n_ph):
            if j % 5 == 4:
                phs.append(_SIL)
                notes.append(0)
            else:
                phs.append(phones[rng.randint(len(phones))])
                note = int(np.clip(note + rng.randint(-3, 4), 50, 75))
                notes.append(note)
            d = float(rng.uniform(0.08, 0.35))
            ph_dur.append(round(d, 4))
            notes_dur.append(round(d, 4))
            is_slur.append(int(rng.rand() < 0.1 and j > 0))
            wdb.append(int(j % 2 == 1))
        item_name = f"{singer}#{song}#{sent}"
        wav_dir = os.path.join(root, f"{singer}#{song}")
        os.makedirs(wav_dir, exist_ok=True)
        wav = render_notes(notes, ph_dur, sample_rate, rng)
        wav_fn = os.path.join(wav_dir, f"{sent}.wav")
        save_wav(wav, wav_fn, sample_rate)
        item = {
            "item_name": item_name,
            "txt": "la " * n_ph,
            "phs": phs,
            "ph_dur": ph_dur,
            "notes": notes,
            "notes_dur": notes_dur,
            "is_slur": is_slur,
        }
        if fmt == "bisinger":
            item.update(
                word_boundary=wdb,
                lang=lang_id,
                speechsing=i % 3 if i % 7 == 0 else 1,
            )
        elif fmt == "popcs":
            item["wav_fn"] = wav_fn
        lines.append(item)
    path = os.path.join(root, json_fn)
    with open(path, "w", encoding="utf-8") as f:
        if fmt == "popcs":
            json.dump(lines, f, ensure_ascii=False)
        else:
            for line in lines:
                f.write(json.dumps(line, ensure_ascii=False) + "\n")
    return path
