"""The port's copy of `bisinger_tpu/data/textgrid.py`; only its imports differ.

Praat TextGrid parsing and TextGrid -> mel2ph alignment.

Behavioural port of the reference parser/aligner
(`train_bisinger/data_gen/tts/data_gen_utils.py:199-339`):

  - `parse_textgrid`: long-format TextGrid text -> list of IntervalTier
    dicts;
  - `textgrid_to_mel2ph`: align a phone list against the last tier's
    intervals (merging consecutive silences, matching phone text,
    tolerating sil-phoneme mismatches), producing the frame->phone map
    and per-phone durations.

Pure host-side Python/numpy.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

_SIL_TEXTS = {"sil", "sp", "", "SIL", "PUNC"}


def is_sil_phoneme(p: str) -> bool:
    return not p[:1].isalpha()


class _Lines:
    def __init__(self, text: List[str]):
        self.lines = [l.strip() for l in text if l.strip()]
        self.i = 0

    def extract(self, pattern: str, inc: int) -> str:
        m = re.match(pattern, self.lines[self.i])
        if m is None:
            raise ValueError(f"TextGrid format error at line {self.i}: {self.lines[self.i]!r}")
        self.i += inc
        return m.group(1)


def parse_textgrid(text: str) -> List[Dict]:
    """TextGrid (long format) -> [{name, items: [{xmin, xmax, text}]}]."""
    ls = _Lines(text.splitlines())
    ls.extract(r"File type = \"(.*)\"", 2)
    ls.extract(r"xmin = (.*)", 1)
    ls.extract(r"xmax = (.*)", 2)
    size = int(ls.extract(r"size = (.*)", 2))
    tiers = []
    for _ in range(size):
        ls.extract(r"item \[(.*)\]:", 1)
        tier_class = ls.extract(r"class = \"(.*)\"", 1)
        if tier_class != "IntervalTier":
            raise NotImplementedError("only IntervalTier supported")
        name = ls.extract(r"name = \"(.*)\"", 1)
        ls.extract(r"xmin = (.*)", 1)
        ls.extract(r"xmax = (.*)", 1)
        n = int(ls.extract(r"intervals: size = (.*)", 1))
        items = []
        for _ in range(n):
            ls.extract(r"intervals \[(.*)\]", 1)
            xmin = float(ls.extract(r"xmin = (.*)", 1))
            xmax = float(ls.extract(r"xmax = (.*)", 1))
            txt = ls.extract(r"text = \"(.*)\"", 1)
            items.append({"xmin": xmin, "xmax": xmax, "text": txt})
        tiers.append({"name": name, "items": items})
    return tiers


def textgrid_to_mel2ph(
    tg_text: str, ph: str, n_frames: int, hop_size: int, sample_rate: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Align phones to the last TextGrid tier -> (mel2ph [n_frames],
    dur [n_phones]). Mirrors `get_mel2ph` (`data_gen_utils.py:276-339`)."""
    ph_list = ph.split(" ")
    tiers = parse_textgrid(tg_text)
    tg_align: List[Dict] = []
    for x in tiers[-1]["items"]:
        x = dict(x)
        if x["text"] in _SIL_TEXTS:
            x["text"] = ""
            if tg_align and tg_align[-1]["text"] == "":
                tg_align[-1]["xmax"] = x["xmax"]
                continue
        tg_align.append(x)
    tg_len = len([x for x in tg_align if x["text"] != ""])
    ph_len = len([p for p in ph_list if not is_sil_phoneme(p)])
    assert tg_len == ph_len, (tg_len, ph_len)

    split = np.full(len(ph_list) + 1, -1.0)
    tg_idx = ph_idx = 0
    while tg_idx < len(tg_align) or ph_idx < len(ph_list):
        if tg_idx == len(tg_align) and is_sil_phoneme(ph_list[ph_idx]):
            split[ph_idx] = 1e8
            ph_idx += 1
            continue
        x = tg_align[tg_idx]
        if x["text"] == "" and ph_idx == len(ph_list):
            tg_idx += 1
            continue
        p = ph_list[ph_idx]
        if x["text"] == "" and not is_sil_phoneme(p):
            raise ValueError(f"unaligned phone {p!r} vs silence interval")
        if x["text"] != "" and is_sil_phoneme(p):
            ph_idx += 1
        else:
            # stale/mispaired TextGrids must fail, not align positionally
            # (reference asserts interval text == phone,
            # `data_gen_utils.py` get_mel2ph else-branch)
            if x["text"] != "" and x["text"].lower() != p.lower():
                raise ValueError(
                    f"TextGrid/phone mismatch at interval {tg_idx}: "
                    f"{x['text']!r} vs phone {p!r}"
                )
            split[ph_idx] = x["xmin"]
            if ph_idx > 0 and split[ph_idx - 1] == -1 and is_sil_phoneme(ph_list[ph_idx - 1]):
                split[ph_idx - 1] = split[ph_idx]
            ph_idx += 1
            tg_idx += 1
    split[0] = 0.0
    split[-1] = 1e8
    assert (split[:-1] != -1).all() and (np.diff(split) >= 0).all(), split
    frames = [int(s * sample_rate / hop_size + 0.5) for s in split]
    mel2ph = np.zeros(n_frames, dtype=np.int64)
    for i in range(len(ph_list)):
        mel2ph[frames[i] : frames[i + 1]] = i + 1
    dur = np.bincount(mel2ph, minlength=len(ph_list) + 1)[1:]
    return mel2ph, dur


def fix_zh_durations(
    mel2ph: np.ndarray, ph_list: List[str], f0: Optional[np.ndarray] = None
) -> np.ndarray:
    """Chinese duration fixing (reference `ZhBinarizer.get_align`,
    `data_gen/tts/binarizer_zh.py:24-50`), two passes over per-phone
    durations:

      1. separator phones (first char neither '<' nor alphabetic): their
         leading VOICED frames (f0 != 0) move to the preceding yunmu;
         separators left shorter than 100 frames merge entirely;
      2. each (shengmu, yunmu) pair is equalized to half of its total.

    ONLY for corpora whose phones are raw pinyin shengmu/yunmu (the
    reference ZhBinarizer operates downstream of the zh_g2pM processor).
    CMU-phone corpora — including BiSinger's unified bilingual set —
    must not enable this: single-letter CMU consonants ('B', 'D', ...)
    collide with pinyin initials, so the gate below additionally
    requires the yunmu to be a pinyin final, and callers should gate on
    the item's language.
    """
    from bisinger_tpu_torch.data.text.pinyin import INITIALS

    n_frames = len(mel2ph)
    n_ph = len(ph_list)
    dur = np.bincount(mel2ph, minlength=n_ph + 1)[1 : n_ph + 1].astype(np.int64)
    dur_cumsum = np.pad(np.cumsum(dur), [1, 0])
    for i in range(n_ph):
        p = ph_list[i]
        if p and p[0] != "<" and not p[0].isalpha() and i > 0:
            if f0 is not None:
                uv = f0[dur_cumsum[i] : dur_cumsum[i + 1]] == 0
                j = 0
                while j < len(uv) and not uv[j]:
                    j += 1
                dur[i - 1] += j
                dur[i] -= j
            if dur[i] < 100:
                dur[i - 1] += dur[i]
                dur[i] = 0
    from bisinger_tpu_torch.data.text.pinyin import FINALS

    shenmu = set(INITIALS.keys())
    finals = set(FINALS.keys())
    for i in range(n_ph - 1):
        # require a true pinyin (shengmu, yunmu) pair: English CMU phones
        # like 'B'+'IY1' must NOT be equalized (bilingual corpora)
        if ph_list[i].lower() in shenmu and ph_list[i + 1].lower() in finals:
            if dur[i] > 0:
                total = dur[i] + dur[i + 1]
                dur[i] = total // 2
                dur[i + 1] = total - dur[i]
    out = np.zeros(n_frames, dtype=np.int64)
    pos = 0
    for i in range(n_ph):
        out[pos : pos + dur[i]] = i + 1
        pos += dur[i]
    return out
