"""The port's copy of `bisinger_tpu/tools/proportional.py`.

MFA-proportional duration split for M4Singer meta.

Behavioural counterpart of the reference `utils/get_meta_m4_proportional.py`
(the 851-LoC "system 3" data recipe): instead of splitting each yunmu
(pinyin final) duration evenly across its CMU phones (`tools/meta.py`),
split it in the RATIOS the MFA forced aligner assigned to those CMU
phones, and redistribute a slurred yunmu's notes across the CMU phones
at the proportional time boundaries.

Inputs per utterance:
  - the original M4Singer meta item (pinyin phs / ph_dur / notes /
    notes_dur / is_slur);
  - the M4Singer TextGrid (word tier + pinyin initial/final phone tier);
  - the MFA output TextGrid (word tier + CMU phone tier).

Differences from the reference (documented, deliberate):
  - the note-boundary splitting is one generalized n-segment walk instead
    of hard-coded 1/2/3-CMU-phone cases (identical arithmetic — verified
    by `tests/test_proportional.py` against hand-computed reference
    traces);
  - the output `words` field joins the MFA word tier's pinyin instead of
    re-deriving pypinyin from `txt` (pypinyin is not a dependency here;
    the MFA tier carries the same pinyin).

Usage:
  python -m bisinger_tpu_torch.tools.proportional in_meta.json out_meta.json \
      --m4-tg-dir RAW --mfa-tg-dir ALIGNED
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from bisinger_tpu_torch.data.text.pinyin import INITIALS, split_pinyin
from bisinger_tpu_torch.data.textgrid import parse_textgrid
from bisinger_tpu_torch.tools.meta import slur_runs

_SIL = ("", "<SP>", "<AP>", "sil", "sp", "spn")


def _is_sil(mark: str) -> bool:
    return mark in _SIL


def tier_word_phones(
    tg_text: str,
) -> Tuple[List[str], List[str], List[List[int]], List[float]]:
    """Parsed TextGrid -> (word marks, phone marks, per-word phone index
    list by time containment, phone durations). Reference
    `word_phone_from_tg` (`get_meta_m4_proportional.py:151-177`)."""
    tiers = parse_textgrid(tg_text)
    words = tiers[0]["items"]
    phones = tiers[1]["items"]
    ph_marks = [p["text"] for p in phones]
    ph_durs = [round(p["xmax"] - p["xmin"], 4) for p in phones]
    mapping: List[List[int]] = []
    eps = 1e-4
    for w in words:
        mapping.append(
            [
                j
                for j, p in enumerate(phones)
                if p["xmin"] >= w["xmin"] - eps and p["xmax"] <= w["xmax"] + eps
            ]
        )
    return [w["text"] for w in words], ph_marks, mapping, ph_durs


def align_words(m4_marks: Sequence[str], mfa_marks: Sequence[str]) -> List[Optional[int]]:
    """Map each M4 word-tier interval to its MFA word-tier interval
    (None for silences); non-silence words pair up in order (reference
    `word_align_from_tgs`). Raises if the word counts disagree."""
    mfa_idxes = [i for i, m in enumerate(mfa_marks) if not _is_sil(m)]
    n_m4 = sum(not _is_sil(m) for m in m4_marks)
    if n_m4 != len(mfa_idxes):
        raise ValueError(
            f"word count mismatch: {n_m4} in M4 tier vs {len(mfa_idxes)} in MFA tier"
        )
    out: List[Optional[int]] = []
    k = 0
    for m in m4_marks:
        if _is_sil(m):
            out.append(None)
        else:
            out.append(mfa_idxes[k])
            k += 1
    return out


def split_time(mfa_durs: Sequence[float], total: float) -> List[float]:
    """Distribute `total` across segments proportionally to `mfa_durs`,
    4-decimal rounding with the last segment absorbing the residual
    (reference `split_time`)."""
    s = sum(mfa_durs) or 1.0
    out = [round(d / s * total, 4) for d in mfa_durs]
    out[-1] = round(total - sum(out[:-1]), 4)
    return out


def locate_boundary(target: float, note_durs: Sequence[float]) -> Tuple[int, float]:
    """(note index, fraction of that note consumed) where cumulative
    note time first reaches `target` (reference
    `locate_idx_percent_note`)."""
    cur = 0.0
    for idx, d in enumerate(note_durs):
        cur += d
        if cur >= target:
            return idx, 1.0 - (cur - target) / d
    return len(note_durs) - 1, 1.0


Row = Tuple[str, float, int, float, int, int]  # ph, dur, note, note_dur, slur, wdb


def split_final_rows(
    cmu_phs: Sequence[str],
    cmu_durs: Sequence[float],
    note_durs: Sequence[float],
    notes: Sequence[int],
    notes_dur: Sequence[float],
) -> List[Row]:
    """Distribute a yunmu's slur-note group across its CMU phones.

    `cmu_durs` are the proportional targets (already `split_time`d to sum
    to the group total). Each CMU phone becomes one segment; a segment
    emits one row per note it covers, splitting the duration of a note
    that straddles a segment boundary. Generalizes the reference's
    per-arity branches (`convert`, cases 1.1.2/1.1.3.1-3)."""
    n = len(cmu_phs)
    if len(note_durs) == 1:
        # no slur: one row per CMU phone, the single note replicated
        return [
            (ph, d, notes[0], notes_dur[0], 0, 0)
            for ph, d in zip(cmu_phs, cmu_durs)
        ]
    if n == 1:
        # one CMU phone over several slurred notes: keep the per-note
        # durations, mark continuations as slur
        return [
            (cmu_phs[0], d, nt, nd, int(i > 0), 0)
            for i, (d, nt, nd) in enumerate(zip(note_durs, notes, notes_dur))
        ]
    # boundaries between consecutive CMU phones, located on the note grid
    bounds = [(0, 0.0)]
    acc = 0.0
    for d in cmu_durs[:-1]:
        acc += d
        bounds.append(locate_boundary(acc, note_durs))
    bounds.append((len(note_durs) - 1, 1.0))
    rows: List[Row] = []
    for k in range(n):
        (i0, p0), (i1, p1) = bounds[k], bounds[k + 1]
        if i0 == i1:
            durs = [round((p1 - p0) * note_durs[i0], 4)]
        else:
            durs = (
                [round((1.0 - p0) * note_durs[i0], 4)]
                + [note_durs[j] for j in range(i0 + 1, i1)]
                + [round(p1 * note_durs[i1], 4)]
            )
        seg_notes = notes[i0 : i1 + 1]
        seg_ndurs = notes_dur[i0 : i1 + 1]
        for j, (d, nt, nd) in enumerate(zip(durs, seg_notes, seg_ndurs)):
            rows.append((cmu_phs[k], d, nt, nd, int(j > 0), 0))
    return rows


def _initial_cmu_count(m4_phone: str) -> int:
    """CMU phones the pinyin initial maps to (c -> T S is the only
    2-phone initial)."""
    return len(INITIALS.get(m4_phone, [None]))


def convert_item_proportional(
    item: Dict, m4_tg_text: str, mfa_tg_text: str
) -> Dict:
    """One meta item + its two TextGrids -> CMU-phone item with
    MFA-proportional durations (reference `convert` + `pipeline` body)."""
    m4_marks, m4_phs, m4_word_ph, _ = tier_word_phones(m4_tg_text)
    mfa_marks, mfa_phs, mfa_word_ph, mfa_ph_durs = tier_word_phones(mfa_tg_text)
    word_map = align_words(m4_marks, mfa_marks)

    # slur-group the meta rows: group i corresponds to M4 phone-tier
    # interval i (the meta is the tg phones expanded by slur)
    groups = slur_runs(item["is_slur"])
    if len(groups) != len(m4_phs):
        raise ValueError(
            f"{item['item_name']}: {len(groups)} slur groups vs "
            f"{len(m4_phs)} phones in the M4 TextGrid"
        )
    g_dur = [[item["ph_dur"][i] for i in g] for g in groups]
    g_notes = [[item["notes"][i] for i in g] for g in groups]
    g_ndur = [[item["notes_dur"][i] for i in g] for g in groups]

    rows: List[Row] = []
    for w_idx, mfa_idx in enumerate(word_map):
        ph_idx = m4_word_ph[w_idx]
        if not ph_idx:
            continue
        if mfa_idx is None:  # silence interval
            g = ph_idx[0]
            for j, (d, nt, nd) in enumerate(zip(g_dur[g], g_notes[g], g_ndur[g])):
                rows.append((m4_phs[g], d, nt, nd, int(j > 0), 0))
            # any silence except the sentence-initial one ends a "word"
            if w_idx != 0:
                rows[-1] = rows[-1][:5] + (1,)
            continue
        mfa_ph_idx = mfa_word_ph[mfa_idx]
        word_cmu = [mfa_phs[i] for i in mfa_ph_idx]
        word_cmu_durs = [mfa_ph_durs[i] for i in mfa_ph_idx]
        if len(ph_idx) > 2:
            # a pinyin word is at most initial+final groups; 3+ groups
            # would silently drop the leading groups' notes/durations —
            # raise like the sibling checks so the item routes to the
            # skip-and-report path
            raise ValueError(
                f"{item['item_name']}: word {m4_marks[w_idx]!r} has "
                f"{len(ph_idx)} phone groups (expected <= 2: "
                f"{[m4_phs[g] for g in ph_idx]})"
            )
        has_initial = len(ph_idx) == 2
        if has_initial:
            ini_g = ph_idx[0]
            n_ini = _initial_cmu_count(m4_phs[ini_g])
            ini_cmu = word_cmu[:n_ini]
            ini_durs = split_time(word_cmu_durs[:n_ini], sum(g_dur[ini_g]))
            for ph, d in zip(ini_cmu, ini_durs):
                rows.append((ph, d, g_notes[ini_g][0], g_ndur[ini_g][0], 0, 0))
        else:
            n_ini = 0
        fin_g = ph_idx[-1]
        fin_cmu = word_cmu[n_ini:]
        if not fin_cmu:
            raise ValueError(
                f"{item['item_name']}: no CMU phones left for final "
                f"{m4_phs[fin_g]!r} in word {m4_marks[w_idx]!r}"
            )
        fin_durs = split_time(word_cmu_durs[n_ini:], sum(g_dur[fin_g]))
        rows.extend(
            split_final_rows(
                fin_cmu, fin_durs, g_dur[fin_g], g_notes[fin_g], g_ndur[fin_g]
            )
        )
        rows[-1] = rows[-1][:5] + (1,)  # word boundary on the final's last row

    phs, ph_dur, notes, notes_dur, is_slur, wdb = (
        [list(col) for col in zip(*rows)] if rows else ([], [], [], [], [], [])
    )
    return {
        "lang": 1,
        "item_name": item["item_name"],
        "txt": item.get("txt", ""),
        "words": " ".join(m for m in mfa_marks if not _is_sil(m)),
        "phs": phs,
        "is_slur": is_slur,
        "ph_dur": ph_dur,
        "notes": notes,
        "notes_dur": notes_dur,
        "word_boundary": wdb,
    }


def pipeline(
    ori_meta_fn: str,
    tgt_meta_fn: str,
    m4_tg_dir: str,
    mfa_tg_dir: str,
    strict: bool = False,
) -> Tuple[int, int]:
    """Line-json meta -> proportional meta; TextGrid layout follows the
    reference (`{m4}/{singer}#{song}/{id}.TextGrid`,
    `{mfa}/{singer}/{song}#{id}.TextGrid`). Returns (ok, failed)."""
    ok = failed = 0
    with open(ori_meta_fn, encoding="utf-8") as f, open(
        tgt_meta_fn, "w", encoding="utf-8"
    ) as out:
        for line in f:
            line = line.strip()
            if not line:
                continue
            item = json.loads(line)
            singer, song, sent = item["item_name"].split("#")
            m4_fn = os.path.join(m4_tg_dir, f"{singer}#{song}", f"{sent}.TextGrid")
            mfa_fn = os.path.join(mfa_tg_dir, singer, f"{song}#{sent}.TextGrid")
            try:
                with open(m4_fn, encoding="utf-8") as g:
                    m4_text = g.read()
                with open(mfa_fn, encoding="utf-8") as g:
                    mfa_text = g.read()
                info = convert_item_proportional(item, m4_text, mfa_text)
            except Exception as e:  # noqa: BLE001 — skip-and-report per item
                if strict:
                    raise
                print(f"[proportional] skip {item['item_name']}: {e}")
                failed += 1
                continue
            out.write(json.dumps(info, ensure_ascii=False) + "\n")
            ok += 1
    return ok, failed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("in_meta")
    ap.add_argument("out_meta")
    ap.add_argument("--m4-tg-dir", required=True)
    ap.add_argument("--mfa-tg-dir", required=True)
    ap.add_argument("--strict", action="store_true")
    a = ap.parse_args(argv)
    ok, failed = pipeline(a.in_meta, a.out_meta, a.m4_tg_dir, a.mfa_tg_dir, a.strict)
    print(f"[proportional] {ok} items written, {failed} skipped")


if __name__ == "__main__":
    main()
