"""The port's copy of `bisinger_tpu/tools/meta.py`.

M4Singer meta.json -> BiSinger CMU-phone meta (averaged split).

Behavioural equivalent of the reference `utils/get_meta_m4_avg.py`:
each pinyin phone of the original M4Singer annotation expands to its CMU
phones (via `data.text.pinyin`), the phone duration is split evenly
across them, per-phone notes/notes_dur/is_slur replicate, and word
boundaries land on the last CMU phone of each yunmu — with slur runs
merged into a single word (reference `slur_json_tg` + wdb fixup,
`get_meta_m4_avg.py:72-132`).

The proportional variant (`get_meta_m4_proportional.py`) redistributes
durations by MFA alignment ratios instead; `split_ratios` hooks that in.

Usage:
  python -m bisinger_tpu_torch.tools.meta in_meta.json out_meta.json
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Sequence

from bisinger_tpu_torch.data.text.pinyin import FINALS, pinyin_to_cmu

_SPECIALS = ("<SP>", "<AP>")
ALL_YUNMU = sorted(FINALS.keys())


def slur_runs(is_slur: Sequence[int]) -> List[List[int]]:
    """Group indices so each slur continuation joins its onset
    (reference `slur_json_tg`)."""
    out: List[List[int]] = []
    cur: List[int] = []
    for idx, val in enumerate(is_slur):
        if val == 1:
            cur.append(idx)
            continue
        if cur:
            out.append(cur)
            cur = []
        cur.append(idx)
    if cur:
        out.append(cur)
    return out


def _expand_phone(ph: str, py2cmu: Optional[Dict[str, List[str]]]) -> List[str]:
    if ph in _SPECIALS:
        return [ph]
    if py2cmu is not None:
        return list(py2cmu.get(ph.lower(), [ph]))
    # M4Singer phs are SEPARATE shengmu/yunmu entries ('zh', 'ang', 'c',
    # 'ai'), not whole syllables — map standalone initials and finals
    # directly (pinyin_to_cmu handles only full syllables and would pass
    # 'zh'/'c' through unconverted)
    from bisinger_tpu_torch.data.text.pinyin import FINALS, INITIALS

    low = ph.lower()
    if low in INITIALS:
        return list(INITIALS[low])
    if low in FINALS:
        return list(FINALS[low])
    try:
        return pinyin_to_cmu(ph)
    except Exception:
        return [ph]  # already a phone (or unknown) — pass through


def convert_m4_item(
    item: Dict,
    py2cmu: Optional[Dict[str, List[str]]] = None,
    split_ratios: Optional[Dict[str, List[float]]] = None,
) -> Dict:
    """One M4Singer item {phs(pinyin), ph_dur, notes, notes_dur, is_slur}
    -> BiSinger CMU item with lang=1 and word_boundary."""
    phs_t = [_expand_phone(ph, py2cmu) for ph in item["phs"]]
    out_phs: List[str] = []
    out_slur: List[int] = []
    out_notes: List = []
    out_ndur: List[float] = []
    out_pdur: List[float] = []
    for i, cmu in enumerate(phs_t):
        n = len(cmu)
        out_phs += cmu
        out_slur += [item["is_slur"][i]] * n
        out_notes += [item["notes"][i]] * n
        out_ndur += [item["notes_dur"][i]] * n
        ratios = (split_ratios or {}).get(item["phs"][i].lower())
        if ratios and len(ratios) == n:
            s = sum(ratios)
            out_pdur += [round(item["ph_dur"][i] * r / s, 4) for r in ratios]
        else:
            out_pdur += [round(item["ph_dur"][i] / n, 4)] * n

    # word boundary: yunmu/special phones end a word, except sentence start
    phs = item["phs"]
    def _ends_word(i: int) -> int:
        if i == len(phs) - 1:
            return 1
        if 0 < i and (phs[i].lower() in ALL_YUNMU or phs[i] in _SPECIALS):
            return 1
        return 0

    pinyin_wdb = [_ends_word(i) for i in range(len(phs))]
    wdb_t: List[List[int]] = []
    for idx, flag in enumerate(pinyin_wdb):
        n = len(phs_t[idx])
        wdb_t.append([0] * n if flag == 0 else [0] * (n - 1) + [1])
    # slur run -> one word: boundary only on the run's last phone
    for run in slur_runs(item["is_slur"]):
        if len(run) > 1:
            for idx in run:
                wdb_t[idx] = [0] * len(wdb_t[idx])
            wdb_t[run[-1]][-1] = 1
    out_wdb = [b for w in wdb_t for b in w]

    return {
        "lang": 1,
        "item_name": item["item_name"],
        "txt": item["txt"],
        "words": item.get("words", item["txt"]),
        "phs": out_phs,
        "is_slur": out_slur,
        "ph_dur": out_pdur,
        "notes": out_notes,
        "notes_dur": out_ndur,
        "word_boundary": out_wdb,
    }


def convert_m4_meta(
    in_fn: str, out_fn: str, py2cmu: Optional[Dict[str, List[str]]] = None
) -> int:
    with open(in_fn, encoding="utf-8") as f:
        items = json.load(f)
    n = 0
    with open(out_fn, "w", encoding="utf-8") as f:
        for item in items:
            json.dump(convert_m4_item(item, py2cmu), f, ensure_ascii=False)
            f.write("\n")
            n += 1
    return n


def load_py2cmu_map(path: str) -> Dict[str, List[str]]:
    """Parse an `assets/pinyin_cmu_map.txt`-style table."""
    out: Dict[str, List[str]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0].lower()] = parts[1:]
    out["<ap>"] = ["<AP>"]
    out["<sp>"] = ["<SP>"]
    return out


_TG_SIL = {"", "sil", "sp", "spn", "<sp>", "<ap>", "pau"}


def _tg_is_sil(text: str) -> bool:
    return text.strip().lower() in _TG_SIL


def adjust_item_durations(item: Dict, tg_text: str) -> Dict:
    """Reconcile an item's ph_dur with its MFA TextGrid (reference
    `utils/adjust_m4_ori_meta.py`): each phone's duration becomes its
    aligned interval, pairing silences EXPLICITLY — a TextGrid silence
    interval maps onto the item's next <SP>/<AP> phone when one is
    there, is INSERTED as a new <SP> (notes 'rest') when the item lacks
    it (the reference's full_json_item_according_sil), and an item
    silence with no interval is dropped (MFA merged it). Irreconcilable
    speech-phone mismatches return the item unchanged with a warning."""
    from bisinger_tpu_torch.data.textgrid import is_sil_phoneme, parse_textgrid

    tiers = parse_textgrid(tg_text)
    intervals = [
        x for x in tiers[-1]["items"] if round(x["xmax"] - x["xmin"], 6) > 0
    ]
    phs = item["phs"]
    n = len(phs)
    # original M4 meta always carries these; tolerate reduced test metas
    notes = item.get("notes", ["rest"] * n)
    ndur = item.get("notes_dur", list(item["ph_dur"]))
    slur = item.get("is_slur", [0] * n)
    out_phs, out_dur, out_notes, out_ndur, out_slur = [], [], [], [], []
    pi = 0
    ok = True
    for x in intervals:
        dur = round(x["xmax"] - x["xmin"], 4)
        if _tg_is_sil(x["text"]):
            if pi < n and is_sil_phoneme(phs[pi]):
                out_phs.append(phs[pi])
                out_notes.append(notes[pi])
                out_ndur.append(dur)
                out_slur.append(slur[pi])
                pi += 1
            else:
                out_phs.append("<SP>")
                out_notes.append("rest")
                out_ndur.append(dur)
                out_slur.append(0)
            out_dur.append(dur)
        else:
            while pi < n and is_sil_phoneme(phs[pi]):
                pi += 1  # item silence MFA merged away
            if pi >= n:
                ok = False
                break
            out_phs.append(phs[pi])
            out_notes.append(notes[pi])
            out_ndur.append(ndur[pi])
            out_slur.append(slur[pi])
            out_dur.append(dur)
            pi += 1
    while ok and pi < n and is_sil_phoneme(phs[pi]):
        pi += 1
    if not ok or pi != n:
        print(
            f"| adjust: {item.get('item_name')}: speech phones do not "
            f"reconcile with the TextGrid ({n} phones vs "
            f"{len(intervals)} intervals); left unchanged"
        )
        return item
    out = dict(item)
    out["phs"] = out_phs
    out["ph_dur"] = out_dur
    if "notes" in item:
        out["notes"] = out_notes
    if "notes_dur" in item:
        out["notes_dur"] = out_ndur
    if "is_slur" in item:
        out["is_slur"] = out_slur
    return out


def adjust_meta_file(meta_fn: str, tg_dir: str, out_fn: str) -> int:
    """Line-json meta + `<id>.TextGrid` per item -> adjusted meta."""
    import os

    n = 0
    with open(meta_fn, encoding="utf-8") as fi, open(out_fn, "w", encoding="utf-8") as fo:
        for line in fi:
            line = line.strip()
            if not line:
                continue
            item = json.loads(line)
            parts = item["item_name"].split("#")
            # reference layout: {singer}#{song}/{sent}.TextGrid — sentence
            # ids repeat across songs, so the bare-id flat path is only a
            # last-resort fallback
            cands = []
            if len(parts) == 3:
                cands.append(
                    os.path.join(
                        tg_dir, f"{parts[0]}#{parts[1]}", parts[2] + ".TextGrid"
                    )
                )
            cands.append(os.path.join(tg_dir, item["item_name"] + ".TextGrid"))
            cands.append(os.path.join(tg_dir, parts[-1] + ".TextGrid"))
            tg_fn = next((c for c in cands if os.path.exists(c)), None)
            if tg_fn == cands[-1] and len(parts) > 1:
                print(
                    f"| adjust: WARNING {item['item_name']}: using flat "
                    f"{tg_fn} — bare sentence ids repeat across songs; "
                    "prefer the {singer}#{song}/ layout",
                )
            if tg_fn is not None:
                with open(tg_fn, encoding="utf-8") as f:
                    item = adjust_item_durations(item, f.read())
            json.dump(item, fo, ensure_ascii=False)
            fo.write("\n")
            n += 1
    return n


if __name__ == "__main__":
    in_fn, out_fn = sys.argv[1], sys.argv[2]
    py2cmu = load_py2cmu_map(sys.argv[3]) if len(sys.argv) > 3 else None
    print(f"| converted {convert_m4_meta(in_fn, out_fn, py2cmu)} items -> {out_fn}")
