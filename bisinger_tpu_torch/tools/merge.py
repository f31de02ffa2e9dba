"""The port's copy of `bisinger_tpu/tools/merge.py`.

Merge per-corpus meta jsons with speechsing tags.

Behavioural equivalent of the reference `utils/merge_jsons.py:29-41`:
concatenate line-per-dict meta files and tag each item —
db4 speech = 0, db4 *-shift pseudo-singing = 2, everything else
(M4Singer) = 1.

Usage:
  python -m bisinger_tpu_torch.tools.merge out.json in1.json in2.json ...
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Iterable, List


def speechsing_tag(item_name: str) -> int:
    parts = item_name.split("#")
    singer, song = parts[0], parts[1] if len(parts) > 1 else ""
    if singer == "db4":
        return 2 if song.endswith("shift") else 0
    return 1


def merge_meta_jsons(in_fns: Iterable[str], out_fn: str) -> int:
    items: List[Dict] = []
    for fn in in_fns:
        with open(fn, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    items.append(json.loads(line))
    with open(out_fn, "w", encoding="utf-8") as f:
        for item in items:
            item["speechsing"] = speechsing_tag(item["item_name"])
            json.dump(item, f, ensure_ascii=False)
            f.write("\n")
    return len(items)


if __name__ == "__main__":
    out_fn, in_fns = sys.argv[1], sys.argv[2:]
    print(f"| merged {merge_meta_jsons(in_fns, out_fn)} items -> {out_fn}")
