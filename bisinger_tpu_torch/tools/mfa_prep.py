"""The port's copy of `bisinger_tpu/tools/mfa_prep.py`.

MFA corpus preparation: pair wavs with transcript .lab files.

Counterpart of the reference's shell/py MFA prep
(`utils/get_pairs_db4.sh`, `get_input_db4.sh`, `get_pairs_m4singer.py`;
procedure in `doc/align_with_MFA.md:62-110`): MFA expects a corpus
directory of `<utt>.wav` + `<utt>.lab` pairs (the .lab holding the
transcript whose words exist in the pronunciation dictionary), usually
grouped per speaker. This builds that layout from a transcript table.

Usage:
  python -m bisinger_tpu_torch.tools.mfa_prep wav_dir transcripts.txt out_dir \
      [--speaker spk]
  # transcripts.txt: "<utt_id>\t<transcript>" per line
  # then: mfa align out_dir lexicon.txt acoustic_model aligned_tg \
  #       --beam 400 --retry_beam 1000
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import Dict


def load_transcripts(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if "\t" in line:
                utt, txt = line.split("\t", 1)
            else:
                utt, txt = line.split(" ", 1)
            out[utt.strip()] = txt.strip()
    return out


def prepare_corpus(
    wav_dir: str, transcripts: Dict[str, str], out_dir: str, speaker: str = "spk"
) -> int:
    """Link/copy wavs and write .lab files into out_dir/<speaker>/."""
    spk_dir = os.path.join(out_dir, speaker)
    os.makedirs(spk_dir, exist_ok=True)
    n = 0
    for utt, txt in sorted(transcripts.items()):
        src = os.path.join(wav_dir, utt + ".wav")
        if not os.path.exists(src):
            print(f"| missing wav for {utt}, skipped", file=sys.stderr)
            continue
        dst = os.path.join(spk_dir, utt + ".wav")
        if not os.path.exists(dst):
            try:
                os.link(src, dst)
            except OSError:
                shutil.copy(src, dst)
        with open(os.path.join(spk_dir, utt + ".lab"), "w", encoding="utf-8") as f:
            f.write(txt + "\n")
        n += 1
    return n


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("wav_dir")
    parser.add_argument("transcripts")
    parser.add_argument("out_dir")
    parser.add_argument("--speaker", default="spk")
    args = parser.parse_args(argv)
    n = prepare_corpus(
        args.wav_dir, load_transcripts(args.transcripts), args.out_dir, args.speaker
    )
    print(f"| prepared {n} wav/lab pairs under {args.out_dir}/{args.speaker}")


if __name__ == "__main__":
    main()
