"""CLI entry point of the port (counterpart of the `--infer` branch of
`bisinger_tpu/run.py`).

    python -m bisinger_tpu_torch.run --infer --input scores.json --out out/ \
        [--ckpt_dir artifacts/flagship] [--hparams "k=v,..."] [--device cpu]

writes one 24 kHz WAV per score of the JSON list, named by its
`item_name`, and prints their paths. It runs on the card unless
`--device cpu` asks for the CPU. Binarizing and training are not ported
yet and raise.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch

    parser = argparse.ArgumentParser()
    parser.add_argument("--binarize", action="store_true")
    parser.add_argument("--infer", action="store_true")
    parser.add_argument("--input", type=str, default="", help="score json for --infer")
    parser.add_argument("--out", type=str, default="infer_out")
    parser.add_argument("--ckpt_dir", type=str, default=FLAGSHIP_DIR,
                        help="hparams_diff.json, phone_set.json, spk_map.json and the weights")
    parser.add_argument("--hparams", type=str, default="", help="overrides, 'k=v,k2=[1,2]'")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the card; 'cpu' to ask for it")
    args = parser.parse_args(argv)

    if args.binarize:
        raise NotImplementedError("binarizing is not ported yet (ROADMAP Queue 1, item 6)")
    if not args.infer:
        raise NotImplementedError("training is not ported yet (ROADMAP Queue 1, item 7)")
    if not args.input:
        print("--infer requires --input scores.json", file=sys.stderr)
        return 2
    infer = SVSInferTorch.from_checkpoint(args.ckpt_dir, device=args.device,
                                          hp_overrides=args.hparams or None)
    for p in infer.infer_from_json(args.input, args.out):
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
