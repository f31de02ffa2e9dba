"""CLI entry point of the port (counterpart of `bisinger_tpu/run.py`).

    # binarize the corpus the config names (raw_data_dir -> binary_data_dir)
    # with its binarizer_cls
    python -m bisinger_tpu_torch.run --config configs/usr/popcs_fs2.yaml --binarize \\
        --hparams "raw_data_dir=raw,binary_data_dir=binary"
    # train (the default action) into checkpoints/<exp_name>; a rerun with a
    # larger --max_updates resumes from the latest checkpoint
    python -m bisinger_tpu_torch.run --config exp.json --exp_name fs2 \\
        --hparams "task_cls=usr.diffsinger_task.AuxDecoderMIDITask" --max_updates 100
    # the PitchExtractor (its work dir also gets pe_params.npz and
    # pe_batch_stats.npz at each checkpoint)
    python -m bisinger_tpu_torch.run --config exp.json --exp_name pe \\
        --hparams "task_cls=tasks.tts.pe.PitchExtractionTask,pitch_type=frame,use_uv=true"
    # data-parallel training, one process per card (the mesh's data axis):
    # N ranks take the step one process takes on the global batch
    torchrun --nproc_per_node N -m bisinger_tpu_torch.run --config exp.json --exp_name fs2
    # validate the latest checkpoint
    python -m bisinger_tpu_torch.run --exp_name fs2 --validate
    # scores -> wavs: the flagship's files, or a work dir's latest checkpoint
    python -m bisinger_tpu_torch.run --infer --input scores.json --out out/ \\
        [--ckpt_dir artifacts/flagship | --exp_name diff]

`--config` is one of the repo's YAML configs (with its `base_config`
cascade; a path relative to `configs/` or to the current directory) or
JSON: a config of its own, a JAX work dir's `config.json` or a trained
run's dump (`artifacts/flagship/hparams_{fs2,diff}.json`). Precedence:
defaults < --config < the work dir's saved config.json (unless --reset) <
--hparams. The task is `task_cls` and the binarizer `binarizer_cls`: the
reference's dotted names, the JAX package's or the port's
(`training.tasks.task_class`, `data.binarizer.binarizer_class`); the
diffusion stage and the BiSinger binarizer by default. `--infer` serves
through the vocoder class the vocoder's config names (`vocoder`: the
HiFi-GAN or a PWG, `vocoders/base_vocoder.py`), where the JAX package's
`run --infer` always builds a HiFi-GAN. Every action runs on the card
unless `--device cpu` asks for the CPU.

Under torchrun's environment (RANK, WORLD_SIZE, ...) training and
`--validate` run data-parallel (`parallel/mesh.py`), each rank on
cuda:LOCAL_RANK unless `--device` names a device, over NCCL on the card and
gloo on the CPU unless `--dist_backend` names one (gloo lets ranks share a
card); `--dist_init` replaces torchrun's rendezvous (for example a
`file://` path). `--binarize` and `--infer` refuse to run on more than one
rank.
"""

from __future__ import annotations

import argparse
import os
import sys

# one BLAS/OpenMP thread per process before numpy loads: the binarizer's
# worker processes would otherwise oversubscribe the host
os.environ.setdefault("OMP_NUM_THREADS", "1")


def load_config(args, work_dir: str):
    from bisinger_tpu_torch.config import (
        apply_overrides,
        load_hparams,
        load_hparams_json,
        make_hparams,
    )

    hp = load_hparams(args.config) if args.config else make_hparams()
    saved = os.path.join(work_dir, "config.json")
    if not args.reset and os.path.exists(saved):
        hp = load_hparams_json(saved)  # the run's own dump, its provenance included
    hp = apply_overrides(hp, args.hparams)
    hp.update(exp_name=args.exp_name, work_dir=work_dir, infer=args.infer)
    return hp


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="",
                        help="a YAML config (configs/...) or a JSON one")
    parser.add_argument("--exp_name", type=str, default="",
                        help="work dir checkpoints/<exp_name>")
    parser.add_argument("--hparams", type=str, default="", help="overrides, 'k=v,k2=[1,2]'")
    parser.add_argument("--binarize", action="store_true")
    parser.add_argument("--validate", action="store_true",
                        help="validate the latest checkpoint and exit")
    parser.add_argument("--max_updates", type=int, default=0)
    parser.add_argument("--reset", action="store_true",
                        help="ignore the config saved in the work dir")
    parser.add_argument("--infer", action="store_true")
    parser.add_argument("--input", type=str, default="", help="score json for --infer")
    parser.add_argument("--out", type=str, default="infer_out")
    parser.add_argument("--ckpt_dir", type=str, default="",
                        help="--infer: hparams_diff.json, phone_set.json, spk_map.json and the "
                             "weights (default artifacts/flagship); with --exp_name, the PE "
                             "and vocoder come from here")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the card (cuda:LOCAL_RANK under torchrun); 'cpu' to ask "
                             "for it")
    parser.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                        help="under torchrun: the process group's backend (default nccl on the "
                             "card, gloo on the CPU)")
    parser.add_argument("--dist_init", type=str, default=None,
                        help="under torchrun: the group's init method (default env://)")
    return parser.parse_args(argv)


def work_dir_of(args) -> str:
    return os.path.join("checkpoints", args.exp_name or "default")


def trainer_from_args(args):
    """The task of `task_cls` and its Trainer in the work dir, as the train
    and --validate actions build them; under torchrun's environment this
    process joins the data-parallel group first."""
    from bisinger_tpu_torch.parallel import mesh as dp
    from bisinger_tpu_torch.training.tasks import PitchExtractionTask, task_class
    from bisinger_tpu_torch.training.trainer import Trainer
    from bisinger_tpu_torch.utils.text_encoder import build_phone_encoder

    if dp.launched():
        args.device = dp.init_data_parallel(args.device, args.dist_backend, args.dist_init)
    hp = load_config(args, work_dir_of(args))
    if not hp["binary_data_dir"]:
        raise ValueError("binary_data_dir is not set: name a config (--config) or set it "
                         "(--hparams binary_data_dir=...)")
    cls = task_class(hp.get("task_cls", ""))
    if cls is PitchExtractionTask:  # mel -> f0: no vocabulary
        task = cls(hp, device=args.device)
    else:
        task = cls(hp, build_phone_encoder(hp["binary_data_dir"]).vocab_size,
                   device=args.device)
    return Trainer(task, hp, work_dir_of(args))


def main(argv=None) -> int:
    from bisinger_tpu_torch import full_fp32

    full_fp32()
    args = parse_args(argv)
    work_dir = work_dir_of(args)
    ranks = int(os.environ.get("WORLD_SIZE", "1"))
    for flag, on in (("--binarize", args.binarize), ("--infer", args.infer)):
        if on and ranks > 1:
            print(f"{flag} runs in one process, not on {ranks} ranks: launch it without "
                  "torchrun", file=sys.stderr)
            return 2
    if args.infer:
        from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch

        if not args.input:
            print("--infer requires --input scores.json", file=sys.stderr)
            return 2
        assets = args.ckpt_dir or FLAGSHIP_DIR
        if args.exp_name:
            infer = SVSInferTorch.from_work_dir(work_dir, assets, device=args.device,
                                                hp_overrides=args.hparams or None)
        else:
            infer = SVSInferTorch.from_checkpoint(assets, device=args.device,
                                                  hp_overrides=args.hparams or None)
        for p in infer.infer_from_json(args.input, args.out):
            print(p)
        return 0

    if args.binarize:
        from bisinger_tpu_torch.data.binarizer import binarizer_class

        hp = load_config(args, work_dir)
        binarizer_class(hp.get("binarizer_cls", ""))(hp).process()
        return 0
    from bisinger_tpu_torch.parallel import mesh as dp

    owns_group = dp.launched() and not dp.active()
    try:
        trainer = trainer_from_args(args)
        if args.validate:
            loss = trainer.validate()
            trainer.say(f"| validate: total_loss={loss:.4f}")
            return 0
        trainer.fit(max_updates=args.max_updates or None)
        return 0
    finally:
        if owns_group:
            dp.shutdown()


if __name__ == "__main__":
    sys.exit(main())
