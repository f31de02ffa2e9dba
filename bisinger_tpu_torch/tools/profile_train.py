"""Where the time of one training step goes on the card.

    python -m bisinger_tpu_torch.tools.profile_train [--stage fs2|diff|pe|voc|voc_mb4]
        [--batch B] [--tokens 16] [--frames T] [--steps 5] [--out TABLE.txt]

Builds the flagship's task of the stage in bf16: the acoustic stages from
hparams_fs2.json or hparams_diff.json with the parameters of
diff_params.npz; the PitchExtractor (hparams_diff.json with the keys of
configs/tts/pe.yaml) with pe_params.npz and pe_batch_stats.npz; the GAN
vocoder (512 channels, full band or mb4) from its own initialisation. A
random batch at the flagship recipe's shape (B=48, 512 frames; the
vocoder's B=8, 64 frames), two warm-up steps, then `--steps` steps without
and then under torch.profiler. An acoustic or PE step is split into
forward, backward and optimizer ranges; a GAN step into the task's own
forward and optimizer ranges (the discriminators' update, then the
generator's, its forward split into the generator and the
discriminators; its backward kernels fall outside the ranges). Prints
the wall time a step unprofiled, and profiled: the device time of its
kernels and the share of the wall time the device was busy, kernel
launches a step, the device span of each range, and the kernels with the
most device time; --out also writes the profiler's full table.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from bisinger_tpu_torch import full_fp32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", default="diff", choices=("fs2", "diff", "pe", "voc", "voc_mb4"))
    ap.add_argument("--batch", type=int, default=None, help="default 48 (vocoder 8)")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--frames", type=int, default=None, help="default 512 (vocoder 64)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None, help="write the full profiler table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    from torch.profiler import ProfilerActivity, profile, record_function

    from bisinger_tpu_torch.config import load_hparams_json, make_hparams
    from bisinger_tpu_torch.data.dataset import batch_to_device
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, make_batch
    from bisinger_tpu_torch.models.common import set_dropout_generator
    from bisinger_tpu_torch.training.tasks import (
        AuxDecoderMIDITask,
        DiffSingerMIDITask,
        PitchExtractionTask,
    )
    from bisinger_tpu_torch.training.vocoder_task import HifiGanTask
    from bisinger_tpu_torch.weights import load_npz

    full_fp32()
    dev = torch.device("cuda")
    vocoder = args.stage.startswith("voc")
    args.batch = args.batch or (8 if vocoder else 48)
    args.frames = args.frames or (64 if vocoder else 512)
    gen = torch.Generator(device=dev).manual_seed(0)
    r = np.random.RandomState(0)
    if vocoder:
        over = dict(upsample_initial_channel=512)
        if args.stage == "voc_mb4":
            over.update(vocoder_multiband=4, upsample_rates=[8, 4], upsample_kernel_sizes=[16, 8])
        hp = make_hparams(over)
        task = HifiGanTask(hp, device=dev)
        batch = batch_to_device(dict(
            mels=(r.randn(args.batch, args.frames, 80) * 0.5 - 4).astype(np.float32),
            f0=r.uniform(150, 450, (args.batch, args.frames)).astype(np.float32),
            wav=(0.1 * r.randn(args.batch, args.frames * hp["hop_size"])).astype(np.float32)),
            dev)

        def step():
            task.train_step(batch, gen)

        ranges = ("D forward", "D optimizer", "G forward", "G forward: generator",
                  "G forward: discriminators", "G optimizer")
    else:
        stage_json = "hparams_fs2.json" if args.stage == "fs2" else "hparams_diff.json"
        hp = load_hparams_json(os.path.join(FLAGSHIP_DIR, stage_json))
        flat = load_npz(os.path.join(FLAGSHIP_DIR, "diff_params.npz"))
        vocab = int(flat["fs2/token_embed/embed/embedding"].shape[0])
        if args.stage == "fs2":
            task = AuxDecoderMIDITask(hp, vocab, device=dev)
            task.load_state({k[4:]: v for k, v in flat.items() if k.startswith("fs2/")})
        elif args.stage == "pe":
            task = PitchExtractionTask(make_hparams(dict(hp, pitch_type="frame", use_uv=True,
                                                         pitch_loss="l1")), device=dev)
            task.load_state({**load_npz(os.path.join(FLAGSHIP_DIR, "pe_params.npz")),
                             **load_npz(os.path.join(FLAGSHIP_DIR, "pe_batch_stats.npz"))})
        else:
            task = DiffSingerMIDITask(hp, vocab, device=dev)
            task.load_state(flat)
        b = make_batch(args.batch, args.tokens, args.frames, vocab, seed=0)
        b.update(mels=np.where(b["mel2ph"][..., None] > 0,
                               r.randn(args.batch, args.frames, 80) * 0.5 - 3, 0
                               ).astype(np.float32),
                 word_boundary=r.randint(0, 2, (args.batch, args.tokens)),
                 f0=(7.5 + 0.5 * r.randn(args.batch, args.frames)).astype(np.float32),
                 uv=(r.rand(args.batch, args.frames) < 0.2).astype(np.float32))
        batch = batch_to_device(b, dev)
        model, opt = task.model, task.opt

        def step():
            model.train()
            set_dropout_generator(model, gen)
            with record_function("forward"):
                losses = task.compute_losses(task.forward(batch, gen), batch)
                total = sum(losses.values())
            opt.zero_grad()
            with record_function("backward"):
                total.backward()
            with record_function("optimizer"):
                opt.step()

        ranges = ("forward", "backward", "optimizer")

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / args.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    averages = prof.key_averages()
    cuda = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    # the ranges' own device entries span their kernels: kept apart from them
    spans = {e.key: e.self_device_time_total / args.steps for e in cuda if e.key in ranges}
    events = [e for e in cuda if e.key not in ranges]
    dev_us = lambda e: e.self_device_time_total / args.steps  # noqa: E731
    total = sum(dev_us(e) for e in events)
    n_launch = sum(e.count for e in events) / args.steps
    print(f"[profile_train] {torch.cuda.get_device_name(0)} {args.stage} {hp['compute_dtype']} "
          f"B={args.batch} T={args.frames}: {plain_wall * 1e3:.1f} ms a step "
          f"({1 / plain_wall:.2f} steps/s) unprofiled; profiled {wall * 1e3:.1f} ms a step, "
          f"device busy {total / 1e3:.1f} ms ({100 * total / 1e6 / wall:.1f}%), {n_launch:.0f} "
          "kernel launches a step; device span of each range, ms: "
          + ", ".join(f"{k} {v / 1e3:.1f}" for k, v in spans.items()))
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        print(f"[profile_train]   {dev_us(e) / 1e3:9.2f} ms {e.count / args.steps:6.0f}x  "
              f"{e.key[:90]}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(averages.table(sort_by="self_cuda_time_total", row_limit=80))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
