"""Where the time of one synthesize() call goes on the card.

    python -m bisinger_tpu_torch.tools.profile_path [--batch 4] [--frames 256]
        [--compute-dtype bfloat16|float32] [--out TABLE.txt]

Loads the flagship checkpoint (in its compute_dtype, bf16, unless another
is given), warms the path up once, then runs one
synthesize() under torch.profiler and prints: the call's wall time, the
summed device time of its kernels (and the share of the wall time the
device was busy), the device time of K1 and K2 and of everything else,
and the kernels with the most device time; --out also writes the
profiler's full table.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from bisinger_tpu_torch import full_fp32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--compute-dtype", default=None, choices=("bfloat16", "float32"),
                    help="override the checkpoint's compute_dtype")
    ap.add_argument("--out", default=None, help="write the full profiler table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_path: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from bisinger_tpu_torch.inference.pipeline import SVSInferTorch, make_batch

    full_fp32()
    over = {"compute_dtype": args.compute_dtype} if args.compute_dtype else None
    svs = SVSInferTorch.from_checkpoint(device="cuda", hp_overrides=over)
    batch = make_batch(args.batch, 64, args.frames, svs.vocab_size, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    svs.synthesize(batch, generator=gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svs.synthesize(batch, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: e.self_device_time_total  # noqa: E731
    total = sum(dev_us(e) for e in events)
    # the kernels of both routes: residual_stack[_bf16]_kernel, mrf_stage[_bf16]_kernel
    k1 = sum(dev_us(e) for e in events if "residual_stack" in e.key)
    k2 = sum(dev_us(e) for e in events if "mrf_stage" in e.key)
    n_launch = sum(e.count for e in events)
    print(f"[profile] {torch.cuda.get_device_name(0)} {svs.hp['compute_dtype']} "
          f"B={args.batch} T={args.frames}: wall "
          f"{wall * 1e3:.1f} ms, device busy {total / 1e3:.1f} ms ({100 * total / 1e6 / wall:.1f}% "
          f"of wall), {n_launch} kernel launches; K1 {k1 / 1e3:.1f} ms, K2 {k2 / 1e3:.1f} ms, "
          f"other kernels {(total - k1 - k2) / 1e3:.1f} ms")
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        print(f"[profile]   {dev_us(e) / 1e3:9.2f} ms {e.count:6d}x  {e.key[:90]}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=80))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
