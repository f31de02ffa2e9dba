"""Time the bf16 kernels of several checkouts in turns, in one run on one card.

    python -m bisinger_tpu_torch.tools.kernel_ab ROOT [ROOT ...] [--out FILE.json]

Each ROOT is the root of a checkout of this repository (its
`bisinger_tpu_torch` package is imported from there, its kernels built
into its own `_build`). Give them in turns, such as a parent and a change
as `parent change change parent`: the card's host and clocks drift
between runs, so two versions compare only within one run, in turns.
For each ROOT, in its own process: K1-bf16 (`residual_stack_bf16`, L=20,
C=256, the flagship's dilations) and each of K2-bf16's four stages
(`mrf_stage_bf16`, the flagship's NSF HiFi-GAN: F = 256, 128, 64, 32 over
U = 8, 32, 64, 128 T) at chip_smoke.py phase 6's shapes, B=4, T=256 and
B=32, T=1024, on the same random inputs for every ROOT, timed with CUDA
events after a warm-up launch, beside the bf16 library chains
(`residual_stack_library`, `mrf_stage_conv1d`), and each output's relative
max and mean difference from its plain version. Prints one line a
measurement and a last JSON line with the card's name, nvidia-smi's name
and power limit, and every ROOT's figures. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SHAPES = ((4, 256, 20, 5), (32, 1024, 5, 2))  # B, T, K1 reps, K2 reps


def child(root: str) -> int:
    sys.path.insert(0, root)
    import torch

    from bisinger_tpu_torch import full_fp32
    from bisinger_tpu_torch.ops import diffnet_stack, mrf_stage

    package = os.path.dirname(os.path.dirname(os.path.abspath(diffnet_stack.__file__)))
    assert os.path.dirname(package) == os.path.abspath(root), diffnet_stack.__file__
    full_fp32()
    dev = torch.device("cuda")

    def ms(fn, reps):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def rel(got, ref):
        diff = (got.double() - ref.double()).abs()
        return (diff.max().item() / ref.abs().max().item(),
                diff.mean().item() / ref.abs().mean().item())

    t0 = time.perf_counter()
    rows = []
    C, L = 256, 20
    dils = [2 ** (i % 4) for i in range(L)]
    b16 = torch.bfloat16
    rk, rd = [3, 7, 11], [[1, 3, 5]] * 3
    for B, T, k1_reps, k2_reps in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(B * 1000 + T)
        r = lambda *s, sc=1.0: sc * torch.randn(s, generator=gen, device=dev)  # noqa: E731
        a = (torch.relu(r(B, T, C)).to(b16), r(L, B, T, 2 * C).to(b16), r(L, B, C, sc=0.5).to(b16),
             r(L, 3, C, 2 * C, sc=(3 * C) ** -0.5).to(b16), r(L, 2 * C, sc=0.1),
             r(L, C, 2 * C, sc=C ** -0.5).to(b16), r(L, 2 * C, sc=0.1))
        got = diffnet_stack.residual_stack_bf16(*a, dils)
        r_max, r_mean = rel(got, diffnet_stack.residual_stack_plain_bf16(*a, dils))
        row = dict(kernel="K1-bf16", B=B, T=T,
                   ms=ms(lambda: diffnet_stack.residual_stack_bf16(*a, dils), k1_reps),
                   library_ms=ms(lambda: diffnet_stack.residual_stack_library(*a, dils), k1_reps),
                   rel_max=r_max, rel_mean=r_mean)
        rows.append(row)
        print(f"[ab] {root} {row}", flush=True)
        del a, got
        F, U = 512, T
        for up in (8, 4, 2, 2):
            F, U = F // 2, U * up
            n_w = 2 * F * F * sum(k * len(d) for k, d in zip(rk, rd))
            x = r(B, U, F)
            w = r(n_w, sc=(7 * F) ** -0.5).to(b16)
            b = r(18, F, sc=0.1)
            got = mrf_stage.mrf_stage_bf16(x, w, b, rk, rd)
            r_max, r_mean = rel(got, mrf_stage.mrf_stage_plain_bf16(x, w, b, rk, rd))
            row = dict(kernel="K2-bf16", B=B, T=T, F=F, U=U,
                       ms=ms(lambda: mrf_stage.mrf_stage_bf16(x, w, b, rk, rd), k2_reps),
                       library_ms=ms(lambda: mrf_stage.mrf_stage_conv1d(x, w, b, rk, rd,
                                                                        dtype=b16), k2_reps),
                       rel_max=r_max, rel_mean=r_mean)
            rows.append(row)
            print(f"[ab] {root} {row}", flush=True)
            del x, w, b, got
    print(json.dumps(dict(root=root, seconds=round(time.perf_counter() - t0, 1), rows=rows)),
          flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.child:
        return child(args.child)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    report = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, runs=[])
    print(f"[ab] {report['device']}; nvidia-smi: {smi}", flush=True)
    ok = True
    for root in args.roots:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                               os.path.abspath(root)], cwd=os.path.abspath(root), env=env,
                              capture_output=True, text=True)
        for ln in proc.stdout.splitlines():
            if ln.startswith("[ab]") or ln.startswith("[build]"):
                print(ln, flush=True)
        result = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not result:
            ok = False
            tail = proc.stderr[-3000:].replace("\n", " | ")
            print(f"[ab] {root} FAILED ({proc.returncode}): {tail}", flush=True)
            continue
        report["runs"].append(result[-1])
    text = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
