"""Time the kernels of several checkouts in turns, in one run on one card;
or every width of this checkout's kernels.

    python -m bisinger_tpu_torch.tools.kernel_ab ROOT [ROOT ...] [--out FILE.json]
    python -m bisinger_tpu_torch.tools.kernel_ab --widths [--out FILE.json]

Each ROOT is the root of a checkout of this repository (its
`bisinger_tpu_torch` package is imported from there, its kernels built
into its own `_build`). Give them in turns, such as a parent and a change
as `parent change change parent`: the card's host and clocks drift
between runs, so two versions compare only within one run, in turns.
For each ROOT, in its own process: K1 (L=20, C=256, the flagship's
dilations) and each of K2's four stages (the flagship's NSF HiFi-GAN: F =
256, 128, 64, 32 over U = 8, 32, 64, 128 T), each route (bf16:
`residual_stack_bf16`, `mrf_stage_bf16`; fp32: `residual_stack`,
`mrf_stage`), at chip_smoke.py phase 6's shapes, B=4, T=256 and B=32,
T=1024, on the same random inputs for every ROOT, timed with CUDA events
after a warm-up launch, beside the library chains in the route's dtype
(`residual_stack_library`, `mrf_stage_conv1d`), and each output's relative
max and mean difference from its plain version.

`--widths` times this checkout's kernels at every width they are built for
(`ops/_build.py` WIDTHS), each route, at B=4, T=256 and B=32, T=1024 (K2's
stage of width F over U = T x `K2_UP[F]`, its place in a generator of
rates 8, 4, 2, 2: F = 512 after a 1024-channel input, 16 and 8 in the
128-channel vocoder, the others the flagship's), beside its bound (the
operations at the route's peak or the bytes at 3.35 TB/s, the larger; H100
SXM data sheet), the library chain, the plain version's error and that of
the route's control (chip_smoke.py's: bf16 the plain version with one
rounding point moved, whose mean must lie above the mean bound; fp32 the
plain version with single-pass TF32 products, at least 10x the kernel's
relative max).

Prints one line a measurement and a last JSON line with the card's name,
nvidia-smi's name and power limit, and the figures. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SHAPES = ((4, 256, 20, 5), (32, 1024, 5, 2))  # B, T, K1 reps, K2 reps
# K2's stage of width F runs over U = T x K2_UP[F] samples (--widths)
K2_UP = {512: 8, 256: 8, 128: 32, 64: 64, 32: 128, 16: 64, 8: 128}
BF16_PEAK, FP32_TC_PEAK, HBM_RATE = 989e12, 495e12 / 3, 3.35e12  # H100 SXM data sheet


def _ms(fn, reps):
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rel(got, ref):
    diff = (got.double() - ref.double()).abs()
    return (diff.max().item() / ref.abs().max().item(),
            diff.mean().item() / ref.abs().mean().item())


def child(root: str) -> int:
    sys.path.insert(0, root)
    import torch

    from bisinger_tpu_torch import full_fp32
    from bisinger_tpu_torch.ops import diffnet_stack, mrf_stage

    package = os.path.dirname(os.path.dirname(os.path.abspath(diffnet_stack.__file__)))
    assert os.path.dirname(package) == os.path.abspath(root), diffnet_stack.__file__
    full_fp32()
    dev = torch.device("cuda")
    ms, rel = _ms, _rel
    t0 = time.perf_counter()
    rows = []
    C, L = 256, 20
    dils = [2 ** (i % 4) for i in range(L)]
    b16 = torch.bfloat16
    rk, rd = [3, 7, 11], [[1, 3, 5]] * 3
    for B, T, k1_reps, k2_reps in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(B * 1000 + T)
        r = lambda *s, sc=1.0: sc * torch.randn(s, generator=gen, device=dev)  # noqa: E731
        a32 = (torch.relu(r(B, T, C)), r(L, B, T, 2 * C), r(L, B, C, sc=0.5),
               r(L, 3, C, 2 * C, sc=(3 * C) ** -0.5), r(L, 2 * C, sc=0.1),
               r(L, C, 2 * C, sc=C ** -0.5), r(L, 2 * C, sc=0.1))
        a16 = tuple(v if i in (4, 6) else v.to(b16) for i, v in enumerate(a32))
        for route, a, fn, plain in (
                ("bf16", a16, diffnet_stack.residual_stack_bf16,
                 diffnet_stack.residual_stack_plain_bf16),
                ("fp32", a32, diffnet_stack.residual_stack, diffnet_stack.residual_stack_plain)):
            got = fn(*a, dils)
            r_max, r_mean = rel(got, plain(*a, dils))
            reps = k1_reps if route == "bf16" else max(k1_reps // 2, 1)
            row = dict(kernel=f"K1-{route}", B=B, T=T, ms=ms(lambda: fn(*a, dils), reps),
                       library_ms=ms(lambda: diffnet_stack.residual_stack_library(*a, dils),
                                     reps),
                       rel_max=r_max, rel_mean=r_mean)
            rows.append(row)
            print(f"[ab] {root} {row}", flush=True)
            del got
        del a32, a16
        F, U = 512, T
        for up in (8, 4, 2, 2):
            F, U = F // 2, U * up
            n_w = 2 * F * F * sum(k * len(d) for k, d in zip(rk, rd))
            x = r(B, U, F)
            w32 = r(n_w, sc=(7 * F) ** -0.5)
            b = r(18, F, sc=0.1)
            for route, w, fn, plain, wdt in (
                    ("bf16", w32.to(b16), mrf_stage.mrf_stage_bf16, mrf_stage.mrf_stage_plain_bf16,
                     b16),
                    ("fp32", w32, mrf_stage.mrf_stage, mrf_stage.mrf_stage_plain, torch.float32)):
                got = fn(x, w, b, rk, rd)
                r_max, r_mean = rel(got, plain(x, w, b, rk, rd))
                reps = k2_reps if route == "bf16" else 1
                row = dict(kernel=f"K2-{route}", B=B, T=T, F=F, U=U,
                           ms=ms(lambda: fn(x, w, b, rk, rd), reps),
                           library_ms=ms(lambda: mrf_stage.mrf_stage_conv1d(x, w, b, rk, rd,
                                                                            dtype=wdt), reps),
                           rel_max=r_max, rel_mean=r_mean)
                rows.append(row)
                print(f"[ab] {root} {row}", flush=True)
                del got
            del x, w32, b
    print(json.dumps(dict(root=root, seconds=round(time.perf_counter() - t0, 1), rows=rows)),
          flush=True)
    return 0


def widths_child() -> dict:
    """`--widths`: every width of this checkout's kernels, each route:
    {"widths": [row, ...], "seconds"}; prints each row as it is taken."""
    import torch

    from bisinger_tpu_torch import full_fp32
    from bisinger_tpu_torch.ops import _build, _tf32, diffnet_stack, mrf_stage

    full_fp32()
    dev = torch.device("cuda")
    b16 = torch.bfloat16
    L = 20
    controls = {
        "K1-bf16": lambda *a: diffnet_stack.residual_stack_plain_bf16(*a, skip_dtype=b16),
        "K1-fp32": lambda *a: _tf32.residual_stack_plain_tf32(*a, passes=1),
        "K2-bf16": lambda *a: mrf_stage.mrf_stage_plain_bf16(*a, conv1_dtype=torch.float32),
        "K2-fp32": lambda *a: _tf32.mrf_stage_plain_tf32(*a, passes=1),
    }
    dils = [2 ** (i % 4) for i in range(L)]
    rk, rd = [3, 7, 11], [[1, 3, 5]] * 3
    t0 = time.perf_counter()
    rows = []

    def bound(flops, nbytes, peak):
        fl, by = flops / peak, nbytes / HBM_RATE
        return 1e3 * max(fl, by), "operations" if fl >= by else "bytes"

    for B, T, reps in ((4, 256, 10), (32, 1024, 2)):
        for C in _build.K1_WIDTHS:
            gen = torch.Generator(device=dev).manual_seed(B + T + C)
            r = lambda *s, sc=1.0: sc * torch.randn(s, generator=gen, device=dev)  # noqa: E731
            a32 = (torch.relu(r(B, T, C)), r(L, B, T, 2 * C), r(L, B, C, sc=0.5),
                   r(L, 3, C, 2 * C, sc=(3 * C) ** -0.5), r(L, 2 * C, sc=0.1),
                   r(L, C, 2 * C, sc=C ** -0.5), r(L, 2 * C, sc=0.1))
            for route, a, fn, plain, peak in (
                    ("bf16", tuple(v if i in (4, 6) else v.to(b16) for i, v in enumerate(a32)),
                     diffnet_stack.residual_stack_bf16, diffnet_stack.residual_stack_plain_bf16,
                     BF16_PEAK),
                    ("fp32", a32, diffnet_stack.residual_stack,
                     diffnet_stack.residual_stack_plain, FP32_TC_PEAK)):
                got = fn(*a, dils)
                ref = plain(*a, dils)
                r_max, r_mean = _rel(got, ref)
                c_max, c_mean = _rel(controls[f"K1-{route}"](*a, dils), ref)
                del got, ref
                b_ms, b_by = bound(diffnet_stack.stack_flops(B, T, C, L),
                                   diffnet_stack.stack_bytes(B, T, C, L, bf16=route == "bf16"),
                                   peak)
                row = dict(kernel=f"K1-{route}", width=C, B=B, T=T,
                           ms=_ms(lambda: fn(*a, dils), reps), bound_ms=b_ms, bound_by=b_by,
                           library_ms=_ms(lambda: diffnet_stack.residual_stack_library(
                               *a, dils), reps),
                           rel_max=r_max, rel_mean=r_mean, control_max=c_max,
                           control_mean=c_mean)
                row["factor"] = row["ms"] / b_ms
                rows.append(row)
                print(f"[widths] {row}", flush=True)
            del a32, a
        for F in _build.K2_WIDTHS:
            U = T * K2_UP[F]
            gen = torch.Generator(device=dev).manual_seed(B + T + F)
            n_w = 2 * F * F * sum(k * len(d) for k, d in zip(rk, rd))
            x = torch.randn((B, U, F), generator=gen, device=dev)
            w32 = torch.randn((n_w,), generator=gen, device=dev) * (7 * F) ** -0.5
            b = 0.1 * torch.randn((18, F), generator=gen, device=dev)
            for route, w, fn, plain, wdt, peak in (
                    ("bf16", w32.to(b16), mrf_stage.mrf_stage_bf16, mrf_stage.mrf_stage_plain_bf16,
                     b16, BF16_PEAK),
                    ("fp32", w32, mrf_stage.mrf_stage, mrf_stage.mrf_stage_plain, torch.float32,
                     FP32_TC_PEAK)):
                got = fn(x, w, b, rk, rd)
                ref = plain(x, w, b, rk, rd)
                r_max, r_mean = _rel(got, ref)
                c_max, c_mean = _rel(controls[f"K2-{route}"](x, w, b, rk, rd), ref)
                del got, ref
                b_ms, b_by = bound(mrf_stage.stage_flops(B, U, F, rk, rd),
                                   mrf_stage.stage_bytes(B, U, F, rk, rd, bf16=route == "bf16"),
                                   peak)
                k2_reps = max(1, reps // 2)
                row = dict(kernel=f"K2-{route}", width=F, B=B, T=T, U=U,
                           ms=_ms(lambda: fn(x, w, b, rk, rd), k2_reps), bound_ms=b_ms,
                           bound_by=b_by,
                           library_ms=_ms(lambda: mrf_stage.mrf_stage_conv1d(
                               x, w, b, rk, rd, dtype=wdt), k2_reps),
                           rel_max=r_max, rel_mean=r_mean, control_max=c_max,
                           control_mean=c_mean)
                row["factor"] = row["ms"] / b_ms
                rows.append(row)
                print(f"[widths] {row}", flush=True)
            del x, w32, b, w
    return dict(widths=rows, seconds=round(time.perf_counter() - t0, 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--widths", action="store_true",
                    help="time every width of this checkout's kernels instead")
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
    if args.widths:
        report.update(widths_child())
        text = json.dumps(report)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text + "\n")
        print(text)
        return 0
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
