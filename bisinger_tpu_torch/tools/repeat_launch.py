"""Launch the bf16 kernels back to back many times, and fail on a hang.

    python -m bisinger_tpu_torch.tools.repeat_launch [--n 2000] [--timeout 180]

K1-bf16 (the DiffNet stack, both of its paths) and K2-bf16 (the MRF stage)
wait on barriers inside the kernel; a barrier that is never released hangs
the launch, possibly only once in hundreds of launches. This runs, for each
case (`CASES`: K1-bf16 at B=32, T=1024, which takes the wide path, and at
B=4, T=256, the narrow one, at the flagship's C=256; K2-bf16's F=256 stage
at both batches, U = 8 T; and each layout that other widths add, at B=4:
K1-bf16's narrow 32-frame tiles at C=64, its 16-frame cluster at C=512 and
its wide path of 64-frame tiles at C=512, T=1024; K2-bf16's padded K at
F=8, its m64n16 products at F=16 and its passes of 256 columns over
clusters of eight at F=512, each at its place in the generators of 128 and
1024 channels): one launch whose output is kept, then `--n` launches into
a second output with nothing between them but each C entry point's own
cudaGetLastError, then one synchronize, and the last output against the
first, bit for bit. The kernels' inputs are random (L=20; K2 with k = 3,
7, 11 and dilations 1, 3, 5).

The work runs in a child process (`--child`): the parent kills it if it has
not ended within `--timeout` seconds and names the case it was in (the
child prints a line as it starts each). The parent's last line is one JSON
object: ok, and per case the launches, seconds and whether the outputs
matched. Exit code 0 only when every case ended and matched. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# (kernel, B, T, width): K1's C, K2's F; K2 runs over U = T x the upsampling
# before its stage (kernel_ab.K2_UP)
CASES = (("K1-bf16", 32, 1024, 256), ("K1-bf16", 4, 256, 256), ("K2-bf16", 32, 1024, 256),
         ("K2-bf16", 4, 256, 256), ("K1-bf16", 4, 256, 64), ("K1-bf16", 4, 256, 512),
         ("K1-bf16", 4, 1024, 512), ("K2-bf16", 4, 256, 8), ("K2-bf16", 4, 256, 16),
         ("K2-bf16", 4, 256, 512))


def _case_launcher(kind, B, T, width, dev):
    """(launch, output) of one case: launch() runs the kernel once and returns
    its cudaError_t; the inputs were checked by one wrapper call."""
    import torch

    from bisinger_tpu_torch.ops import _build, diffnet_stack, mrf_stage
    from bisinger_tpu_torch.tools.kernel_ab import K2_UP

    gen = torch.Generator(device=dev).manual_seed(B * 7919 + T)
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=gen, device=dev)  # noqa: E731
    if kind == "K1-bf16":
        C, L = width, 20
        dils = [2 ** (i % 4) for i in range(L)]
        b16 = torch.bfloat16
        args = (torch.relu(r(B, T, C)).to(b16), r(L, B, T, 2 * C).to(b16),
                r(L, B, C, sc=0.5).to(b16), r(L, 3, C, 2 * C, sc=(3 * C) ** -0.5).to(b16),
                r(L, 2 * C, sc=0.1), r(L, C, 2 * C, sc=C ** -0.5).to(b16), r(L, 2 * C, sc=0.1))
        diffnet_stack.residual_stack_bf16(*args, dils)  # the wrapper's checks, once
        launch, skip, _ = diffnet_stack.launcher_bf16(*args, dils)
        return launch, skip, args
    F, U = width, K2_UP[width] * T
    rk, rd = [3, 7, 11], [[1, 3, 5]] * 3
    n_w = 2 * F * F * sum(k * len(d) for k, d in zip(rk, rd))
    x = r(B, U, F)
    w = (r(n_w) * (7 * F) ** -0.5).to(torch.bfloat16)
    b = r(2 * sum(len(d) for d in rd), F, sc=0.1)
    mrf_stage.mrf_stage_bf16(x, w, b, rk, rd)
    launch, out = mrf_stage.launcher("mrf_stage_bf16", _build.load("mrf_stage_bf16", F), x, w, b,
                                     rk, rd)
    return launch, out, (x, w, b)


def child(n: int) -> int:
    import torch

    dev = torch.device("cuda")
    results = []
    for kind, B, T, width in CASES:
        print(f"[repeat] start {kind} B={B} T={T} width {width}", flush=True)
        launch, out, keep = _case_launcher(kind, B, T, width, dev)
        err = launch()
        torch.cuda.synchronize()
        first = out.clone()
        t0 = time.perf_counter()
        bad = 0
        for _ in range(n):
            bad = bad or launch()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        last = out.clone()
        launch()
        torch.cuda.synchronize()
        again = bool(torch.equal(out.view(torch.int32), last.view(torch.int32)))
        out.copy_(last)
        same = bool(torch.equal(out.view(torch.int32), first.view(torch.int32)))
        diff = (out.double() - first.double()).abs()
        results.append(dict(kernel=kind, B=B, T=T, width=width, launches=n + 1,
                            seconds=round(secs, 3),
                            error=int(err or bad), bit_identical=same,
                            n_differ=int((out.view(torch.int32) != first.view(torch.int32))
                                         .sum()),
                            max_abs_diff=float(diff[diff == diff].max()) if diff.numel() else 0.0,
                            nan_first=int(torch.isnan(first).sum()),
                            nan_last=int(torch.isnan(out).sum()), next_equals_last=again))
        print(f"[repeat] done {kind} B={B} T={T} width {width}: {n + 1} launches, {secs:.3f} s, "
              f"error {err or bad}, last output {'equals' if same else 'DIFFERS FROM'} the first"
              + ("" if same else f" ({results[-1]})"), flush=True)
        del launch, out, keep
    print(json.dumps(dict(child=results)), flush=True)
    return 0


def start(n: int):
    """Start the child (`n` launches after the first, each case); returns
    (process, its start time) for `finish`. The caller's other work may run
    meanwhile, on the same card."""
    cmd = [sys.executable, "-m", "bisinger_tpu_torch.tools.repeat_launch", "--child", "--n",
           str(n)]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=root, env=env, start_new_session=True), t0


def run(n: int, timeout: float, log=print):
    """Run the child, kill it after `timeout` s; returns (ok, results, message)."""
    return finish(start(n), timeout, log)


def finish(started, timeout: float, log=print):
    """Wait for a child from `start`, killed once `timeout` s have passed
    since it started; returns (ok, results, message)."""
    proc, t0 = started
    try:
        text, _ = proc.communicate(timeout=max(0.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        text, _ = proc.communicate()
        begun = [ln for ln in text.splitlines() if ln.startswith("[repeat] start")]
        where = begun[-1][len("[repeat] start "):] if begun else "before the first case"
        return False, [], (f"no end within {timeout:.0f} s: hung in {where} "
                           f"({time.perf_counter() - t0:.1f} s)")
    lines = text.splitlines()
    for ln in lines:
        if ln.startswith("[repeat] done"):
            log(ln)
    results = []
    for ln in lines:
        if ln.startswith("{"):
            results = json.loads(ln)["child"]
    if proc.returncode != 0 or len(results) != len(CASES):
        return False, results, f"the child failed ({proc.returncode}): " + "\n".join(lines[-20:])
    ok = all(r["bit_identical"] and r["error"] == 0 for r in results)
    return ok, results, ("every case ended and matched" if ok else "a case erred or differed")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2000, help="launches after the first, each case")
    ap.add_argument("--timeout", type=float, default=180.0, help="seconds before the kill")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("repeat_launch: no CUDA device", file=sys.stderr)
        return 1
    if args.child:
        return child(args.n)
    ok, results, msg = run(args.n, args.timeout)
    print(f"[repeat] {msg}")
    print(json.dumps(dict(ok=ok, n=args.n, timeout_s=args.timeout, cases=results)))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
