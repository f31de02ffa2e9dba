"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root, with one card:

    python3 chip_smoke.py

Phases, each printing one line with its results and seconds (a failed
phase exits non-zero):
  1. device: name, count, nvidia-smi's name and power limit;
  2. build both kernels with nvcc (csrc/*.cu, one process per source);
  3. K1 (DiffNet residual stack) against its plain version at the
     flagship widths, B=4, T=256;
  4. K2 (MRF stage) against its plain version at each stage width, B=2;
  5. the flagship path: synthesize() on a 4 x 64-token, 256-frame batch
     with mel2ph given, then on one request through the duration
     predictor; launch counts, finite non-silent waveforms of frames x 128
     samples, and a small input against the same path on the CPU;
  6. both kernels against their plain versions at every shape the path
     gives them in phases 5 and 7 (B=4, T=256 and the bench's B=32,
     T=1024), with CUDA-event times of both, the conv1d yardstick for K2,
     and each kernel's bound;
  7. warm synthesize() wall times at B=4, T=256 and at the bench's
     B=32, T=1024, as audio seconds made per second.
The last two lines are one JSON object of kernel results and
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result. The weights are the trained flagship's (artifacts/flagship);
phase 5 fails, naming the file, where a checkout lacks one.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import torch

BUDGET_S = 600.0  # the run fails past 10 minutes, builds included
T_START = time.perf_counter()
FP32_PEAK = 67e12  # H100 SXM fp32 FLOP/s outside the tensor cores (data sheet)
HBM_RATE = 3.35e12  # H100 SXM bytes/s


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def done(self, msg: str) -> None:
        log(f"[{self.name}] {msg} ({time.perf_counter() - self.t0:.1f} s)")

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            log(f"[{self.name}] FAILED after {time.perf_counter() - self.t0:.1f} s: {exc}")
        return False


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, ref):
    err = (got.double() - ref.double()).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def k1_inputs(B, T, C, L, gen, dev):
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=gen, device=dev)  # noqa: E731
    return (torch.relu(r(B, T, C)), r(L, B, T, 2 * C), r(L, B, C, sc=0.5),
            r(L, 3, C, 2 * C, sc=(3 * C) ** -0.5), r(L, 2 * C, sc=0.1),
            r(L, C, 2 * C, sc=C ** -0.5), r(L, 2 * C, sc=0.1))


def k2_inputs(B, U, F, rk, rd, gen, dev):
    n_w = 2 * F * F * sum(k * len(d) for k, d in zip(rk, rd))
    x = torch.randn((B, U, F), generator=gen, device=dev)
    w = torch.randn((n_w,), generator=gen, device=dev)
    # scale each conv's block of w to unit gain: 1/sqrt(k*F)
    parts, off = [], 0
    for k, d in zip(rk, rd):
        for _ in range(2 * len(d)):
            parts.append(w[off:off + k * F * F] * (k * F) ** -0.5)
            off += k * F * F
    b = 0.1 * torch.randn((2 * sum(len(d) for d in rd), F), generator=gen, device=dev)
    return x, torch.cat(parts).contiguous(), b


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch, make_batch
    from bisinger_tpu_torch.ops import _build, diffnet_stack, mrf_stage

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)

    with Phase("1 device") as ph:
        kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
        ph.done(f"{kind}, {count} device(s); nvidia-smi: {smi}; torch {torch.__version__} "
                f"cuda {torch.version.cuda}")

    with Phase("2 build") as ph:
        secs = _build.build_all(log=log)
        for name in _build.KERNELS:
            _build.load(name)
        ph.done("built " + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items())
                if secs else "libraries already built")

    results = {}
    C, L = 256, 20
    dils = [2 ** (i % 4) for i in range(L)]
    with Phase("3 K1 vs plain") as ph:
        gen.manual_seed(1)
        args = k1_inputs(4, 256, C, L, gen, dev)
        got = diffnet_stack.residual_stack(*args, dils)
        torch.cuda.synchronize()
        ref = diffnet_stack.residual_stack_plain(*args, dils)
        err, rel = rel_err(got, ref)
        results["k1_err"] = err
        ok = rel <= diffnet_stack.TOLERANCE
        ph.done(f"B=4 T=256 C={C} L={L}: max_abs_err {err:.3e}, relative {rel:.3e} "
                f"(tolerance {diffnet_stack.TOLERANCE:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            return 1

    with Phase("4 K2 vs plain") as ph:
        rk, rd = [3, 7, 11], [[1, 3, 5]] * 3
        errs, bad = [], []
        for F in (256, 128, 64, 32):
            gen.manual_seed(F)
            x, w, b = k2_inputs(2, 2048, F, rk, rd, gen, dev)
            got = mrf_stage.mrf_stage(x, w, b, rk, rd)
            torch.cuda.synchronize()
            err, rel = rel_err(got, mrf_stage.mrf_stage_plain(x, w, b, rk, rd))
            errs.append(f"F={F} {err:.3e}/{rel:.3e}")
            results[f"k2_err_{F}"] = err
            if rel > mrf_stage.TOLERANCE:
                bad.append(F)
        ph.done(f"B=2 U=2048 max_abs_err/relative (tolerance {mrf_stage.TOLERANCE:g}): "
                + "; ".join(errs) + (f" MISMATCH at F={bad}" if bad else " ok"))
        if bad:
            return 1

    with Phase("5 path") as ph:
        svs = SVSInferTorch.from_checkpoint(FLAGSHIP_DIR, device=dev)
        vocab = svs.vocab_size
        gen.manual_seed(0)
        batch = make_batch(4, 64, 256, vocab, seed=0)
        req = make_batch(1, 64, 256, vocab, seed=1)
        request = {"ph_token": req["txt_tokens"][0], "pitch_midi": req["pitch_midi"][0],
                   "midi_dur": req["midi_dur"][0], "is_slur": req["is_slur"][0],
                   "lang": req["lang"][0], "spk_id": int(req["spk_ids"][0]), "speechsing": 1}
        pred_batch = svs.items_to_batch([request], t_txt=64)
        launches = {"k1": 0, "k2": 0}
        lines = []
        for name, b in (("mel2ph given, B=4", batch), ("predicted durations, B=1", pred_batch)):
            diffnet_stack.counter.launches = mrf_stage.counter.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = svs.synthesize(b, generator=gen)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            k1, k2 = diffnet_stack.counter.launches, mrf_stage.counter.launches
            launches["k1"] += k1
            launches["k2"] += k2
            wav, mel = out["wav"], out["mel"]
            frames = mel.shape[1]
            voiced = int((out["mel2ph"] > 0).sum().item())
            checks = {
                "finite": bool(torch.isfinite(wav).all() and torch.isfinite(mel).all()),
                "non-silent": float(wav.abs().max()) > 1e-3,
                "length": tuple(wav.shape) == (mel.shape[0], frames * 128),
                "K1=201": k1 == svs.hp["K_step"] // svs.hp["pndm_speedup"] + 1,
                "K2=4": k2 == len(svs.hp["upsample_rates"]),
            }
            lines.append(f"{name}: wav {tuple(wav.shape)} ({frames} frames, {voiced} filled), "
                         f"|wav| max {float(wav.abs().max()):.3f}, K1 {k1}, K2 {k2}, "
                         f"{secs:.2f} s, checks " + ",".join(
                             k for k, v in checks.items() if v))
            if not all(checks.values()):
                ph.done(" | ".join(lines)
                        + f"; FAILED {[k for k, v in checks.items() if not v]}")
                return 1
        # a small input against the same path on the CPU (plain versions), with
        # the random draws pinned: mel and waveform agree within the tolerances
        small = make_batch(1, 16, 32, vocab, seed=2)
        g = torch.Generator().manual_seed(3)
        pins = dict(start_noise=torch.randn((1, 32, 80), generator=g),
                    nsf_phase=torch.rand((1, 9), generator=g),
                    nsf_noise=torch.randn((1, 32 * 128, 9), generator=g))
        on_card = svs.synthesize(small, **{k: v.to(dev) for k, v in pins.items()})
        cpu = copy.copy(svs)
        cpu.device = torch.device("cpu")
        cpu.model, cpu.pe, cpu.vocoder = (copy.deepcopy(m).cpu() for m in
                                          (svs.model, svs.pe, svs.vocoder))
        on_cpu = cpu.synthesize(small, **pins)
        mel_err = rel_err(on_card["mel"].cpu(), on_cpu["mel"])[0]
        wav_err = rel_err(on_card["wav"].cpu(), on_cpu["wav"])[0]
        # the port's parity bounds against the JAX package (tests/test_torch_pipeline.py)
        small_ok = mel_err <= 1e-3 and wav_err <= 2e-3
        ph.done(" | ".join(lines)
                + f" | card vs CPU on 16 tokens/32 frames: mel max err {mel_err:.3e} (tol 1e-3),"
                f" wav max err {wav_err:.3e} (tol 2e-3) {'ok' if small_ok else 'MISMATCH'}")
        if not small_ok:
            return 1
        del cpu

    kernels = []
    with Phase("6 kernels at the path's shapes") as ph:
        # every shape phases 5 and 7 give the kernels: outputs held against the
        # plain versions on the same inputs, then timed
        k1_lines, bad = [], []
        for B, T, reps in ((4, 256, 20), (32, 1024, 2)):
            gen.manual_seed(5 + B)
            args = k1_inputs(B, T, C, L, gen, dev)
            got = diffnet_stack.residual_stack(*args, dils)
            err, rel = rel_err(got, diffnet_stack.residual_stack_plain(*args, dils))
            results["k1_err"] = max(results["k1_err"], err)
            if rel > diffnet_stack.TOLERANCE:
                bad.append(f"K1 B={B} T={T}")
            del got
            ms = cuda_ms(lambda: diffnet_stack.residual_stack(*args, dils), reps=reps)
            plain = cuda_ms(lambda: diffnet_stack.residual_stack_plain(*args, dils), reps=reps)
            bound = 1e3 * max(diffnet_stack.stack_flops(B, T, C, L) / FP32_PEAK,
                              diffnet_stack.stack_bytes(B, T, C, L) / HBM_RATE)
            del args
            k1_lines.append(f"B={B} T={T}: {ms:.3f} ms (plain {plain:.3f}, bound {bound:.3f}), "
                            f"err {err:.3e}/{rel:.3e}")
            if B == 4:
                k1_ms, k1_plain, k1_bound = ms, plain, bound
        kernels.append(dict(
            name="fused_residual_stack", route="cuda",
            source="bisinger_tpu_torch/csrc/diffnet_stack.cu",
            replaces="bisinger_tpu/ops/diffnet_pallas.py:214",
            launches=launches["k1"], max_abs_err=results["k1_err"], ms=k1_ms, plain_ms=k1_plain,
            bound_ms=k1_bound, bound_by="operations", library_ms=None))
        hp = svs.hp
        rk, rd = hp["resblock_kernel_sizes"], hp["resblock_dilation_sizes"]
        k2_lines = []
        for B, T, reps in ((4, 256, 5), (32, 1024, 1)):
            tot = dict(ms=0.0, plain=0.0, lib=0.0, bound=0.0)
            stages = []
            F, U = hp["upsample_initial_channel"], T
            for u in hp["upsample_rates"]:
                F, U = F // 2, U * u
                x, w, b = k2_inputs(B, U, F, rk, rd, gen, dev)
                got = mrf_stage.mrf_stage(x, w, b, rk, rd)
                err, rel = rel_err(got, mrf_stage.mrf_stage_plain(x, w, b, rk, rd))
                results[f"k2_err_{B}_{F}"] = err
                if rel > mrf_stage.TOLERANCE:
                    bad.append(f"K2 B={B} U={U} F={F}")
                del got
                ms = cuda_ms(lambda: mrf_stage.mrf_stage(x, w, b, rk, rd), reps=reps)
                plain = cuda_ms(lambda: mrf_stage.mrf_stage_plain(x, w, b, rk, rd), reps=reps)
                lib = cuda_ms(lambda: mrf_stage.mrf_stage_conv1d(x, w, b, rk, rd), reps=reps)
                del x, w, b
                fl = mrf_stage.stage_flops(B, U, F, rk, rd) / FP32_PEAK
                by = mrf_stage.stage_bytes(B, U, F, rk, rd) / HBM_RATE
                bound = 1e3 * max(fl, by)
                for key, v in (("ms", ms), ("plain", plain), ("lib", lib), ("bound", bound)):
                    tot[key] += v
                stages.append(f"F={F} U={U} {ms:.3f} ms (plain {plain:.3f}, conv1d {lib:.3f}, "
                              f"bound {bound:.3f} by {'operations' if fl >= by else 'bytes'}), "
                              f"err {err:.3e}/{rel:.3e}")
            k2_lines.append(f"B={B} T={T}, one vocoder pass {tot['ms']:.3f} ms (plain "
                            f"{tot['plain']:.3f}, conv1d {tot['lib']:.3f}, bound "
                            f"{tot['bound']:.3f}): " + "; ".join(stages))
            if B == 4:
                k2_tot = tot
        kernels.append(dict(
            name="fused_mrf_stage", route="cuda", source="bisinger_tpu_torch/csrc/mrf_stage.cu",
            replaces="bisinger_tpu/ops/mrf_pallas.py:366", launches=launches["k2"],
            max_abs_err=max(v for k, v in results.items() if k.startswith("k2_err")),
            ms=k2_tot["ms"], plain_ms=k2_tot["plain"], bound_ms=k2_tot["bound"],
            bound_by="operations", library_ms=k2_tot["lib"]))
        ph.done(f"tolerances K1 {diffnet_stack.TOLERANCE:g}, K2 {mrf_stage.TOLERANCE:g} "
                "(max_abs_err/relative); K1 per call: " + "; ".join(k1_lines) + " | K2: "
                + " | ".join(k2_lines) + (f"; MISMATCH at {bad}" if bad else "; ok"))
        if bad:
            return 1

    with Phase("7 path times") as ph:
        # warm synthesize() wall times, ending in a synchronize; audio seconds
        # made per second at 24 kHz, hop 128
        lines = []
        for B, T, warm in ((4, 256, True), (32, 1024, False)):
            b = make_batch(B, 64, T, vocab, seed=B)
            reps = 2 if warm else 1
            if warm:
                svs.synthesize(b, generator=gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                svs.synthesize(b, generator=gen)
            torch.cuda.synchronize()
            secs = (time.perf_counter() - t0) / reps
            audio = B * T * 128 / 24000
            lines.append(f"B={B} T={T}: {secs:.3f} s per call, {audio / secs:.2f} audio-s/s"
                         + ("" if warm else " (first call at this shape)"))
        ph.done("; ".join(lines))

    total = time.perf_counter() - T_START
    log(f"[total] {total:.1f} s (budget {BUDGET_S:.0f} s, target 300 s)")
    if total > BUDGET_S:
        return 1
    log(smi)  # the card and its power limit, as nvidia-smi gives them
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
