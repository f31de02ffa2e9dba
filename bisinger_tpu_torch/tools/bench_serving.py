"""Request latency and micro-batching under concurrent HTTP load (the port's
counterpart of `scripts/bench_serving.py`).

    python -m bisinger_tpu_torch.tools.bench_serving

Scores -> wavs through the port's HTTP server (`inference/server.serve`)
and its micro-batcher on the card: a production-size model with random
weights (hidden 256, 4 + 4 FFT layers, a 20 x 256 DiffNet through K1, K=1000
at PLMS speedup 5, the 512-channel NSF HiFi-GAN through K2; valid for
latency and throughput, not for quality), saved as a training run's work
dir and served by `SVSInferTorch.from_work_dir` over the phone set of a
6-item synthetic corpus. Client threads send SB_N requests, SB_CONC at a
time; each batch-axis bucket is warmed up first.

Knobs, as the JAX script's: SB_PLATFORM (`cpu` for the CPU and a tiny
model: a 2 x 32 DiffNet, which K1 takes, but a 32-channel HiFi-GAN whose
MRF stages run at F = 16, 8, 4 and 2, and K2 takes F >= 8 only, so the
tiny model stays on the CPU; else the card), SB_N (48; 16 on the CPU), SB_CONC (16; 8 on the
CPU), SB_MAX_BATCH (8; 0/1 the serial lock path), SB_WINDOW_MS (25),
SB_COMPARE (1: the serial baseline after the batched run), SB_SAMPLER
(plms; dpmpp the 40-call DPM-Solver++). Prints one JSON line a metric: the
p50, p95 and p99 per-request latencies and the throughput in the score's
own audio seconds a second with requests/s and the mean group size, each
with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import queue
import sys
import tempfile
import threading
import time
import urllib.request

SCORES = [
    {"text": "SP wo xi huan ni circle SP",
     "notes": "rest | C4 | D4 | E4 | F4 | G4 A4 | rest",
     "notes_duration": "0.1 | 0.3 | 0.3 | 0.3 | 0.3 | 0.2 0.2 | 0.1"},
    {"text": "AP ni hao shi jie hello world AP",
     "notes": "rest | C4 | D4 | E4 | F4 | G4 | A4 G4 | rest",
     "notes_duration": "0.1 | 0.25 | 0.25 | 0.3 | 0.3 | 0.4 | 0.3 0.2 | 0.1"},
    {"text": "SP la la la la SP",
     "notes": "rest | C4 | E4 | G4 | C5 | rest",
     "notes_duration": "0.1 | 0.4 | 0.4 | 0.4 | 0.6 | 0.1"},
]


def log(msg):
    print(f"[bench_serving] {msg}", file=sys.stderr, flush=True)


def build_infer(tmp: str, dev):
    """A random-weight model saved as a work dir (checkpoint step 1) and a
    random NSF generator in an assets dir, served by from_work_dir."""
    import numpy as np
    import torch

    from bisinger_tpu_torch.config import make_hparams
    from bisinger_tpu_torch.data.binarizer import M4SingerBinarizer
    from bisinger_tpu_torch.data.synthetic import make_synthetic_corpus
    from bisinger_tpu_torch.inference.pipeline import SVSInferTorch
    from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
    from bisinger_tpu_torch.training.checkpoints import CheckpointManager
    from bisinger_tpu_torch.training.tasks import DiffSingerMIDITask
    from bisinger_tpu_torch.training.vocoder_task import flax_init_ as voc_init_
    from bisinger_tpu_torch.utils.text_encoder import build_phone_encoder
    from bisinger_tpu_torch.weights import export_flax_params

    raw = os.path.join(tmp, "raw")
    make_synthetic_corpus(raw, n_items=6, seed=0)
    size = (dict(hidden_size=32, enc_layers=1, dec_layers=1, num_heads=2, residual_layers=2,
                 residual_channels=32, timesteps=8, K_step=8, pndm_speedup=2,
                 upsample_initial_channel=32)
            if dev.type == "cpu" else
            dict(hidden_size=256, enc_layers=4, dec_layers=4, residual_layers=20,
                 residual_channels=256, dilation_cycle_length=4, timesteps=1000, K_step=1000,
                 schedule_type="linear", max_beta=0.02, pndm_speedup=5, gaussian_start=True,
                 upsample_initial_channel=512,
                 diff_sampler=os.environ.get("SB_SAMPLER", "plms")))
    hp = make_hparams(dict(
        raw_data_dir=raw, raw_json_fn="meta.json", binary_data_dir=os.path.join(tmp, "bin"),
        dur_predictor_layers=2, predictor_layers=2, use_pitch_embed=False, num_spk=4,
        max_words=16, bucket_tokens=[64], bucket_frames=[512], upsample_rates=[8, 4, 2, 2],
        upsample_kernel_sizes=[16, 8, 4, 4], test_num=1, **size))
    M4SingerBinarizer(hp).process()
    vocab = build_phone_encoder(hp["binary_data_dir"]).vocab_size
    task = DiffSingerMIDITask(hp, vocab, device="cpu")
    work, assets = os.path.join(tmp, "work"), os.path.join(tmp, "assets")
    os.makedirs(os.path.join(assets, "vocoder"))
    os.makedirs(work)
    with open(os.path.join(work, "config.json"), "w") as f:
        json.dump(hp, f)
    st = task.state()
    CheckpointManager(os.path.join(work, "ckpt")).save(1, st["params"], st["opt_state"],
                                                       torch.Generator().get_state())
    with open(os.path.join(assets, "hparams_diff.json"), "w") as f:
        json.dump(hp, f)
    np.savez(os.path.join(assets, "vocoder", "generator_000000000.npz"),
             **export_flax_params(voc_init_(HifiGanGenerator(hp), 0)))
    return SVSInferTorch.from_work_dir(work, assets, device=dev), hp


def run_load(port: int, n: int, conc: int):
    """n requests from conc client threads: [(latency s, the score's own
    audio s)] and the wall time."""
    work_q: "queue.Queue" = queue.Queue()
    for i in range(n):
        work_q.put(SCORES[i % len(SCORES)])
    results, lock = [], threading.Lock()

    def client():
        while True:
            try:
                score = work_q.get_nowait()
            except queue.Empty:
                return
            req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize",
                                         data=json.dumps(score).encode(),
                                         headers={"Content-Type": "application/json"})
            # the intended length, from the score: random weights predict
            # near-zero durations, so the trimmed wav would undercount it
            score_s = sum(float(d) for grp in score["notes_duration"].split("|")
                          for d in grp.split())
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                r.read()
                if r.status != 200:
                    raise RuntimeError(f"HTTP {r.status}")
            dt = time.perf_counter() - t0
            with lock:
                results.append((dt, score_s))

    threads = [threading.Thread(target=client) for _ in range(conc)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return results, time.perf_counter() - t0


def percentile(sorted_values, q: float):
    """The JAX script's pick: the value at index int(len * q)."""
    return sorted_values[min(int(len(sorted_values) * q), len(sorted_values) - 1)]


def bench_mode(infer, hp, dev, max_batch: int, n: int, conc: int, window_ms: float):
    from bisinger_tpu_torch.inference.server import SVSRequestHandler, serve
    from bisinger_tpu_torch.tools.card import emit

    httpd = serve(infer, host="127.0.0.1", port=0, max_batch=max_batch,
                  batch_window_ms=window_ms)
    port = httpd.server_address[1]
    try:
        for b in [b for b in (hp.get("bucket_batch_sizes") or [1]) if b <= max(max_batch, 1)] \
                or [1]:
            t0 = time.perf_counter()
            infer.infer_batch([SCORES[i % len(SCORES)] for i in range(b)])
            log(f"warmup bucket B={b}: {time.perf_counter() - t0:.1f}s")
        results, wall = run_load(port, n, conc)
        sizes = list(getattr(SVSRequestHandler.batcher, "batch_sizes", []) or [])
    finally:
        httpd.shutdown()
    lats = sorted(dt for dt, _ in results)
    audio_s = sum(s for _, s in results)
    mode = f"mb{max_batch}" if max_batch > 1 else "serial"

    def row(metric, value, unit, **extra):
        emit({"metric": metric, "value": round(value, 3), "unit": unit,
              "vs_baseline": round(value, 3), **extra}, dev)

    row(f"serving_p50_latency_{mode}", percentile(lats, 0.5) * 1000,
        "ms (score->wav, concurrent load)")
    row(f"serving_p95_latency_{mode}", percentile(lats, 0.95) * 1000, "ms")
    row(f"serving_p99_latency_{mode}", percentile(lats, 0.99) * 1000, "ms")
    extra = {"requests_per_s": round(len(results) / wall, 3)}
    if sizes:
        extra["mean_batch"] = round(sum(sizes) / len(sizes), 2)
    row(f"serving_throughput_{mode}", audio_s / wall,
        f"scored-audio-s/s ({len(results)} reqs, conc={conc})", **extra)


def main() -> int:
    from bisinger_tpu_torch import full_fp32
    from bisinger_tpu_torch.tools.card import device_of

    full_fp32()
    dev = device_of(os.environ.get("SB_PLATFORM", ""))
    smoke = dev.type == "cpu"
    n = int(os.environ.get("SB_N", 16 if smoke else 48))
    conc = int(os.environ.get("SB_CONC", 8 if smoke else 16))
    max_batch = int(os.environ.get("SB_MAX_BATCH", 8))
    window_ms = float(os.environ.get("SB_WINDOW_MS", 25))
    with tempfile.TemporaryDirectory() as tmp:
        log(f"building the pipeline (smoke={smoke}) ...")
        infer, hp = build_infer(tmp, dev)
        bench_mode(infer, hp, dev, max_batch, n, conc, window_ms)
        if os.environ.get("SB_COMPARE", "1") == "1" and max_batch > 1:
            bench_mode(infer, hp, dev, 1, n, conc, window_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
