"""The training loop of the port on one device (counterpart of
`bisinger_tpu/training/trainer.py`, single process):

  - batches from the device-resident corpus (`device_resident_corpus`,
    the flagship's) or from the streaming `DataLoader` behind a
    `Prefetcher` thread (`dataloader_prefetch`, default depth 2);
  - a sanity validation before the first step (`num_sanity_val_steps`),
    a validation and a checkpoint every `val_check_interval` updates and
    at the end, the newest `num_ckpt_keep` checkpoints kept; a task with
    an `export` (the PitchExtractor's) also writes its serving files into
    the work dir at each checkpoint;
  - resume from the latest checkpoint (`| resumed from step N`), else the
    diffusion stage's warm start from `fs2_ckpt`, which fails loudly when
    the path holds nothing;
  - SIGTERM or SIGINT during `fit` checkpoints at the next step boundary
    and returns;
  - `| step N [tr] ...` and `| step N [val] ...` lines on stdout. There is
    no TensorBoard writer, so no validation media, as the JAX package
    skips them without one.

The losses accumulate on the device and are read once per `log_interval`
steps. Dropout masks and the diffusion draws come from one generator on
the device, seeded by `seed` and saved with each checkpoint.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bisinger_tpu_torch.data.dataset import DataLoader, M4SingerDataset, batch_to_device
from bisinger_tpu_torch.data.prefetch import Prefetcher
from bisinger_tpu_torch.training.checkpoints import CheckpointManager
from bisinger_tpu_torch.weights import load_npz


def load_fs2_params(path: str):
    """The FFT-Singer stage's parameters for the warm start, as (flat
    params, subtree): from an npz file or from the latest checkpoint of a
    port work dir; a diffusion model's parameters give their `fs2/`
    subtree. Raises when the path holds none."""
    if path.endswith(".npz"):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"fs2_ckpt={path!r}: no such file")
        flat = load_npz(path)
    else:
        ckpt_dir = os.path.join(path, "ckpt")
        if not os.path.isdir(ckpt_dir):
            raise FileNotFoundError(
                f"fs2_ckpt={path!r}: no checkpoint dir {ckpt_dir!r} (train the FFT-Singer "
                "stage first, point fs2_ckpt at an npz of its parameters, or unset it to "
                "train from scratch)")
        restored = CheckpointManager(ckpt_dir).restore()
        if restored is None:
            raise FileNotFoundError(f"fs2_ckpt dir {ckpt_dir!r} contains no saved step")
        flat = restored["params"]
    return flat, "fs2" if any(k.startswith("fs2/") for k in flat) else ""


class Trainer:
    def __init__(self, task, hp, work_dir: Optional[str] = None):
        self.task = task
        self.hp = hp
        self.device = task.device
        self.work_dir = work_dir or hp.get("work_dir") or "checkpoints/default"
        os.makedirs(self.work_dir, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(self.work_dir, "ckpt"),
                                      max_to_keep=hp["num_ckpt_keep"])
        self.global_step = 0
        self.corpus_bytes = 0  # the device-resident corpus's, when there is one
        self.loop_started = None  # perf_counter at the first train step of the last fit
        self.generator = torch.Generator(device=self.device).manual_seed(int(hp["seed"]))
        self._preempted = False
        # (global step, perf_counter, averaged metrics) at each train log line
        self.train_log: List[tuple] = []
        with open(os.path.join(self.work_dir, "config.json"), "w") as f:
            json.dump(hp, f, indent=2, default=str)

    def log(self, metrics: Dict[str, float], prefix: str = "tr"):
        msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
        print(f"| step {self.global_step} [{prefix}] {msg}", flush=True)

    # ---- data ------------------------------------------------------------
    def build_dataloaders(self):
        hp = self.hp
        train_ds = M4SingerDataset(hp, hp["train_set_name"], shuffle=True)
        valid_ds = M4SingerDataset(hp, hp["valid_set_name"], shuffle=False)
        train_dl = DataLoader(train_ds, hp, shuffle=True, endless=True, seed=hp["seed"])
        valid_dl = DataLoader(
            valid_ds, hp, shuffle=False,
            max_tokens=hp["max_eval_tokens"] if hp["max_eval_tokens"] > 0 else hp["max_tokens"],
            max_sentences=max(hp["max_eval_sentences"], 1) if hp["max_eval_sentences"] > 0
            else 1)
        return train_dl, valid_dl

    def _train_batches(self, train_dl):
        """(iterator of device batches, the prefetcher to close or None)."""
        hp = self.hp
        if hp.get("device_resident_corpus"):
            from bisinger_tpu_torch.data.device_corpus import DeviceResidentFeeder

            feeder = DeviceResidentFeeder(train_dl.dataset, hp, self.device, seed=hp["seed"])
            self.corpus_bytes = feeder.bytes_resident
            print(f"| device-resident corpus: {feeder.n_items} items, "
                  f"{feeder.bytes_resident / 1e6:.0f} MB on {self.device}", flush=True)
            return iter(feeder), None
        depth = int(hp.get("dataloader_prefetch", 2) or 0)
        to_dev = lambda b: batch_to_device(b, self.device)  # noqa: E731
        if depth > 0:
            prefetcher = Prefetcher(iter(train_dl), depth=depth)
            return map(to_dev, prefetcher), prefetcher
        return map(to_dev, iter(train_dl)), None

    # ---- state -----------------------------------------------------------
    def save(self):
        st = self.task.state()
        self.ckpt.save(self.global_step, st["params"], st["opt_state"],
                       self.generator.get_state())
        export = getattr(self.task, "export", None)
        if export is not None:  # the PitchExtractor's files for serving
            export(self.work_dir)

    def restore(self) -> bool:
        restored = self.ckpt.restore()
        if restored is None:
            return False
        self.task.load_state(restored["params"], restored["opt_state"])
        self.generator.set_state(restored["rng_state"])
        self.global_step = int(restored["step"])
        return True

    # ---- loop ------------------------------------------------------------
    def fit(self, max_updates: Optional[int] = None, on_step=None):
        """Train to `max_updates` (default hp max_updates); `on_step(step,
        metrics)` is called after each train step."""
        hp = self.hp
        max_updates = max_updates or hp["max_updates"]
        train_dl, valid_dl = self.build_dataloaders()
        self.task.configure_accumulation(train_dl.batches_per_epoch())
        if self.restore():
            print(f"| resumed from step {self.global_step}", flush=True)
        elif hp.get("fs2_ckpt") and hasattr(self.task, "warm_start_fs2"):
            params, subtree = load_fs2_params(hp["fs2_ckpt"])
            self.task.warm_start_fs2(params, subtree)
            print(f"| warm-started fs2 from {hp['fs2_ckpt']}", flush=True)
        train_iter, prefetcher = self._train_batches(train_dl)
        prev = {}
        if threading.current_thread() is threading.main_thread():
            def on_signal(signum, frame):
                if not self._preempted:
                    print(f"| caught signal {signum}: checkpointing at the next step "
                          "boundary, then exiting", flush=True)
                self._preempted = True

            for sig in (signal.SIGTERM, signal.SIGINT):
                prev[sig] = signal.signal(sig, on_signal)
        try:
            return self._fit_loop(max_updates, train_iter, valid_dl, on_step)
        finally:
            for sig, h in prev.items():
                signal.signal(sig, h)
            if prefetcher is not None:
                prefetcher.close()

    def _fit_loop(self, max_updates, train_iter, valid_dl, on_step):
        hp = self.hp
        if hp["num_sanity_val_steps"] > 0 and self.global_step == 0:
            self._run_validation(valid_dl, limit=hp["num_sanity_val_steps"])
        msum, mcount = None, 0
        t0, tcount = time.time(), 0
        self.loop_started = time.perf_counter()
        while self.global_step < max_updates:
            batch = next(train_iter)
            metrics = self.task.train_step(batch, self.generator, **self._step_flags())
            self.global_step += 1
            if on_step is not None:
                on_step(self.global_step, metrics)
            msum = metrics if msum is None else {k: msum[k] + v for k, v in metrics.items()}
            mcount += 1
            tcount += 1
            if self.global_step % hp["log_interval"] == 0:
                avg = {k: float(v) / mcount for k, v in msum.items()}
                avg["steps_per_s"] = tcount / max(time.time() - t0, 1e-9)
                self.train_log.append((self.global_step, time.perf_counter(), avg))
                self.log(avg, "tr")
                msum, mcount = None, 0
                t0, tcount = time.time(), 0
            if self._preempted:
                if hp.get("save_ckpt", True):
                    self.save()
                    print(f"| preemption checkpoint saved at step {self.global_step}",
                          flush=True)
                return
            if self.global_step % hp["val_check_interval"] == 0:
                self._run_validation(valid_dl)
                if hp.get("save_ckpt", True):
                    self.save()
                t0, tcount = time.time(), 0
        if hp.get("save_ckpt", True) and self.global_step % hp["val_check_interval"] != 0:
            self._run_validation(valid_dl)
            self.save()

    def validate(self) -> float:
        """Restore the latest checkpoint and run one full validation pass."""
        _, valid_dl = self.build_dataloaders()
        if not self.restore():
            raise FileNotFoundError(f"no checkpoint under {self.work_dir!r} to validate")
        print(f"| validating checkpoint at step {self.global_step}", flush=True)
        return self._run_validation(valid_dl)

    def _step_flags(self):
        flags = getattr(self.task, "step_flags", None)
        return flags(self.global_step) if flags is not None else {}

    def _run_validation(self, valid_dl, limit: Optional[int] = None) -> float:
        """Mean losses over the validation batches, weighted by their rows;
        the draws of the diffusion stage from a generator seeded the same
        way at every validation."""
        gen = torch.Generator(device=self.device).manual_seed(int(self.hp["seed"]))
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for i, batch in enumerate(valid_dl):
            if limit is not None and i >= limit:
                break
            n = int(batch["txt_tokens"].shape[0])
            losses = self.task.val_step(batch_to_device(batch, self.device), gen,
                                        **self._step_flags())
            for k, v in losses.items():
                v = float(v)
                if np.isfinite(v):
                    sums[k] = sums.get(k, 0.0) + v * n
                    counts[k] = counts.get(k, 0) + n
        avg = {k: sums[k] / max(counts[k], 1) for k in sums}
        self.log(avg, "val")
        return avg.get("total_loss", float("inf"))
