"""The training loop of the port (counterpart of
`bisinger_tpu/training/trainer.py`), on one device or data-parallel, one
process a rank (`parallel/mesh.py`):

  - batches from the device-resident corpus (`device_resident_corpus`,
    the flagship's) or from the streaming `DataLoader` behind a
    `Prefetcher` thread (`dataloader_prefetch`, default depth 2), copied
    to the device on the training thread or, with
    `dataloader_prefetch_put: worker`, on the prefetch thread (`DevicePut`);
  - a sanity validation before the first step (`num_sanity_val_steps`),
    a validation and a checkpoint every `val_check_interval` updates and
    at the end, the newest `num_ckpt_keep` checkpoints kept (with
    `save_best`, the `num_ckpt_keep` of lowest val_loss); a task with
    an `export` (the PitchExtractor's) also writes its serving files into
    the work dir at each checkpoint;
  - resume from the latest checkpoint (`| resumed from step N`), else the
    diffusion stage's warm start from `fs2_ckpt`, which fails loudly when
    the path holds nothing;
  - SIGTERM or SIGINT during `fit` checkpoints at the next step boundary
    and returns;
  - `save_codes` (default on): rank 0 copies the package's source into
    work_dir/codes/<timestamp> (`snapshot_code`);
  - `| step N [tr] ...` and `| step N [val] ...` lines on stdout. There is
    no TensorBoard writer, so no validation media, as the JAX package
    skips them without one.

The losses accumulate on the device and are read once per `log_interval`
steps. Dropout masks and the diffusion draws come from one generator on
the device, seeded by `seed` and saved with each checkpoint.

Data-parallel, as JAX's trainer on a `data` axis of N devices
(`bisinger_tpu/training/trainer.py:39-116, 161-189, 393-445`): the loaders
give each rank its rows of one global batch padded to a multiple of N; with
`mesh_shape.model` M > 1 (JAX's ('data', 'model') mesh, `trainer.py:95-98`:
the state replicated, the batch sharded over `data` only) N is the world
over M, the ranks of one data index take the same rows and the same step,
and the batch's collectives run on the data group of the rank's model index
(`parallel/groups.training_mesh`); the
task's step is its share of the global step; validation averages the
ranks' (weighted sum, count) pairs before dividing (`Meter`); rank 0 alone
writes `config.json`, the log lines, the checkpoints and the PE's export,
and every rank waits at a barrier after a save and restores or warm-starts
from the same files. After init, restore or warm start the parameters and
buffers are broadcast from rank 0, and a digest of the whole state
(parameters, buffers, optimizer, generator) must agree on every rank, then
and after the last step, or the run raises. SIGTERM or SIGINT on any rank
stops every rank at the same step boundary.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bisinger_tpu_torch.data.dataset import DataLoader, M4SingerDataset, batch_to_device
from bisinger_tpu_torch.data.prefetch import DevicePut, Prefetcher
from bisinger_tpu_torch.parallel import groups
from bisinger_tpu_torch.parallel import mesh as dp
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


class Meter:
    """Row-weighted means of metrics, the non-finite values left out."""

    def __init__(self):
        self.sums: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        # the metrics' names, non-finite values included: the same on every
        # rank (every rank runs the same steps), so safe to reduce over
        self.keys: set = set()

    def update(self, metrics: Dict[str, torch.Tensor], n: int = 1):
        for k, v in metrics.items():
            self.keys.add(k)
            v = float(v)
            if np.isfinite(v):
                self.sums[k] = self.sums.get(k, 0.0) + v * n
                self.counts[k] = self.counts.get(k, 0) + n

    def cross_process_averages(self) -> Dict[str, float]:
        """The means over every rank's rows: the (weighted sum, count) pairs
        summed over the ranks before dividing (JAX `trainer.py:65-86`); on
        one process the local means."""
        keys = sorted(self.keys)
        tot = torch.tensor([[self.sums.get(k, 0.0) for k in keys],
                            [float(self.counts.get(k, 0)) for k in keys]], dtype=torch.float64)
        tot = dp.all_reduce_sum(tot)
        return {k: float(tot[0, i]) / max(float(tot[1, i]), 1.0) for i, k in enumerate(keys)
                if tot[1, i] > 0}


class Trainer:
    def __init__(self, task, hp, work_dir: Optional[str] = None):
        self.task = task
        self.hp = hp
        self.device = task.device
        self.rank = dp.rank()
        self.is_main = self.rank == 0
        self.mesh = groups.training_mesh(hp.get("mesh_shape"))
        # the batch's shards: the data axis (the world unless mesh_shape.model > 1)
        self.n_data, self.data_index = dp.data_size(), dp.data_rank()
        self.work_dir = work_dir or hp.get("work_dir") or "checkpoints/default"
        os.makedirs(self.work_dir, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(self.work_dir, "ckpt"),
                                      max_to_keep=hp["num_ckpt_keep"],
                                      save_best=hp.get("save_best", False))
        self.global_step = 0
        self.corpus_bytes = 0  # the device-resident corpus's, when there is one
        self.loop_started = None  # perf_counter at the first train step of the last fit
        self.generator = torch.Generator(device=self.device).manual_seed(int(hp["seed"]))
        self._preempted = False
        # (global step, perf_counter, averaged metrics) at each train log line,
        # (global step, averaged metrics) at each validation
        self.train_log: List[tuple] = []
        self.val_log: List[tuple] = []
        # every rank has read the work dir's config.json (run.load_config)
        # before rank 0 rewrites it
        dp.barrier()
        if self.is_main:
            path = os.path.join(self.work_dir, "config.json")
            with open(path + ".tmp", "w") as f:
                json.dump(hp, f, indent=2, default=str)
            os.replace(path + ".tmp", path)
            if hp.get("save_codes", True):
                self.snapshot_code()

    def snapshot_code(self) -> Optional[str]:
        """Copy the package's source (without `_build/` and bytecode) into
        work_dir/codes/<%Y%m%d%H%M%S>/bisinger_tpu_torch, as JAX's trainer
        copies its package (`bisinger_tpu/training/trainer.py:114-138`);
        best-effort, as there. Returns the copy's directory, or None where
        one of that second exists or the copy failed."""
        src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        dst = os.path.join(self.work_dir, "codes", time.strftime("%Y%m%d%H%M%S"))
        if os.path.exists(dst):
            return None
        try:
            shutil.copytree(src, os.path.join(dst, "bisinger_tpu_torch"),
                            ignore=shutil.ignore_patterns("_build", "__pycache__", "*.pyc",
                                                          "*.so", "*.o"))
        except OSError:
            return None
        return dst

    def say(self, msg: str):
        if self.is_main:
            print(msg, flush=True)

    def log(self, metrics: Dict[str, float], prefix: str = "tr"):
        self.say(f"| step {self.global_step} [{prefix}] "
                 + " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())))

    # ---- data ------------------------------------------------------------
    def build_dataloaders(self):
        hp = self.hp
        train_ds = M4SingerDataset(hp, hp["train_set_name"], shuffle=True)
        valid_ds = M4SingerDataset(hp, hp["valid_set_name"], shuffle=False)
        shards = dict(batch_multiple=self.n_data, shard_index=self.data_index,
                      num_shards=self.n_data)
        train_dl = DataLoader(train_ds, hp, shuffle=True, endless=True, seed=hp["seed"],
                              **shards)
        valid_dl = DataLoader(
            valid_ds, hp, shuffle=False,
            max_tokens=hp["max_eval_tokens"] if hp["max_eval_tokens"] > 0 else hp["max_tokens"],
            max_sentences=max(hp["max_eval_sentences"], 1) if hp["max_eval_sentences"] > 0
            else self.n_data, **shards)
        return train_dl, valid_dl

    def _train_batches(self, train_dl):
        """(iterator of device batches, the prefetcher to close or None)."""
        hp = self.hp
        if hp.get("device_resident_corpus"):
            from bisinger_tpu_torch.data.device_corpus import DeviceResidentFeeder

            feeder = DeviceResidentFeeder(train_dl.dataset, hp, self.device, seed=hp["seed"],
                                          shard_index=self.data_index,
                                          num_shards=self.n_data)
            self.corpus_bytes = feeder.bytes_resident
            self.say(f"| device-resident corpus: {feeder.n_items} items, "
                     f"{feeder.bytes_resident / 1e6:.0f} MB on {self.device}")
            return iter(feeder), None
        depth = int(hp.get("dataloader_prefetch", 2) or 0)
        put_on = str(hp.get("dataloader_prefetch_put", "main"))
        if put_on not in ("main", "worker"):
            raise ValueError(f"dataloader_prefetch_put must be 'main' or 'worker', got {put_on!r}")
        if depth > 0 and put_on == "worker":  # the copy to the device on the prefetch thread
            put = DevicePut(self.device)
            prefetcher = Prefetcher(iter(train_dl), depth=depth, transform=put.stage)
            return map(put.take, prefetcher), prefetcher
        to_dev = lambda b: batch_to_device(b, self.device)  # noqa: E731
        if depth > 0:
            prefetcher = Prefetcher(iter(train_dl), depth=depth)
            return map(to_dev, prefetcher), prefetcher
        return map(to_dev, iter(train_dl)), None

    # ---- state -----------------------------------------------------------
    def save(self, val_loss: float):
        """Rank 0 writes the checkpoint with its `val_loss` (and the PE's
        export); every rank waits until it is complete."""
        if self.is_main:
            st = self.task.state()
            self.ckpt.save(self.global_step, st["params"], st["opt_state"],
                           self.generator.get_state(), metrics={"val_loss": val_loss})
            export = getattr(self.task, "export", None)
            if export is not None:  # the PitchExtractor's files for serving
                export(self.work_dir)
        dp.barrier()

    def state_tensors(self) -> List[torch.Tensor]:
        """Everything a step reads and writes: the parameters, the buffers
        (the PE's running statistics), the optimizer's state and counters,
        the generator's state."""
        opt = self.task.opt.state_dict()
        return (list(self.task.model.parameters()) + list(self.task.model.buffers())
                + [v if torch.is_tensor(v) else torch.tensor(v) for v in opt.values()]
                + [self.generator.get_state()])

    def agree(self, what: str) -> str:
        """Data-parallel: the state's digest, checked equal on every rank."""
        return dp.check_identical(self.state_tensors(), f"state {what}")

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
            self.say(f"| resumed from step {self.global_step}")
        elif hp.get("fs2_ckpt") and hasattr(self.task, "warm_start_fs2"):
            params, subtree = load_fs2_params(hp["fs2_ckpt"])
            self.task.warm_start_fs2(params, subtree)
            self.say(f"| warm-started fs2 from {hp['fs2_ckpt']}")
        if dp.active():
            model = self.task.model
            dp.broadcast_(list(model.parameters()) + list(model.buffers()))
            self.agree(f"at step {self.global_step}")
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
                if dp.active():  # the gradients' all-reduce, ms a step
                    avg["allreduce_ms"] = self.task.reduce_gradients.take_ms() / tcount
                self.train_log.append((self.global_step, time.perf_counter(), avg))
                self.log(avg, "tr")
                msum, mcount = None, 0
                t0, tcount = time.time(), 0
            # a signal may reach the ranks a step apart: every rank stops at
            # the first boundary where any rank has it
            if dp.any_rank(self._preempted):
                if hp.get("save_ckpt", True):
                    # no validation in a preemption's grace window: the
                    # sentinel keeps save_best from ever choosing this one
                    self.save(1e30)
                    self.say(f"| preemption checkpoint saved at step {self.global_step}")
                return
            if self.global_step % hp["val_check_interval"] == 0:
                val_loss = self._run_validation(valid_dl)
                if hp.get("save_ckpt", True):
                    self.save(val_loss)
                t0, tcount = time.time(), 0
        if hp.get("save_ckpt", True) and self.global_step % hp["val_check_interval"] != 0:
            self.save(self._run_validation(valid_dl))
        if dp.active():
            self.agree(f"after step {self.global_step}")

    def validate(self) -> float:
        """Restore the latest checkpoint and run one full validation pass."""
        _, valid_dl = self.build_dataloaders()
        if not self.restore():
            raise FileNotFoundError(f"no checkpoint under {self.work_dir!r} to validate")
        self.say(f"| validating checkpoint at step {self.global_step}")
        return self._run_validation(valid_dl)

    def _step_flags(self):
        flags = getattr(self.task, "step_flags", None)
        return flags(self.global_step) if flags is not None else {}

    def _run_validation(self, valid_dl, limit: Optional[int] = None) -> float:
        """Mean losses over the validation batches, weighted by their rows
        (every rank's); the draws of the diffusion stage from a generator
        seeded the same way at every validation."""
        gen = torch.Generator(device=self.device).manual_seed(int(self.hp["seed"]))
        meter = Meter()
        for i, batch in enumerate(valid_dl):
            if limit is not None and i >= limit:
                break
            losses = self.task.val_step(batch_to_device(batch, self.device), gen,
                                        **self._step_flags())
            meter.update(losses, int(batch["txt_tokens"].shape[0]))
        avg = meter.cross_process_averages()
        self.val_log.append((self.global_step, avg))
        self.log(avg, "val")
        return avg.get("total_loss", float("inf"))
