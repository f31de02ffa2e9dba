"""Checkpoints of the port's trainer (counterpart of
`bisinger_tpu/training/checkpoints.py`, which writes orbax trees).

One directory per saved step, `<directory>/<step>/`:
  - `params.npz`: the model's parameters under their flat flax keys, in
    flax's layout (`weights.export_flax_params`): the file
    `weights.load_flax_params` reads and a server loads;
  - `opt_state.npz`: the optimizer's moments and accumulated gradients
    under the parameters' state_dict names;
  - `meta.json`: the step, the optimizer's counters and the save's
    metrics (`val_loss`);
  - `rng_state.npy`: the trainer generator's state.
A step is written into a temporary directory and renamed into place, so a
directory with `meta.json` is complete. The newest `max_to_keep` stay; with
`save_best`, as orbax's manager with `best_fn` keeps them
(`bisinger_tpu/training/checkpoints.py:21-35`), the `max_to_keep` of lowest
`val_loss` (of two alike, the newer), a save without a `val_loss` kept
whatever it holds: a worse one is deleted as soon as it is written. The
trainer saves a preemption checkpoint with the sentinel 1e30, so it is
never among the best. `latest_step` (what a resume and a server load) is
the highest step kept.
`load_params_into` merges a source's parameters into a target's where the
names and shapes agree (the FFT-Singer warm start of the diffusion stage).
Data-parallel, rank 0 alone saves (its generator state is every rank's: the
ranks draw alike), the others wait at a barrier, and every rank restores
from the same directory (`training/trainer.py`).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from bisinger_tpu_torch.weights import load_npz


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, save_best: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_best = bool(save_best)
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self.directory, d,
                                                                      "meta.json")))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def metrics(self, step: int) -> Dict[str, float]:
        with open(os.path.join(self.directory, str(step), "meta.json")) as f:
            return json.load(f).get("metrics") or {}

    def _to_remove(self):
        """The steps past what `max_to_keep` (and `save_best`) keep."""
        steps = self.steps()
        if self.max_to_keep <= 0:
            return []
        if not self.save_best:
            return steps[:-self.max_to_keep]
        scored = [(self.metrics(s)["val_loss"], -s) for s in steps
                  if "val_loss" in self.metrics(s)]
        return sorted(-s for _, s in sorted(scored)[self.max_to_keep:])

    def save(self, step: int, params: Dict[str, np.ndarray], opt_state: Dict[str, Any],
             rng_state: torch.Tensor, metrics: Optional[Dict[str, float]] = None):
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "params.npz"), **params)
        counters = {k: int(v) for k, v in opt_state.items() if not torch.is_tensor(v)}
        np.savez(os.path.join(tmp, "opt_state.npz"),
                 **{k: v.detach().cpu().numpy() for k, v in opt_state.items()
                    if torch.is_tensor(v)})
        np.save(os.path.join(tmp, "rng_state.npy"), rng_state.cpu().numpy())
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": int(step), "optimizer": counters,
                       "metrics": {k: float(v) for k, v in (metrics or {}).items()}}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        for old in self._to_remove():
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def restore(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """{"step", "params", "opt_state", "rng_state"} of `step` (default
        the latest), or None when nothing is saved."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        d = os.path.join(self.directory, str(step))
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        opt_state = dict(meta["optimizer"])
        opt_state.update(load_npz(os.path.join(d, "opt_state.npz")))
        return {"step": meta["step"], "params": load_npz(os.path.join(d, "params.npz")),
                "opt_state": opt_state,
                "rng_state": torch.from_numpy(np.load(os.path.join(d, "rng_state.npy")))}


def load_params_into(target: Dict[str, np.ndarray], source: Dict[str, np.ndarray],
                     subtree: str = "") -> Dict[str, np.ndarray]:
    """Flat params: each target key takes the source's value where the
    source (under `subtree/`, if given) has the key with the same shape,
    and keeps its own elsewhere (the reference `utils.load_ckpt`,
    non-strict)."""
    if subtree:
        prefix = subtree.rstrip("/") + "/"
        source = {k[len(prefix):]: v for k, v in source.items() if k.startswith(prefix)}
    return {k: source[k] if k in source and np.shape(source[k]) == np.shape(v) else v
            for k, v in target.items()}
