"""Checkpoints of the port's trainer (counterpart of
`bisinger_tpu/training/checkpoints.py`, which writes orbax trees).

One directory per saved step, `<directory>/<step>/`:
  - `params.npz`: the model's parameters under their flat flax keys, in
    flax's layout (`weights.export_flax_params`): the file
    `weights.load_flax_params` reads and a server loads;
  - `opt_state.npz`: the optimizer's moments and accumulated gradients
    under the parameters' state_dict names;
  - `meta.json`: the step and the optimizer's counters;
  - `rng_state.npy`: the trainer generator's state.
A step is written into a temporary directory and renamed into place, so a
directory with `meta.json` is complete; the newest `max_to_keep` stay.
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
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self.directory, d,
                                                                      "meta.json")))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, params: Dict[str, np.ndarray], opt_state: Dict[str, Any],
             rng_state: torch.Tensor):
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
            json.dump({"step": int(step), "optimizer": counters}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        for old in self.steps()[:-self.max_to_keep] if self.max_to_keep > 0 else []:
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
