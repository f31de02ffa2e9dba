"""The HiFi-GAN inference wrapper (counterpart of
`bisinger_tpu/vocoders/hifigan.py:29-142`).

`HifiGAN(hp)` loads the generator of the highest step among
`<vocoder_ckpt>/generator_*.npz`, by the step's number (a lexicographic
sort would take generator_00004000 after generator_000030000); there is
no random-init fallback: no file raises. `spec2wav` and `spec2wav_batch`
run it in eval mode (the MRF stages through K2), on the NSF path with the
given f0 when `use_nsf` is on, else without f0 (the plain HiFi-GAN; an f0
handed in is not used, as `vocoders/hifigan.py:81-120`), with PQMF
synthesis after a multiband generator; `save_params` writes
`generator_{step:09d}.npz`. Post-denoising is not ported (the generator
refuses `use_denoise`).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from bisinger_tpu_torch import resolve_device
from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
from bisinger_tpu_torch.models.pqmf import pqmf_from_hparams
from bisinger_tpu_torch.weights import export_flax_params, load_flax_params, load_npz


def step_of(path: str) -> int:
    m = re.search(r"generator_(\d+)\.npz$", path)
    return int(m.group(1)) if m else -1


def latest_generator(base_dir: str, recursive: bool = False) -> Optional[str]:
    """The generator_*.npz of the highest step under `base_dir` (at any
    depth when `recursive`), or None."""
    pattern = os.path.join(base_dir, "**", "generator_*.npz") if recursive else \
        os.path.join(base_dir, "generator_*.npz")
    cands = sorted(glob.glob(pattern, recursive=recursive), key=lambda p: (step_of(p), p))
    return cands[-1] if cands else None


class HifiGAN:
    def __init__(self, hp: dict, params: Optional[Dict[str, np.ndarray]] = None, device=None):
        """`params`: a flat flax dict of the generator; default the newest
        `generator_*.npz` of `hp["vocoder_ckpt"]`."""
        self.hp = hp
        self.device = resolve_device(device)
        self.pqmf = pqmf_from_hparams(hp)
        if params is None:
            base_dir = hp.get("vocoder_ckpt", "")
            path = latest_generator(base_dir) if base_dir and os.path.isdir(base_dir) else None
            if path is None:
                raise FileNotFoundError(f"no generator_*.npz under vocoder_ckpt={base_dir!r}")
            params = load_npz(path)
            self.path = path
        self.model = HifiGanGenerator(hp)
        load_flax_params(self.model, params)
        self.model.to(self.device).eval()

    def save_params(self, step: int = 0) -> str:
        base_dir = self.hp["vocoder_ckpt"]
        os.makedirs(base_dir, exist_ok=True)
        path = os.path.join(base_dir, f"generator_{step:09d}.npz")
        np.savez(path, **export_flax_params(self.model))
        return path

    @torch.no_grad()
    def spec2wav_batch(self, mels, f0s=None, generator: Optional[torch.Generator] = None
                       ) -> np.ndarray:
        """[B, T, 80] mels and [B, T] f0 (read with `use_nsf`) -> wav
        [B, T * hop] float32, one call for the batch. The NSF draws come from
        `generator` (default one seeded with 0)."""
        mels = torch.as_tensor(np.asarray(mels, np.float32), device=self.device)
        if not self.model.use_nsf:
            out = self.model(mels)
        else:
            if f0s is None:
                raise ValueError("use_nsf is on: spec2wav needs an f0")
            f0s = torch.as_tensor(np.asarray(f0s, np.float32), device=self.device)
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            out = self.model(mels, f0s, generator=generator)
        if self.pqmf is not None:
            out = self.pqmf.synthesis(out)
        return out.float().cpu().numpy()

    def spec2wav(self, mel, f0=None, generator: Optional[torch.Generator] = None
                 ) -> np.ndarray:
        """mel [T, 80] (and f0 [T] with `use_nsf`) -> wav [T * hop]."""
        return self.spec2wav_batch(np.asarray(mel)[None],
                                   None if f0 is None else np.asarray(f0)[None], generator)[0]
