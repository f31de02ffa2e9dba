"""The HiFi-GAN inference wrapper (counterpart of
`bisinger_tpu/vocoders/hifigan.py:29-142`).

`HifiGAN(hp)` loads the generator of the highest step among
`<vocoder_ckpt>/generator_*.npz`, by the step's number (a lexicographic
sort would take generator_00004000 after generator_000030000); there is
no random-init fallback: no file raises. `generate` runs it in eval mode
(ResBlock1 stages through K2), on the NSF path with the given f0 when
`use_nsf` is on, else without f0 (the plain HiFi-GAN; an f0 handed in is
not used, as `vocoders/hifigan.py:81-120`), with PQMF synthesis after a
multiband generator; `spec2wav_batch` adds the post-denoising of
`use_denoise` (`base_vocoder.BaseVocoder.postprocess`); `save_params`
writes `generator_{step:09d}.npz`.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
from bisinger_tpu_torch.models.pqmf import pqmf_from_hparams
from bisinger_tpu_torch.vocoders.base_vocoder import (  # noqa: F401 (re-exported)
    BaseVocoder,
    latest_generator,
    register_vocoder,
    step_of,
)
from bisinger_tpu_torch.weights import export_flax_params


@register_vocoder
class HifiGAN(BaseVocoder):
    MODEL = HifiGanGenerator

    def __init__(self, hp: dict, params=None, device=None, model=None):
        super().__init__(hp, params, device, model)
        self.pqmf = pqmf_from_hparams(hp)

    def save_params(self, step: int = 0) -> str:
        base_dir = self.hp["vocoder_ckpt"]
        os.makedirs(base_dir, exist_ok=True)
        path = os.path.join(base_dir, f"generator_{step:09d}.npz")
        np.savez(path, **export_flax_params(self.model))
        return path

    def generate(self, mel, f0=None, generator: Optional[torch.Generator] = None,
                 phase=None, noise=None, seq=None, **_) -> torch.Tensor:
        """mel [B, T, 80] and, with `use_nsf`, f0 [B, T] -> wav [B, T * hop].
        The NSF phase and noise come from `generator` unless pinned. Under
        `seq` (the mesh) mel and f0 are a rank's core frames, the pins at
        the global shape; a multiband generator runs whole."""
        if seq is not None and self.pqmf is not None:
            return self.generate_whole(mel, f0, generator, seq, phase=phase, noise=noise)
        if not self.model.use_nsf:
            out = self.model(mel, seq=seq)
        else:
            if f0 is None:
                raise ValueError("use_nsf is on: the HiFi-GAN needs an f0")
            out = self.model(mel, f0, phase=phase, noise=noise, generator=generator, seq=seq)
        return self.pqmf.synthesis(out) if self.pqmf is not None else out
