"""The vocoder registry and the wrappers' common part (counterpart of
`bisinger_tpu/vocoders/base_vocoder.py:1-56`).

`get_vocoder_cls(hp)` reads `hp["vocoder"]`: a registered name, or a dotted
one, the JAX package's or the reference's, resolved by its last part
("bisinger_tpu.vocoders.pwg.PWG" is the port's `PWG`). The port cannot
import the JAX package, so an unknown name raises.

A wrapper holds a generator module (`MODEL`) and its hyperparameters.
`generate` runs the generator on a batch of tensors on the card;
`postprocess` is the host's part after it (spectral-subtraction denoise
of each waveform with `use_denoise`, floor `denoise_v`, as JAX's
`spec2wav_batch`); `spec2wav_batch` / `spec2wav` go from numpy to numpy
through both. Without `params` or `model`, the generator of the highest
step among `<vocoder_ckpt>/generator_*.npz` is loaded; there is no
random-initialised fallback.
"""

from __future__ import annotations

import copy
import glob
import os
import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from bisinger_tpu_torch import resolve_device
from bisinger_tpu_torch.vocoders.vocoder_utils import denoise
from bisinger_tpu_torch.weights import load_flax_params, load_npz

VOCODERS: Dict[str, type] = {}


def register_vocoder(cls):
    VOCODERS[cls.__name__] = cls
    VOCODERS[cls.__name__.lower()] = cls
    return cls


def get_vocoder_cls(hp):
    """The wrapper class `hp["vocoder"]` (or the name `hp`) names."""
    from bisinger_tpu_torch.vocoders import hifigan, pwg  # noqa: F401 (they register)

    name = hp if isinstance(hp, str) else hp.get("vocoder") or "HifiGAN"
    last = name.rsplit(".", 1)[-1]
    cls = VOCODERS.get(last) or VOCODERS.get(last.lower())
    if cls is None:
        raise ValueError(f"vocoder {name!r}: the port has "
                         f"{sorted(k for k in VOCODERS if k[0].isupper())}")
    return cls


def as_vocoder(vocoder, hp, device) -> "BaseVocoder":
    """A wrapper as it is, or a generator module wrapped by the registered
    class whose `MODEL` it is."""
    if isinstance(vocoder, BaseVocoder):
        return vocoder
    from bisinger_tpu_torch.vocoders import hifigan, pwg  # noqa: F401 (they register)

    for cls in set(VOCODERS.values()):
        if type(vocoder) is cls.MODEL:
            return cls(hp, device=device, model=vocoder)
    raise TypeError(f"no vocoder wrapper for a {type(vocoder).__name__}")


def step_of(path: str) -> int:
    m = re.search(r"generator_(\d+)\.npz$", path)
    return int(m.group(1)) if m else -1


def latest_generator(base_dir: str, recursive: bool = False) -> Optional[str]:
    """The generator_*.npz of the highest step under `base_dir` (at any
    depth when `recursive`), by the step's number, or None."""
    pattern = os.path.join(base_dir, "**", "generator_*.npz") if recursive else \
        os.path.join(base_dir, "generator_*.npz")
    cands = sorted(glob.glob(pattern, recursive=recursive), key=lambda p: (step_of(p), p))
    return cands[-1] if cands else None


class BaseVocoder:
    MODEL: type = nn.Module

    def __init__(self, hp: dict, params: Optional[Dict[str, np.ndarray]] = None, device=None,
                 model: Optional[nn.Module] = None):
        """`params`: a flat flax dict of the generator; `model`: a generator
        module to wrap as it is; default the newest `generator_*.npz` of
        `hp["vocoder_ckpt"]`."""
        self.hp = hp
        self.device = resolve_device(device)
        if model is None:
            if params is None:
                base_dir = hp.get("vocoder_ckpt", "")
                path = latest_generator(base_dir) if base_dir and os.path.isdir(base_dir) \
                    else None
                if path is None:
                    raise FileNotFoundError(
                        f"no generator_*.npz under vocoder_ckpt={base_dir!r}")
                params = load_npz(path)
                self.path = path
            model = self.MODEL(hp)
            load_flax_params(model, params)
        self.model = model.to(self.device).eval()

    def with_model(self, model: nn.Module) -> "BaseVocoder":
        """A shallow copy holding another generator module."""
        out = copy.copy(self)
        out.model = model
        return out

    def generate(self, mel, f0=None, generator: Optional[torch.Generator] = None,
                 **pins) -> torch.Tensor:
        """mel [B, T, 80] (and f0 [B, T]) on the model's device -> wav [B,
        T * hop]."""
        raise NotImplementedError

    def postprocess(self, wavs: np.ndarray) -> np.ndarray:
        """The host's part after the generator: with `use_denoise`, each
        waveform denoised at `denoise_v` (default 0.002)."""
        if not self.hp.get("use_denoise"):
            return wavs
        v = float(self.hp.get("denoise_v", 0.002))
        return np.stack([denoise(w, v=v, hp=self.hp) for w in wavs])

    @torch.no_grad()
    def spec2wav_batch(self, mels, f0s=None, generator: Optional[torch.Generator] = None
                       ) -> np.ndarray:
        """[B, T, 80] mels (and [B, T] f0) -> wav [B, T * hop] float32, one
        generator call for the batch; its draws come from `generator`
        (default one seeded with 0)."""
        mels = torch.as_tensor(np.asarray(mels, np.float32), device=self.device)
        if f0s is not None:
            f0s = torch.as_tensor(np.asarray(f0s, np.float32), device=self.device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return self.postprocess(self.generate(mels, f0s, generator).float().cpu().numpy())

    def spec2wav(self, mel, f0=None, generator: Optional[torch.Generator] = None
                 ) -> np.ndarray:
        """mel [T, 80] (and f0 [T]) -> wav [T * hop]."""
        return self.spec2wav_batch(np.asarray(mel)[None],
                                   None if f0 is None else np.asarray(f0)[None], generator)[0]

    @staticmethod
    def wav2spec(wav_fn, hp):
        """A wav file (or array) -> (wav padded [T * hop], log10-mel [T, 80])."""
        from bisinger_tpu_torch.data.binarizer import load_wav
        from bisinger_tpu_torch.utils import audio

        wav = load_wav(wav_fn, hp["audio_sample_rate"]) if isinstance(wav_fn, str) else wav_fn
        return audio.wav2spec(wav, sample_rate=hp["audio_sample_rate"], fft_size=hp["fft_size"],
                              hop_size=hp["hop_size"], win_size=hp["win_size"],
                              num_mels=hp["audio_num_mel_bins"], fmin=hp["fmin"],
                              fmax=hp["fmax"], eps=float(hp.get("wav2spec_eps", 1e-6)))
