"""f0 utilities (counterpart of `bisinger_tpu/utils/pitch.py`): the
host-side numpy functions of the binarizer and the dataset (`_np`), and
the torch ones of the pitch-conditioned FastSpeech2 (`f0_to_coarse`,
`norm_f0`, `denorm_f0`); `freq_to_midi` of the corpus tools."""

from __future__ import annotations

import numpy as np
import torch

F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0
F0_MEL_MIN = 1127 * np.log(1 + F0_MIN / 700)
F0_MEL_MAX = 1127 * np.log(1 + F0_MAX / 700)


def f0_to_coarse_np(f0: np.ndarray) -> np.ndarray:
    """f0 [Hz] -> coarse pitch bin in [1, 255] (256-bin mel-scale
    quantization over 50-1100 Hz; bin 0 is padding)."""
    f0_mel = 1127.0 * np.log(1.0 + f0 / 700.0)
    scaled = (f0_mel - F0_MEL_MIN) * (F0_BIN - 2) / (F0_MEL_MAX - F0_MEL_MIN) + 1.0
    f0_mel = np.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = np.clip(f0_mel, 1.0, F0_BIN - 1)
    coarse = np.rint(f0_mel).astype(np.int64)
    assert coarse.max() <= 255 and coarse.min() >= 1, (coarse.max(), coarse.min())
    return coarse


def f0_to_coarse(f0: torch.Tensor) -> torch.Tensor:
    """f0 [Hz] -> coarse pitch bin in [1, 255] (int64), as `f0_to_coarse_np`
    (`pitch.py:22-31`): floor(x + 0.5), in f0's dtype."""
    f0_mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = (f0_mel - F0_MEL_MIN) * (F0_BIN - 2) / (F0_MEL_MAX - F0_MEL_MIN) + 1.0
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = torch.clamp(f0_mel, 1.0, F0_BIN - 1)
    return torch.floor(f0_mel + 0.5).long()


def norm_f0(f0, uv, pitch_norm: str = "log", f0_mean: float = 0.0, f0_std: float = 1.0,
            use_uv: bool = True):
    """Normalise f0 (`pitch.py:44-53`): log2 for "log", (f0 - mean) / std
    for "standard"; 0 where `uv` (with `use_uv`)."""
    if pitch_norm == "standard":
        f0 = (f0 - f0_mean) / f0_std
    elif pitch_norm == "log":
        f0 = torch.log2(torch.clamp_min(f0, 1e-8))
    if uv is not None and use_uv:
        f0 = torch.where(uv > 0, torch.zeros_like(f0), f0)
    return f0


def denorm_f0(f0, uv, pitch_norm: str = "log", f0_mean: float = 0.0, f0_std: float = 1.0,
              use_uv: bool = True, pitch_padding=None):
    """The inverse of the normalisation (`pitch.py:55-80`): 2**f0 for "log",
    f0 * std + mean for "standard"; 0 where `uv` (with `use_uv`) and where
    `pitch_padding`."""
    if pitch_norm == "standard":
        f0 = f0 * f0_std + f0_mean
    elif pitch_norm == "log":
        f0 = 2.0 ** f0
    if uv is not None and use_uv:
        f0 = torch.where(uv > 0, torch.zeros_like(f0), f0)
    if pitch_padding is not None:
        f0 = torch.where(pitch_padding, torch.zeros_like(f0), f0)
    return f0


def norm_interp_f0_np(f0: np.ndarray, pitch_norm: str = "log", f0_mean: float = 0.0,
                      f0_std: float = 1.0, use_uv: bool = True):
    """Normalize f0 (log2 or standardized), then interpolate linearly
    through unvoiced gaps; returns (f0_interp, uv) as float32."""
    uv = f0 == 0
    f0 = np.asarray(f0, dtype=np.float64)
    if pitch_norm == "standard":
        f0_norm = (f0 - f0_mean) / f0_std
    elif pitch_norm == "log":
        f0_norm = np.log2(np.maximum(f0, 1e-8))
    else:
        f0_norm = f0.copy()
    if use_uv:
        f0_norm[uv] = 0
    if uv.sum() == len(f0):
        f0_norm[uv] = 0
    elif uv.sum() > 0:
        f0_norm[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], f0_norm[~uv])
    return f0_norm.astype(np.float32), uv.astype(np.float32)


def freq_to_midi(frequency: float) -> int:
    """Hz -> nearest MIDI note number (0 for unvoiced/invalid), as
    `pitch.py:103-111`; tools/db4_meta.py and tools/pitch_shift.py use it."""
    import math

    if frequency <= 0:
        return 0
    return int(round(69 + 12 * math.log2(frequency / 440.0)))
