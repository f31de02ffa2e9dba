"""Host-side f0 utilities for the binarizer and the dataset (counterpart of
`bisinger_tpu/utils/pitch.py:34-111`, the numpy functions)."""

from __future__ import annotations

import numpy as np

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
