"""Pseudo-QMF filterbank of the multiband vocoder (counterpart of
`bisinger_tpu/models/pwg.py:397-470`, reference `layers/pqmf.py`).

A Kaiser-windowed sinc prototype (62 taps + 1) cosine-modulated into
`subbands` analysis and synthesis filters. `analysis` filters a waveform
and keeps every `subbands`-th sample; `synthesis` zero-stuffs each subband
back to the full rate (times `subbands`) and filters-and-sums. Plain torch
convolutions in fp32, differentiable.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def design_prototype_filter(taps: int = 62, cutoff_ratio: float = 0.15,
                            beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc prototype lowpass of taps + 1 coefficients."""
    if taps % 2:
        raise ValueError(f"taps must be even, got {taps}")
    omega_c = np.pi * cutoff_ratio
    n = np.arange(taps + 1) - taps / 2
    with np.errstate(invalid="ignore"):
        h_i = np.sin(omega_c * n) / (np.pi * n)
    h_i[taps // 2] = omega_c / np.pi
    return h_i * np.kaiser(taps + 1, beta)


class PQMF:
    """Analysis [B, T] -> [B, T / subbands, subbands] and synthesis back."""

    def __init__(self, subbands: int = 4, taps: int = 62, cutoff_ratio: float = 0.15,
                 beta: float = 9.0):
        self.subbands, self.taps = subbands, taps
        h_proto = design_prototype_filter(taps, cutoff_ratio, beta)
        n = np.arange(taps + 1) - taps / 2
        h_analysis = np.zeros((subbands, taps + 1))
        h_synthesis = np.zeros((subbands, taps + 1))
        for k in range(subbands):
            arg = (2 * k + 1) * (np.pi / (2 * subbands)) * n
            phase = (-1) ** k * np.pi / 4
            h_analysis[k] = 2 * h_proto * np.cos(arg + phase)
            h_synthesis[k] = 2 * h_proto * np.cos(arg - phase)
        # float32 as the JAX package holds them; conv1d correlates, as lax does
        self.h_analysis = torch.from_numpy(h_analysis.astype(np.float32))
        self.h_synthesis = torch.from_numpy(h_synthesis.astype(np.float32))

    def analysis(self, x):
        """x [B, T] -> subband signals [B, T / subbands, subbands]."""
        kernel = self.h_analysis.to(x.device, x.dtype)[:, None, :]  # [subbands, 1, taps + 1]
        y = F.conv1d(x[:, None, :], kernel, stride=self.subbands, padding=self.taps // 2)
        return y.transpose(1, 2)

    def synthesis(self, x):
        """Subband signals [B, T / subbands, subbands] -> wav [B, T]."""
        b, t, s = x.shape
        up = torch.zeros((b, s, t * self.subbands), dtype=x.dtype, device=x.device)
        up[:, :, ::self.subbands] = x.transpose(1, 2) * self.subbands
        kernel = self.h_synthesis.to(x.device, x.dtype)[None, :, :]  # [1, subbands, taps + 1]
        return F.conv1d(up, kernel, padding=self.taps // 2)[:, 0]


def pqmf_from_hparams(hp) -> Optional[PQMF]:
    """The multiband vocoder's PQMF (`vocoder_multiband` subbands), or None
    for a full-band one: the one construction point of training and
    serving, as in the JAX package."""
    n = int(hp.get("vocoder_multiband", 1) or 1)
    return PQMF(n) if n > 1 else None
