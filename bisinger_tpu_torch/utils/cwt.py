"""Continuous wavelet transform of log-f0, the CWT pitch representation
(counterpart of `bisinger_tpu/utils/cwt.py`).

Host side, numpy (the binarizer's; copied unchanged, `cwt.py:27-103`):
continuous-f0 interpolation, log-f0, and a Mexican-hat (DOG m=2) CWT over
10 dyadic scales in float64 FFTs zero-padded to a power of two
(dt=0.005, dj=1, s0=2*dt, J=9), normalised per scale.

Device side, torch (`cwt.py:105-139`): `inverse_cwt`, the fixed-weight sum
over the scales standardised over the whole time axis (padded frames
included, the population std), `cwt2f0` and `cwt2f0_norm`, which pads f0
with its last frame to the mel length, or crops it, and normalises it.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from bisinger_tpu_torch.utils.pitch import norm_f0

CWT_DT = 0.005
CWT_DJ = 1.0
CWT_S0 = 2 * CWT_DT
CWT_J = 9  # 10 scales


def convert_continuous_f0(f0: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Interpolate through unvoiced gaps; returns (uv, cont_f0)
    (reference `convert_continuos_f0`)."""
    f0 = np.copy(f0)
    uv = np.float32(f0 != 0)
    if (f0 == 0).all():
        return uv, f0
    nz = np.where(f0 != 0)[0]
    f0[: nz[0]] = f0[nz[0]]
    f0[nz[-1] :] = f0[nz[-1]]
    nz = np.where(f0 != 0)[0]
    cont = np.interp(np.arange(len(f0)), nz, f0[nz])
    return uv, cont


def get_cont_lf0(f0: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    uv, cont = convert_continuous_f0(f0)
    return uv, np.log(np.maximum(cont, 1e-8))


def cwt_scales(dt: float = CWT_DT, dj: float = CWT_DJ, s0: float = CWT_S0, j: int = CWT_J) -> np.ndarray:
    return s0 * 2.0 ** (dj * np.arange(j + 1))


def mexican_hat_cwt(x: np.ndarray, dt: float = CWT_DT, dj: float = CWT_DJ, s0: float = CWT_S0, j: int = CWT_J) -> Tuple[np.ndarray, np.ndarray]:
    """FFT-based CWT with the DOG m=2 (Mexican hat) mother wavelet.

    Returns (W [T, J+1] real, scales [J+1]) matching pycwt's
    `wavelet.cwt(..., MexicanHat())` conventions (Torrence & Compo 1998
    eqs. 4-6)."""
    m = 2
    n = len(x)
    # zero-pad to the next power of two like pycwt: without it the FFT
    # convolution is CIRCULAR over the raw length, and at the largest
    # scale (seconds of wavelet support) the CWT near the utterance
    # start wraps in log-f0 from the end
    nfft = 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)
    scales = cwt_scales(dt, dj, s0, j)
    # angular frequencies for the fft grid
    omega = 2.0 * np.pi * np.fft.fftfreq(nfft, d=dt)
    x_hat = np.fft.fft(x, n=nfft)
    # DOG m=2 fourier-domain mother: -(i)^m / sqrt(gamma(m+1/2)) (s w)^m e^{-(s w)^2/2}
    norm_const = -((1j) ** m) / math.sqrt(math.gamma(m + 0.5))
    out = np.empty((j + 1, n), dtype=np.complex128)
    for i, s in enumerate(scales):
        psi_hat = norm_const * (s * omega) ** m * np.exp(-((s * omega) ** 2) / 2.0)
        # T&C normalization: sqrt(2 pi s / dt)
        psi_hat = psi_hat * np.sqrt(2.0 * np.pi * s / dt)
        out[i] = np.fft.ifft(x_hat * np.conj(psi_hat))[:n]
    return np.real(out).T.astype(np.float32), scales.astype(np.float32)


def norm_scale(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-scale standardization (reference `norm_scale`); returns
    (w_norm [T, S], mean [1, S], std [1, S])."""
    mean = w.mean(0)[None, :]
    std = w.std(0)[None, :]
    return (w - mean) / np.maximum(std, 1e-8), mean, std


def f0_to_cwt_spec(f0: np.ndarray, lf0_mean: float, lf0_std: float):
    """Full forward pipeline used by the binarizer
    (reference `base_binarizer.get_f0cwt`): f0 -> continuous log-f0 ->
    standardized -> CWT -> per-scale normalized.
    Returns (cwt_spec [T, 10], scale_mean [10], scale_std [10])."""
    _, lf0 = get_cont_lf0(f0)
    lf0_norm = (lf0 - lf0_mean) / lf0_std
    w, _scales = mexican_hat_cwt(lf0_norm)
    w_norm, mean, std = norm_scale(w)
    return w_norm.astype(np.float32), mean[0], std[0]


# ---- device side ----------------------------------------------------------
def inverse_cwt(cwt_spec, num_scales: int = 10):
    """Standardised log-f0 from the CWT spectrogram with the fixed
    (j + 1 + 2.5)^-2.5 weights: cwt_spec [B, T, S] -> [B, T]. The weights
    are fp32, as JAX's."""
    dtype = torch.promote_types(cwt_spec.dtype, torch.float32)
    b = ((torch.arange(num_scales, dtype=torch.float32, device=cwt_spec.device) + 1.0 + 2.5)
         ** -2.5).to(dtype)
    rec = (cwt_spec * b).sum(-1)
    mean = rec.mean(-1, keepdim=True)
    std = rec.std(-1, keepdim=True, correction=0)
    return (rec - mean) / torch.clamp_min(std, 1e-8)


def cwt2f0(cwt_spec, mean, std, num_scales: int = 10):
    """CWT spec [B, T, S] and each item's log-f0 (mean, std) [B] -> f0 in Hz."""
    lf0 = inverse_cwt(cwt_spec, num_scales) * std[:, None] + mean[:, None]
    return torch.exp(lf0)


def cwt2f0_norm(cwt_spec, mean, std, mel2ph, pitch_norm: str = "log", use_uv: bool = True):
    """CWT spec -> f0, padded with its last frame to mel2ph's length or
    cropped to it, then normalised (`norm_f0`, no uv)."""
    f0 = cwt2f0(cwt_spec, mean, std, 10)
    t_mel = mel2ph.shape[1]
    if f0.shape[1] < t_mel:
        f0 = torch.cat([f0, f0[:, -1:].expand(-1, t_mel - f0.shape[1])], dim=1)
    else:
        f0 = f0[:, :t_mel]
    return norm_f0(f0, None, pitch_norm, use_uv=use_uv)
