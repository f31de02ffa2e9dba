"""Vocoder-side audio utilities on the host: spectral-subtraction denoise
and MFCC (the port's copy of `bisinger_tpu/vocoders/vocoder_utils.py:20-77`,
numpy and scipy, so that it matches the JAX package's bit for bit).

`denoise` clips the STFT magnitude by a floor `v` and keeps the phase
(reference `vocoder_utils.py:7-15`); the serving path runs it on each
waveform of a batch after the generator when `use_denoise` is set.
`wav2mfcc` gives [T, 39] MFCC + delta + delta-delta (n_mfcc 13, magnitude
mel, Savitzky-Golay deltas of width 9).
"""

from __future__ import annotations

import numpy as np
from scipy.fftpack import dct
from scipy.signal import savgol_filter

from bisinger_tpu_torch.utils.audio import hann_window, mel_basis, stft_complex


def _istft(spec: np.ndarray, fft_size: int, hop_size: int, win_size: int) -> np.ndarray:
    """Overlap-add inverse with squared-window normalization."""
    win = hann_window(win_size)
    if win_size < fft_size:
        lpad = (fft_size - win_size) // 2
        win = np.pad(win, (lpad, fft_size - win_size - lpad))
    frames = np.fft.irfft(spec.T, n=fft_size, axis=1) * win[None, :]
    n_frames = frames.shape[0]
    out_len = fft_size + hop_size * (n_frames - 1)
    out = np.zeros(out_len)
    wsum = np.zeros(out_len)
    for i in range(n_frames):
        s = i * hop_size
        out[s: s + fft_size] += frames[i]
        wsum[s: s + fft_size] += win ** 2
    out = out / np.maximum(wsum, 1e-10)
    pad = fft_size // 2
    return out[pad:-pad] if pad else out


def denoise(wav: np.ndarray, v: float = 0.0, hp=None) -> np.ndarray:
    """Spectral subtraction: |STFT| - v clipped at 0, the phase kept; the
    STFT's sizes from `hp` (default 512 / 128 / 512)."""
    fft_size = hp["fft_size"] if hp else 512
    hop_size = hp["hop_size"] if hp else 128
    win_size = hp["win_size"] if hp else 512
    spec = stft_complex(np.asarray(wav, np.float64), fft_size, hop_size, win_size)
    mag = np.clip(np.abs(spec) - v, 0.0, None)
    return _istft(mag * np.exp(1j * np.angle(spec)), fft_size, hop_size, win_size).astype(
        np.float32)


def _power_to_db(S: np.ndarray, amin: float = 1e-10, top_db: float = 80.0) -> np.ndarray:
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec -= 10.0 * np.log10(max(amin, 1.0))
    return np.maximum(log_spec, log_spec.max() - top_db)


def wav2mfcc(wav: np.ndarray, hp) -> np.ndarray:
    """wav -> [T, 39] MFCC + delta + delta-delta."""
    fft_size, hop_size, win_size = hp["fft_size"], hp["hop_size"], hp["win_size"]
    sr = hp["audio_sample_rate"]
    spec = np.abs(stft_complex(np.asarray(wav, np.float64), fft_size, hop_size, win_size))
    mels = mel_basis(sr, fft_size, num_mels=128, fmin=0.0, fmax=sr / 2) @ spec
    S_db = _power_to_db(mels)
    mfcc = dct(S_db, type=2, axis=0, norm="ortho")[:13]  # [13, T]
    width = min(9, mfcc.shape[1] if mfcc.shape[1] % 2 else mfcc.shape[1] - 1)
    if width >= 3:
        d1 = savgol_filter(mfcc, width, polyorder=1, deriv=1, axis=1)
        d2 = savgol_filter(mfcc, width, polyorder=2, deriv=2, axis=1)
    else:
        d1 = np.zeros_like(mfcc)
        d2 = np.zeros_like(mfcc)
    return np.concatenate([mfcc, d1, d2]).T.astype(np.float32)  # [T, 39]
