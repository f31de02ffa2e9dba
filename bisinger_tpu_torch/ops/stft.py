"""STFT magnitude and log-mel spectrogram on the device, differentiable
(counterpart of `bisinger_tpu/ops/stft.py:20-65`, an XLA lowering there).

The conventions of `utils/audio.py` (librosa's): the signal padded by
fft_size // 2 zeros on both sides, frames every hop_size samples, a
periodic Hann window zero-padded to fft_size, |rFFT|; the mel basis is
Slaney's. Framing by `unfold` and `torch.fft.rfft`, in fp32 (the window and
the basis take the signal's dtype: fp64 in a float64 reference run).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bisinger_tpu_torch.utils.audio import hann_window, mel_basis


def _window(fft_size: int, win_size: int, device) -> torch.Tensor:
    w = hann_window(win_size).astype(np.float32)
    if win_size < fft_size:
        lpad = (fft_size - win_size) // 2
        w = np.pad(w, (lpad, fft_size - win_size - lpad))
    return torch.from_numpy(w).to(device)


def stft_magnitude(wav, fft_size: int = 512, hop_size: int = 128, win_size: int = 512):
    """wav [..., N] -> |STFT| [..., T, fft_size // 2 + 1]."""
    y = F.pad(wav, (fft_size // 2, fft_size // 2))
    window = _window(fft_size, win_size, wav.device).to(wav.dtype)
    frames = y.unfold(-1, fft_size, hop_size) * window
    return torch.fft.rfft(frames, n=fft_size, dim=-1).abs()


def log_mel_spectrogram(wav, sample_rate: int = 24000, fft_size: int = 512,
                        hop_size: int = 128, win_size: int = 512, num_mels: int = 80,
                        fmin: float = 30, fmax: float = 12000, eps: float = 1e-6):
    """wav [..., N] -> log10-mel [..., T, num_mels]."""
    spc = stft_magnitude(wav, fft_size, hop_size, win_size)
    basis = torch.from_numpy(mel_basis(sample_rate, fft_size, num_mels, fmin, fmax)).to(
        wav.device, spc.dtype)
    return torch.log10(torch.clamp_min(spc @ basis.T, eps))
