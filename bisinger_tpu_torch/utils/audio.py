"""Host-side audio DSP for the binarizer: STFT, mel filterbank, wav <-> spec,
and WAV output (the port's copy of `bisinger_tpu/utils/audio.py:26-150`,
numpy and scipy only).

  - STFT: center-padded (``n_fft//2`` both sides, constant 0), periodic Hann
    window, magnitude spectrogram;
  - mel basis: Slaney-scale filterbank with Slaney area normalization
    (librosa defaults);
  - mel: ``log10(max(eps, mel_basis @ |STFT|))``;
  - wav is end-padded to a whole number of frames
    (``librosa_pad_lr`` convention) and truncated to ``T_mel * hop``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np


def hann_window(win_size: int) -> np.ndarray:
    """Periodic Hann window (scipy `get_window('hann', n, fftbins=True)`)."""
    n = np.arange(win_size)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mels)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@lru_cache(maxsize=8)
def mel_basis(
    sample_rate: int, fft_size: int, num_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape [num_mels, fft//2+1].

    Matches `librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)` defaults
    (htk=False, norm='slaney') as used at
    `data_gen/tts/data_gen_utils.py:130-132`.
    """
    n_freqs = fft_size // 2 + 1
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_min, mel_max = _hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax)
    mel_pts = np.linspace(mel_min, mel_max, num_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney area normalization
    enorm = 2.0 / (hz_pts[2 : num_mels + 2] - hz_pts[:num_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def stft_complex(
    wav: np.ndarray, fft_size: int, hop_size: int, win_size: int
) -> np.ndarray:
    """Complex STFT, shape [fft//2+1, T]. librosa conventions:
    center=True, pad_mode='constant', periodic Hann, window zero-padded
    to n_fft when win_size < fft_size. Single implementation — the
    magnitude path and the vocoder denoiser share the framing
    convention so they cannot drift."""
    window = hann_window(win_size)
    if win_size < fft_size:
        lpad = (fft_size - win_size) // 2
        window = np.pad(window, (lpad, fft_size - win_size - lpad))
    y = np.pad(wav.astype(np.float64), (fft_size // 2, fft_size // 2), mode="constant")
    n_frames = 1 + (len(y) - fft_size) // hop_size
    idx = np.arange(fft_size)[None, :] + hop_size * np.arange(n_frames)[:, None]
    frames = y[idx] * window[None, :]
    return np.fft.rfft(frames, n=fft_size, axis=1).T


def stft_magnitude(
    wav: np.ndarray, fft_size: int, hop_size: int, win_size: int
) -> np.ndarray:
    """Magnitude STFT, shape [fft//2+1, T] (see stft_complex)."""
    return np.abs(stft_complex(wav, fft_size, hop_size, win_size)).astype(
        np.float32
    )


def librosa_pad_lr(x: np.ndarray, fsize: int, fshift: int, pad_sides: int = 1):
    """End-padding so the wav covers a whole number of frames
    (reference `utils/audio.py:39-48`)."""
    assert pad_sides in (1, 2)
    pad = (x.shape[0] // fshift + 1) * fshift - x.shape[0]
    if pad_sides == 1:
        return 0, pad
    return pad // 2, pad // 2 + pad % 2


def wav2spec(
    wav: np.ndarray,
    sample_rate: int = 24000,
    fft_size: int = 512,
    hop_size: int = 128,
    win_size: int = 512,
    num_mels: int = 80,
    fmin: float = 30,
    fmax: float = 12000,
    eps: float = 1e-6,
) -> Tuple[np.ndarray, np.ndarray]:
    """wav [N] -> (wav_padded [T*hop], log10-mel [T, num_mels]).

    The canonical feature extraction used by all binarizers (reference
    `vocoders/pwg.py:107-124` -> `data_gen_utils.py:95-149`).
    """
    spc = stft_magnitude(wav, fft_size, hop_size, win_size)
    basis = mel_basis(sample_rate, fft_size, num_mels, fmin, fmax)
    mel = basis @ spc
    mel = np.log10(np.maximum(eps, mel))

    l_pad, r_pad = librosa_pad_lr(wav, fft_size, hop_size, 1)
    wav = np.pad(wav, (l_pad, r_pad), mode="constant")
    wav = wav[: mel.shape[1] * hop_size]
    return wav, mel.T.astype(np.float32)


def save_wav(wav: np.ndarray, path: str, sr: int, norm: bool = False):
    """float32 [-1, 1] -> a 16-bit PCM WAV file at `sr` Hz (`norm` scales
    the peak to 1 first)."""
    from scipy.io import wavfile

    wav = np.asarray(wav, dtype=np.float32)
    if norm and np.abs(wav).max() > 0:
        wav = wav / np.abs(wav).max()
    wavfile.write(path, sr, (wav * 32767).astype(np.int16))
