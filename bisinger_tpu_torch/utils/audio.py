"""Host-side audio DSP for the binarizer: STFT, mel filterbank, wav <-> spec,
WAV output, loudness normalisation and the trimming of long silences (the
port's copy of `bisinger_tpu/utils/audio.py:26-275`, numpy and scipy only).

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


# ---- loudness normalisation and the trimming of long silences ----------------
def _k_weighting_sos(sr: int):
    """BS.1770's K-weighting as two biquads (a high shelf, then a high-pass),
    designed for `sr` by the bilinear transform (`audio.py:157-183`)."""
    import math

    db, f0, q = 3.999843853973347, 1681.974450955533, 0.7071752369554196
    k = math.tan(math.pi * f0 / sr)
    vh = 10 ** (db / 20.0)
    vb = vh ** 0.4996667741545416
    a0 = 1.0 + k / q + k * k
    b1 = [(vh + vb * k / q + k * k) / a0, 2.0 * (k * k - vh) / a0,
          (vh - vb * k / q + k * k) / a0]
    a1 = [1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0]
    f0, q = 38.13547087602444, 0.5003270373238773
    k = math.tan(math.pi * f0 / sr)
    den = 1.0 + k / q + k * k
    a2 = [1.0, 2.0 * (k * k - 1.0) / den, (1.0 - k / q + k * k) / den]
    b2 = [1.0, -2.0, 1.0]
    return (b1, a1), (b2, a2)


def integrated_loudness(wav: np.ndarray, sr: int) -> float:
    """Gated integrated loudness in LUFS (BS.1770-4, mono; `audio.py:186-213`,
    the JAX package's stand-in for pyloudnorm's Meter): 400 ms blocks every
    100 ms, the absolute gate at -70 LUFS, then the relative one 10 LU under."""
    from scipy.signal import lfilter

    (b1, a1), (b2, a2) = _k_weighting_sos(sr)
    x = lfilter(b2, a2, lfilter(b1, a1, wav.astype(np.float64)))
    block, hop = int(0.4 * sr), int(0.1 * sr)
    if len(x) < block:
        return -0.691 + 10.0 * np.log10(np.mean(x ** 2) + 1e-12)
    n_blocks = 1 + (len(x) - block) // hop
    idx = np.arange(block)[None, :] + hop * np.arange(n_blocks)[:, None]
    ms = np.mean(x[idx] ** 2, axis=1) + 1e-12
    lk = -0.691 + 10.0 * np.log10(ms)
    keep = lk > -70.0
    if not keep.any():
        return -70.0
    rel = -0.691 + 10.0 * np.log10(np.mean(ms[keep])) - 10.0
    keep &= lk > rel
    if not keep.any():
        return -70.0
    return -0.691 + 10.0 * np.log10(np.mean(ms[keep]))


def loudness_normalize(wav: np.ndarray, sr: int, target_lufs: float = -22.0) -> np.ndarray:
    """`wav` scaled to `target_lufs`, then down to a peak of 1 if it clips
    (`audio.py:216-225`)."""
    out = wav * 10.0 ** ((target_lufs - integrated_loudness(wav, sr)) / 20.0)
    peak = np.abs(out).max()
    if peak > 1.0:
        out = out / peak
    return out.astype(np.float32)


def trim_long_silences(wav: np.ndarray, sr: int, vad_max_silence_length: int = 12,
                       window_ms: int = 30, moving_average_width: int = 8):
    """Long silences collapsed (`audio.py:228-275`): (trimmed wav, keep mask).
    Voice flags from an energy VAD over `window_ms` windows (RMS above a
    tenth of the median of the windows over the 20th percentile, at least
    1e-4), a moving average of `moving_average_width` windows rounded, and
    the voiced runs dilated by `vad_max_silence_length` windows; the tail
    under a window is kept. This is the JAX package's branch when webrtcvad
    does not import, which it does on neither the CPU machine nor the card's
    (the reference's webrtcvad convention, `audio.py:276-331`, is not ported).
    A wav of near-constant energy comes back whole."""
    from scipy.ndimage import binary_dilation

    spw = (window_ms * sr) // 1000
    n_win = len(wav) // spw
    if n_win == 0:
        return wav, np.ones(len(wav), bool)
    rms = np.sqrt(np.mean(wav[: n_win * spw].reshape(n_win, spw) ** 2, axis=1) + 1e-12)
    above = rms[rms > np.percentile(rms, 20)]
    if above.size == 0:
        return wav, np.ones(len(wav), bool)
    flags = (rms > max(1e-4, 0.1 * float(np.median(above)))).astype(float)
    width = moving_average_width
    mask_w = np.round(np.convolve(flags, np.ones(width) / width, mode="same")).astype(bool)
    mask_w = binary_dilation(mask_w, np.ones(vad_max_silence_length + 1, bool))
    mask = np.repeat(mask_w, spw)
    mask = np.concatenate([mask, np.ones(len(wav) - len(mask), bool)])
    return wav[mask], mask
