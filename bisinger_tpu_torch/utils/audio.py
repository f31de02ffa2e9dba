"""Waveform file output (counterpart of `bisinger_tpu/utils/audio.py:144-150`)."""

from __future__ import annotations

import numpy as np


def save_wav(wav: np.ndarray, path: str, sr: int):
    """float32 [-1, 1] -> a 16-bit PCM WAV file at `sr` Hz."""
    from scipy.io import wavfile

    wav = np.asarray(wav, dtype=np.float32)
    wavfile.write(path, sr, (wav * 32767).astype(np.int16))
