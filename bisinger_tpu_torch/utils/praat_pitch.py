"""Praat autocorrelation pitch tracker (Boersma 1993) in pure numpy
(the port's copy of `bisinger_tpu/utils/praat_pitch.py`, unchanged).

The reference extracts f0 with parselmouth's ``Sound.to_pitch_ac``
(`train_bisinger/data_gen/tts/data_gen_utils.py:152-173`: time_step =
hop/sr, voicing_threshold 0.6, pitch_floor 80, pitch_ceiling 750), i.e.
Praat's AC method. parselmouth is not installable in every environment,
so this module implements the *algorithm* itself — Boersma, "Accurate
short-term analysis of the fundamental frequency and the
harmonics-to-noise ratio of a sampled sound", IFA Proceedings 17 (1993)
— rather than an ad-hoc approximation:

  1. per-frame normalized autocorrelation of the Hanning-windowed,
     local-mean-subtracted signal, divided by the window's own
     normalized autocorrelation (the paper's key trick: it undoes the
     window taper so harmonic peaks keep height ~1 at any lag);
  2. local-maximum candidates with parabolic interpolation, scored with
     an octave cost favoring higher candidates, plus an unvoiced
     candidate scored from local/global peak amplitude;
  3. Viterbi path search over frames with octave-jump and
     voiced/unvoiced transition costs (costs scaled to Praat's 10 ms
     reference time step, as in Praat's ``Pitch_pathFinder``).

Not bit-identical to Praat (Praat refines peaks with depth-limited sinc
interpolation; this uses parabolic interpolation), but it reproduces the
algorithmic behaviour that the crude fallback tracker could not: octave
stability, voicing decisions robust to amplitude, and smooth contours.
Accuracy is pinned by `tests/test_praat_pitch.py` (gross-pitch-error and
octave-jump bounds on synthetic singing-like signals).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def praat_frame_grid(
    n_samples: int, sr: float, time_step: float, pitch_floor: float,
    periods_per_window: float = 3.0,
) -> Tuple[int, float, int]:
    """Praat short-term analysis grid (``Sampled_shortTermAnalysis``):
    returns (n_frames, t1, nsamp_window). Frame i is centered at
    t1 + i*time_step seconds; the window spans periods_per_window
    periods of pitch_floor."""
    dx = 1.0 / sr
    nsamp_window = int(round(periods_per_window / pitch_floor / dx))
    nsamp_window = max(2, (nsamp_window // 2) * 2)  # even, like Praat
    window_dur = nsamp_window * dx
    duration = n_samples * dx
    n_frames = int(np.floor((duration - window_dur) / time_step)) + 1
    n_frames = max(n_frames, 0)
    t1 = 0.5 * (duration - (n_frames - 1) * time_step) if n_frames else 0.0
    return n_frames, t1, nsamp_window


def praat_pitch_ac(
    wav: np.ndarray,
    sr: float,
    time_step: float,
    pitch_floor: float = 80.0,
    pitch_ceiling: float = 750.0,
    voicing_threshold: float = 0.6,
    silence_threshold: float = 0.03,
    octave_cost: float = 0.01,
    octave_jump_cost: float = 0.35,
    voiced_unvoiced_cost: float = 0.14,
    max_candidates: int = 15,
    block_frames: int = 4096,
) -> np.ndarray:
    """f0 contour [Hz], 0 where unvoiced — the equivalent of
    ``parselmouth.Sound(wav, sr).to_pitch_ac(...).selected_array["frequency"]``.

    Defaults are Praat's (`to_pitch_ac` standard arguments); the
    reference chain overrides only time_step/floor/ceiling/voicing.
    Frames stream through the FFT/candidate stages in `block_frames`
    blocks so a long corpus item never materializes [n_frames, nfft]
    complex intermediates (a 10-minute 24 kHz wav would transiently need
    ~4 GB otherwise); only the [n_frames, max_candidates] candidate
    arrays persist for the Viterbi pass.
    """
    x = np.asarray(wav, dtype=np.float64)
    n_frames, t1, nsamp_window = praat_frame_grid(
        len(x), sr, time_step, pitch_floor
    )
    if n_frames <= 0:
        return np.zeros(0, dtype=np.float32)
    half = nsamp_window // 2
    # maximum lag searched: one pitch_floor period (+2 guard samples,
    # as in Praat's Sound_to_Pitch)
    max_lag = int(nsamp_window / 3.0) + 2
    min_lag = max(2, int(np.floor(sr / pitch_ceiling)))

    global_mean = x.mean() if len(x) else 0.0
    global_peak = float(np.max(np.abs(x - global_mean))) if len(x) else 0.0

    centers = np.round((t1 + np.arange(n_frames) * time_step) * sr).astype(int)
    starts = centers - half
    pad_l = max(0, -starts.min())
    pad_r = max(0, (starts.max() + nsamp_window) - len(x))
    xp = np.pad(x, (pad_l, pad_r))

    # Praat's Hanning: w[i] = 0.5 - 0.5 cos(2*pi*(i+1)/(n+1))
    i = np.arange(1, nsamp_window + 1, dtype=np.float64)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * i / (nsamp_window + 1))
    nfft = _next_pow2(nsamp_window + max_lag + 1)
    wspec = np.fft.rfft(window, n=nfft)
    wac = np.fft.irfft(wspec * np.conj(wspec), n=nfft)[: max_lag + 1]
    wac = wac / wac[0]

    lags = np.arange(max_lag + 1, dtype=np.float64)
    n_cand = max_candidates
    # persistent per-frame outputs (small): candidate frequency + the
    # LOCAL path score (Praat Pitch_pathFinder form, see below)
    cand_freq = np.zeros((n_frames, n_cand), dtype=np.float64)  # 0 = unvoiced
    cand_str = np.full((n_frames, n_cand), -1e30, dtype=np.float64)

    for b0 in range(0, n_frames, max(1, block_frames)):
        b1 = min(b0 + block_frames, n_frames)
        nb = b1 - b0
        # ---- frame matrix [nb, nsamp_window] centered on the grid ----
        frames = xp[
            (starts[b0:b1] + pad_l)[:, None] + np.arange(nsamp_window)[None, :]
        ]
        local_mean = frames.mean(axis=1, keepdims=True)
        amp = frames - local_mean
        # local peak over ONE pitch_floor period centered on the frame
        # midpoint — Praat's intensity window (±half a period); a wider
        # span would inflate local intensity on amplitude-modulated
        # signals and weaken the unvoiced candidate on decaying frames
        q = (nsamp_window - nsamp_window // 3) // 2
        local_peak = np.max(np.abs(amp[:, q : nsamp_window - q]), axis=1)

        spec = np.fft.rfft(amp * window, n=nfft, axis=1)
        ac = np.fft.irfft(spec * np.conj(spec), n=nfft, axis=1)[:, : max_lag + 1]
        ac0 = ac[:, :1]
        # normalized AC of the signal divided by that of the window
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.where(
                ac0 > 0, ac / np.maximum(ac0, 1e-300), 0.0
            ) / np.maximum(wac[None, :], 1e-12)

        # ---- unvoiced-candidate strength (Boersma eq. 23) ----
        intensity = (
            local_peak / global_peak if global_peak > 0 else np.zeros(nb)
        )
        cand_str[b0:b1, 0] = voicing_threshold + np.maximum(
            0.0,
            2.0 - intensity / (silence_threshold / (1.0 + voicing_threshold)),
        )

        # ---- voiced candidates: local maxima + parabolic interpolation ----
        interior = slice(1, max_lag)
        is_max = (r[:, interior] > r[:, :-2][:, : max_lag - 1]) & (
            r[:, interior] >= r[:, 2:][:, : max_lag - 1]
        )
        lag_ok = (lags[interior] >= min_lag)[None, :]
        is_max &= lag_ok & (r[:, interior] > 0)

        for tb in range(nb):
            t = b0 + tb
            if ac0[tb, 0] <= 0:
                continue
            idx = np.nonzero(is_max[tb])[0] + 1
            if len(idx) == 0:
                continue
            rm, rl, rr = r[tb, idx], r[tb, idx - 1], r[tb, idx + 1]
            denom = 2.0 * rm - rl - rr
            shift = np.where(
                denom > 0, 0.5 * (rr - rl) / np.maximum(denom, 1e-12), 0.0
            )
            shift = np.clip(shift, -0.5, 0.5)
            lag_i = idx + shift
            r_i = rm + 0.25 * (rr - rl) * shift
            # Praat folds over-unity strengths back: r > 1 -> 1/r
            r_i = np.where(r_i > 1.0, 1.0 / np.maximum(r_i, 1e-12), r_i)
            freq = sr / lag_i
            keep = (freq > 0) & (freq < pitch_ceiling)
            freq, r_i, lag_i = freq[keep], r_i[keep], lag_i[keep]
            if len(freq) == 0:
                continue
            # intra-frame RANKING uses Boersma's floor-based form
            # R = r - octave_cost * log2(pitch_floor * tau); the PATH
            # score below uses Praat's Pitch_pathFinder form
            # r - octave_cost * log2(ceiling / f). The two are the same
            # monotone function of f within a frame (they differ by the
            # constant octave_cost*log2(ceiling/floor)), so ranking is
            # unchanged — but the ceiling-based constant is what Praat
            # weighs voiced candidates against the unvoiced one with,
            # and using the floor form there biased voicing decisions
            # by ~0.032 toward voiced.
            rank = r_i - octave_cost * np.log2(pitch_floor * lag_i / sr)
            order = np.argsort(-rank)[: n_cand - 1]
            k = len(order)
            cand_freq[t, 1 : 1 + k] = freq[order]
            cand_str[t, 1 : 1 + k] = r_i[order] - octave_cost * np.log2(
                pitch_ceiling / freq[order]
            )

    # ---- Viterbi path search (Praat Pitch_pathFinder) ----
    # costs are defined per 10 ms of Praat time; scale to this time_step
    correction = 0.01 / time_step
    oj = octave_jump_cost * correction
    vuv = voiced_unvoiced_cost * correction

    voiced = cand_freq > 0
    logf = np.where(voiced, np.log2(np.maximum(cand_freq, 1e-12)), 0.0)
    delta = cand_str[0].copy()
    back = np.zeros((n_frames, n_cand), dtype=np.int32)
    for t in range(1, n_frames):
        # transition[i, j]: prev candidate i -> current candidate j
        both_v = voiced[t - 1][:, None] & voiced[t][None, :]
        any_v = voiced[t - 1][:, None] ^ voiced[t][None, :]
        trans = np.where(
            both_v,
            oj * np.abs(logf[t - 1][:, None] - logf[t][None, :]),
            np.where(any_v, vuv, 0.0),
        )
        score = delta[:, None] - trans
        back[t] = np.argmax(score, axis=0)
        delta = score[back[t], np.arange(n_cand)] + cand_str[t]

    f0 = np.zeros(n_frames, dtype=np.float32)
    j = int(np.argmax(delta))
    for t in range(n_frames - 1, -1, -1):
        f0[t] = cand_freq[t, j]
        j = back[t, j]
    return f0
