"""Gaussian diffusion mel decoder (counterpart of
`bisinger_tpu/models/diffusion.py:35-509`).

The conditioner is `FastSpeech2MIDI` with `use_midi`, else the plain
`FastSpeech2` (`diffusion.py:99-102`); its inputs beyond the tokens and
mel2ph (speaker, f0, uv, energy, the MIDI ones) pass through as keywords.

Training (`train_forward`, `diffusion.py:128-140, 356-401`): fs2 up to the
decoder input (skip_decoder) -> cond; t ~ U[0, K_step); the target mel,
normalised, noised to t (`q_sample_t`); the denoiser's noise prediction,
the DiffNet's on its layer-by-layer path (`cond=`, never K1), against the
noise under the l1 (nonpadding-weighted) or l2 loss. `t` and `noise` may
be handed in.

Inference:
fs2 -> cond (decoder input) -> the start: pure noise (`gaussian_start`)
or the fs2 mel noised to step K-1 (`q_sample`, the shallow start) -> one
of three samplers, picked as `_dispatch_sampler` picks it:
- DPM-Solver++(2M) when `diff_sampler` is "dpmpp" (`dpm_steps` calls);
- PLMS with stride `pndm_speedup` when it is set (the 2-call warmup, then
  Adams-Bashforth 2/3/4; K/stride + 1 calls);
- ancestral DDPM otherwise (K calls, fresh noise at each step).
-> denormalised mel. Every call of the DiffNet runs its residual layers in
K1; the FFT denoiser (`diff_decoder_type: fft`) runs no kernel.

`OfflineGaussianDiffusion` (`diffusion.py:436-501`) trains on the
conditioner's decoder input alone and, at inference, starts from a recorded
fs2 mel (`fs2_mels`) and runs the full K-step DDPM loop whatever
`pndm_speedup` says, unless `offline_fast_sampler` is set.
`PlainGaussianDiffusion` (`diffusion.py:502-509`) diffuses over every step:
K_step is `timesteps`.

Long-form synthesis (`parallel/sequence.py`; JAX cuts at
`diffusion.py:421-424`): `forward(..., seq=mesh)`, the mesh found by the
entry point from `sequence_parallel_axis`. Each `seq` rank runs the conditioner
whole on its rows (it is token-level, its frame-level attention spans the
score, and it is 1.3-1.9% of a B=32 call), then keeps its chunk of the
decoder input and of the fs2 mel: a departure from JAX in mechanism (JAX
splits the decoder input's frames), not in result. The sampler's state
lives on the rank's frames widened by K1's halo (the sum of the
dilations); `cond_proj` is computed once for the widened chunk; before
every denoiser call the halo frames of x are refreshed from the
neighbours' cores, and K1 runs unchanged on the widened chunk. The PLMS,
DDPM and DPM-Solver++ updates are frame-wise, so a stale halo frame is
overwritten at the next exchange. The start noise and DDPM's step noise
are drawn at the global shape (or pinned at it), each rank keeping its
rows and frames; the shallow start noises the rank's slice of the fs2
mel. `mel_out` is the rank's core frames (`sequence.gather_frames` gives
the whole); the conditioner's outputs stay whole. The FFT denoiser
attends over every frame: under `seq` it gathers x before each call,
correct but no faster.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from bisinger_tpu_torch.models.diffnet import DIFF_DECODERS
from bisinger_tpu_torch.models.fs2 import FastSpeech2, FastSpeech2MIDI
from bisinger_tpu_torch.parallel import sequence
from bisinger_tpu_torch.parallel.mesh import draw_rows, global_count, global_mean, local_rows


def linear_beta_schedule(timesteps: int, max_beta: float = 0.01) -> np.ndarray:
    return np.linspace(1e-4, max_beta, timesteps)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def make_betas(hp: dict) -> np.ndarray:
    if hp.get("schedule_type", "cosine") == "linear":
        return linear_beta_schedule(hp["timesteps"], hp.get("max_beta", 0.01))
    return cosine_beta_schedule(hp["timesteps"])


class GaussianDiffusion(nn.Module):
    """Owns the fs2 conditioner and the denoiser `diff_decoder_type` names
    (`DIFF_DECODERS`: the DiffNet through K1, or the FFT denoiser)."""

    fs2_decoder = True  # the conditioner runs its decoder (the fs2 mel) at inference

    def __init__(self, hp: dict, vocab_size: int, out_dims: int = 80):
        super().__init__()
        self.hp = hp
        self.K_step = int(hp["K_step"])
        self.fs2 = (FastSpeech2MIDI if hp.get("use_midi") else FastSpeech2)(
            hp, vocab_size, with_decoder=self.fs2_decoder)
        self.denoise_fn = DIFF_DECODERS[hp.get("diff_decoder_type", "wavenet")](hp, out_dims)
        # float32 as the reference's buffers (`DiffusionBuffers`, computed in
        # float64 and then rounded); alphas_cumprod is kept on the device so
        # that PLMS's per-step reads need no host-to-device copy. The DDPM
        # and DPM-Solver++ coefficients are host floats, one per step.
        betas = make_betas(hp)
        ac = np.cumprod(1.0 - betas, axis=0)
        ac_prev = np.append(1.0, ac[:-1])
        f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        self.sched = dict(
            alphas_cumprod=f32(ac),
            sqrt_alphas_cumprod=f32(np.sqrt(ac)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / ac)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / ac - 1)),
            posterior_log_variance_clipped=f32(np.log(np.maximum(
                betas * (1.0 - ac_prev) / (1.0 - ac), 1e-20))),
            posterior_mean_coef1=f32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
            posterior_mean_coef2=f32((1.0 - ac_prev) * np.sqrt(1.0 - betas) / (1.0 - ac)),
        )
        for name in ("alphas_cumprod", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod"):
            self.register_buffer(name, torch.from_numpy(self.sched[name]), persistent=False)
        keep = hp.get("keep_bins", out_dims)
        self.register_buffer("spec_min", torch.tensor(hp["spec_min"][:keep], dtype=torch.float32),
                             persistent=False)
        self.register_buffer("spec_max", torch.tensor(hp["spec_max"][:keep], dtype=torch.float32),
                             persistent=False)

    def norm_spec(self, x):
        return (x - self.spec_min) / (self.spec_max - self.spec_min) * 2 - 1

    def denorm_spec(self, x):
        return (x + 1) / 2 * (self.spec_max - self.spec_min) + self.spec_min

    def _plms_get_x_pred(self, x, noise_t, t: int, t_prev: int):
        """One PLMS transition t -> t_prev (`diffusion.py:211-225`), with the
        schedule constants in float32 as the reference computes them."""
        a_t, a_prev = self.alphas_cumprod[t], self.alphas_cumprod[t_prev]
        a_t_sq, a_prev_sq = torch.sqrt(a_t), torch.sqrt(a_prev)
        x_delta = (a_prev - a_t) * (
            (1.0 / (a_t_sq * (a_t_sq + a_prev_sq))) * x
            - 1.0 / (a_t_sq * (torch.sqrt((1 - a_prev) * a_t) + torch.sqrt((1 - a_t) * a_prev)))
            * noise_t
        )
        return x + x_delta

    def plms_sample_loop(self, x, cond_proj, k: int, interval: int, stack=None, seq=None):
        """PLMS reverse loop (`diffusion.py:227-277`): one denoiser call per
        step after a 2-call warmup; k/interval + 1 calls in all. Each
        sampler takes `seq` (mesh, window) under `seq` (`_sample`)."""
        ts = np.arange(0, k, interval)[::-1]
        dn = lambda xx, tv: self._dn(xx, cond_proj, int(tv), stack, seq)  # noqa: E731
        t0 = int(ts[0])
        t0_prev = max(t0 - interval, 0)
        noise_pred = dn(x, t0)
        x_pred = self._plms_get_x_pred(x, noise_pred, t0, t0_prev)
        noise_pred_prev = dn(x_pred, t0_prev)
        x = self._plms_get_x_pred(x, (noise_pred + noise_pred_prev) / 2, t0, t0_prev)
        history = [noise_pred] * 3  # newest first
        for count, tv in enumerate(ts[1:], start=1):
            tv = int(tv)
            noise_pred = dn(x, tv)
            h0, h1, h2 = history
            if count == 1:
                noise_prime = (3 * noise_pred - h0) / 2
            elif count == 2:
                noise_prime = (23 * noise_pred - 16 * h0 + 5 * h1) / 12
            else:
                noise_prime = (55 * noise_pred - 59 * h0 + 37 * h1 - 9 * h2) / 24
            x = self._plms_get_x_pred(x, noise_prime, tv, max(tv - interval, 0))
            history = [noise_pred, h0, h1]
        return x

    def _dn(self, x, cond_proj, tv: int, stack, seq=None):
        tb = torch.full((x.shape[0],), tv, dtype=torch.long, device=x.device)
        if seq is None:
            return self.denoise_fn(x, tb, cond_proj, stack)
        m, win = seq
        if sequence.denoiser_halo(self.hp) is None:
            # the FFT denoiser: every frame, then this rank's window of its output
            whole = sequence.gather_frames(win.core(x), m)
            return win.of(self.denoise_fn(whole, tb, cond_proj, stack))
        # the DiffNet: the halo frames from the neighbours' cores
        return self.denoise_fn(sequence.refresh_halo(x, m, win), tb, cond_proj, stack)

    def q_sample_t(self, x_start, t, noise):
        """x_start [B, T, M] noised to the steps t [B] (`diffusion.py:120-126`)."""
        return (self.sqrt_alphas_cumprod[t][:, None, None] * x_start
                + self.sqrt_one_minus_alphas_cumprod[t][:, None, None] * noise)

    def p_losses(self, x_start, t, cond, noise, nonpadding=None):
        """The denoiser's loss at steps t [B] (`diffusion.py:128-140`): l1
        over the nonpadding frames, or the l2 mean over every value; under
        data parallelism this rank's share of the global batch's
        (`training/losses.py`)."""
        x_recon = self.denoise_fn(self.q_sample_t(x_start, t, noise), t, cond=cond)
        loss_type = self.hp.get("diff_loss_type", "l1")
        if loss_type == "l1":
            err = (noise - x_recon).abs()
            if nonpadding is None:
                return global_mean(err)
            w = nonpadding[:, :, None]
            return (err * w).sum() / torch.clamp_min(
                global_count(w.sum()) * x_start.shape[-1], 1.0)
        if loss_type == "l2":
            return global_mean((noise - x_recon) ** 2)
        raise NotImplementedError(f"diff_loss_type={loss_type}")

    def train_forward(self, txt_tokens, mel2ph, ref_mels, t=None, noise=None,
                      generator: Optional[torch.Generator] = None, **cond):
        """-> dict with diff_loss, dur, mel2ph, decoder_inp (and the
        conditioner's pitch and energy outputs). `t` [B] and `noise`
        [B, T, M] pin the draws, else they come from `generator`; both at
        the global batch's shape under data parallelism, of which this rank
        takes its rows."""
        ret = self.fs2(txt_tokens, mel2ph=mel2ph, ref_mels=ref_mels, skip_decoder=True, **cond)
        x = self.norm_spec(ref_mels)
        dev, b = x.device, x.shape[0]
        if t is None:
            t = draw_rows(lambda s: torch.randint(0, self.K_step, s, generator=generator,
                                                  device=dev), (b,))
        else:
            t = local_rows(t, b)
        if noise is None:
            noise = draw_rows(lambda s: torch.randn(s, generator=generator, device=dev),
                              x.shape)
        else:
            noise = local_rows(noise, b)
        nonpadding = (mel2ph != 0).to(x.dtype)
        ret["diff_loss"] = self.p_losses(x, t.long(), ret["decoder_inp"], noise, nonpadding)
        return ret

    def q_sample(self, x_start, t: int, noise):
        """x_start noised to step t (`diffusion.py:120-126`)."""
        b = self.sched
        return (float(b["sqrt_alphas_cumprod"][t]) * x_start
                + float(b["sqrt_one_minus_alphas_cumprod"][t]) * noise)

    def predict_start_from_noise(self, x_t, t: int, noise):
        b = self.sched
        return (float(b["sqrt_recip_alphas_cumprod"][t]) * x_t
                - float(b["sqrt_recipm1_alphas_cumprod"][t]) * noise)

    def p_sample(self, x, t: int, cond_proj, noise, stack=None, seq=None):
        """One ancestral step t -> t-1 with x0 clipped to [-1, 1]
        (`diffusion.py:166-186`); `noise` is this step's draw (unused at t=0)."""
        b = self.sched
        x_recon = self.predict_start_from_noise(x, t, self._dn(x, cond_proj, t, stack, seq))
        x_recon = x_recon.clamp(-1.0, 1.0)
        mean = (float(b["posterior_mean_coef1"][t]) * x_recon
                + float(b["posterior_mean_coef2"][t]) * x)
        if t == 0:
            return mean
        return mean + float(np.exp(0.5 * b["posterior_log_variance_clipped"][t])) * noise

    def ddpm_sample_loop(self, x, cond_proj, k: int, stack=None, generator=None,
                         step_noise=None, seq=None):
        """Reverse DDPM from step k-1 down to 0 (`diffusion.py:188-209`): k
        denoiser calls. Step i's noise is `step_noise[i]` when given (the
        first step, t=k-1, at 0), else a draw from `generator`."""
        if seq is not None:  # drawn (or pinned) at the global shape
            m, win = seq
            shape = (x.shape[0] * m.shape["data"], win.n_frames, *x.shape[2:])
        else:
            shape = tuple(x.shape)
        if step_noise is not None and tuple(step_noise.shape) != (k, *shape):
            raise ValueError(f"step_noise {tuple(step_noise.shape)} != {(k, *shape)}")
        for i, tv in enumerate(range(k - 1, -1, -1)):
            noise = (step_noise[i] if step_noise is not None
                     else torch.randn(shape, generator=generator, device=x.device))
            if seq is not None:  # this rank's part
                noise = sequence.local_window(noise, m, win)
            x = self.p_sample(x, tv, cond_proj, noise, stack, seq)
        return x

    def dpmpp_schedule(self, k: int, steps: int):
        """DPM-Solver++(2M)'s steps and per-step constants
        (`diffusion.py:285-300`): the steps, then alpha, sigma and the
        lambda step h at them, in float32 from the float32 alphas_cumprod,
        as the reference computes them."""
        ac = self.sched["alphas_cumprod"]
        steps = min(int(steps), int(k))
        ts = np.linspace(k - 1, 0, steps).round().astype(np.int64)
        ts = ts[np.concatenate([[True], np.diff(ts) != 0])]
        alpha = np.sqrt(ac[ts])
        sigma = np.sqrt(np.maximum(1.0 - ac[ts], 1e-12))
        h = np.diff(np.log(alpha / sigma))
        return ts, alpha, sigma, h

    def dpmpp_sample_loop(self, x, cond_proj, k: int, steps: int, stack=None, seq=None):
        """DPM-Solver++(2M) (`diffusion.py:278-330`): deterministic, one
        denoiser call per step (`dpm_steps`, at most k): the first
        transition first order, then second order multistep, and the last
        call's data prediction is the result."""
        ts, alpha, sigma, h = self.dpmpp_schedule(k, steps)
        n = len(ts)

        def x0_of(x, i):
            eps = self._dn(x, cond_proj, int(ts[i]), stack, seq)
            return ((x - float(sigma[i]) * eps) / float(alpha[i])).clamp(-1.0, 1.0)

        x0_prev = x0_of(x, 0)
        x = float(sigma[1] / sigma[0]) * x - float(alpha[1] * np.expm1(-h[0])) * x0_prev
        for i in range(1, n - 1):
            x0 = x0_of(x, i)
            r = h[i - 1] / h[i]
            d = float(1.0 + 1.0 / (2.0 * r)) * x0 - float(1.0 / (2.0 * r)) * x0_prev
            x = (float(sigma[i + 1] / sigma[i]) * x
                 - float(alpha[i + 1] * np.expm1(-h[i])) * d)
            x0_prev = x0
        return x0_of(x, n - 1)

    def _dispatch_sampler(self, x, cond_proj, stack, generator=None, step_noise=None,
                          seq=None):
        """DPM-Solver++ when `diff_sampler` is "dpmpp", PLMS when
        `pndm_speedup` is set, ancestral DDPM otherwise
        (`diffusion.py:142-157`)."""
        hp, k = self.hp, self.K_step
        if hp.get("diff_sampler", "plms") == "dpmpp":
            return self.dpmpp_sample_loop(x, cond_proj, k, int(hp.get("dpm_steps", 40)), stack,
                                          seq)
        if hp.get("pndm_speedup"):
            return self.plms_sample_loop(x, cond_proj, k, int(hp["pndm_speedup"]), stack, seq)
        return self.ddpm_sample_loop(x, cond_proj, k, stack, generator, step_noise, seq)

    def forward(self, txt_tokens, mel2ph=None, max_frames: Optional[int] = None,
                start_noise=None, step_noise=None, generator: Optional[torch.Generator] = None,
                seq=None, **cond):
        """Inference: -> dict with mel_out [B, T, 80], mel2ph, decoder_inp,
        fs2_mel (and the conditioner's f0_denorm when it predicts pitch).
        `start_noise` [B, T, 80] pins the start's draw (the gaussian start
        itself, or the noise `q_sample` adds to the fs2 mel), and
        `step_noise` [K, B, T, 80] DDPM's per-step draws; else they are drawn
        from `generator`. `seq`: the ('data', 'seq') mesh of long-form
        synthesis (module docstring), else None."""
        ret = self.fs2(txt_tokens, mel2ph=mel2ph, max_frames=max_frames, **cond)
        ret["fs2_mel"] = ret["mel_out"]
        ret["mel_out"] = self._sample(ret, ret["mel_out"], start_noise, step_noise, generator,
                                      mask=None if mel2ph is None else ret["mel2ph"] > 0,
                                      seq=seq)
        return ret

    def _sample(self, ret, fs2_mels, start_noise, step_noise, generator, sampler=None,
                mask=None, seq=None):
        """The start (gaussian, or `fs2_mels` noised to step K-1), the sampler
        (`sampler`, else `_dispatch_sampler`) over the conditioner's
        decoder input, the denormalised mel, times `mask` [B, T] if given.
        Under `seq` (the mesh): on this rank's window, which the sampler
        takes as `seq=(mesh, window)`, the draws and pins at the global
        shape; the rank's core frames."""
        m = seq
        shape, win = tuple(fs2_mels.shape), None
        if m is not None:
            halo = sequence.halo_for(self.hp, "denoiser")
            win = sequence.window(shape[1], m, halo or 0)
            shape = (shape[0] * m.shape["data"], *shape[1:])
        if start_noise is None:
            start_noise = torch.randn(shape, generator=generator, device=fs2_mels.device)
        elif tuple(start_noise.shape) != shape:
            raise ValueError(f"start_noise {tuple(start_noise.shape)} != {shape}")
        cond = ret["decoder_inp"]
        if m is not None:
            start_noise = sequence.local_window(start_noise, m, win)
            fs2_mels = win.of(fs2_mels)
            if halo is not None:  # the FFT denoiser's conditioner stays whole
                cond = win.of(cond)
        x = start_noise
        if not self.hp.get("gaussian_start"):
            x = self.q_sample(self.norm_spec(fs2_mels), self.K_step - 1, start_noise)
        cond_proj = self.denoise_fn.cond_projections(cond).contiguous()
        stack = self.denoise_fn.stack_weights()
        x = (sampler or self._dispatch_sampler)(x, cond_proj, stack, generator, step_noise,
                                                None if m is None else (m, win))
        x = self.denorm_spec(x)
        if m is not None:
            x = win.core(x)
            mask = None if mask is None else sequence.core_of(mask, m)
        return x if mask is None else x * mask.to(x.dtype)[:, :, None]


class OfflineGaussianDiffusion(GaussianDiffusion):
    """Shallow diffusion from recorded fs2 mels (`diffusion.py:436-501`): the
    conditioner stops at its decoder input; training is the online model's
    (the recorded mels play no part in it); inference starts from `fs2_mels` [B, T, 80] (the frames of the
    given mel2ph) and runs the K-step DDPM loop (the reference's offline
    variant never dispatches a fast sampler) unless `offline_fast_sampler`.
    The mel is not masked, as flax's is not. The conditioner has no decoder:
    it never runs one, so its flax module has no parameters for it."""

    fs2_decoder = False

    def forward(self, txt_tokens, mel2ph=None, fs2_mels=None, start_noise=None,
                step_noise=None, generator: Optional[torch.Generator] = None, seq=None,
                **cond):
        if mel2ph is None or fs2_mels is None:
            raise ValueError("the offline model needs mel2ph and the recorded fs2_mels")
        ret = self.fs2(txt_tokens, mel2ph=mel2ph, skip_decoder=True, **cond)
        sampler = None if self.hp.get("offline_fast_sampler") else (
            lambda x, cond_proj, stack, generator, step_noise, seq: self.ddpm_sample_loop(
                x, cond_proj, self.K_step, stack, generator, step_noise, seq))
        ret["mel_out"] = self._sample(ret, fs2_mels, start_noise, step_noise, generator, sampler,
                                      seq=seq)
        return ret


class PlainGaussianDiffusion(GaussianDiffusion):
    """DiffSpeech's non-shallow diffusion (`diffusion.py:502-509`): K_step is
    `timesteps`."""

    def __init__(self, hp: dict, vocab_size: int, out_dims: int = 80):
        super().__init__(hp, vocab_size, out_dims)
        self.K_step = int(hp["timesteps"])
