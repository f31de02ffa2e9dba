"""Gaussian diffusion mel decoder, inference with the PLMS sampler
(counterpart of `bisinger_tpu/models/diffusion.py:35-120, 211-277, 352-435`).

fs2 -> cond (decoder input) -> gaussian start -> PLMS over K steps with
stride `pndm_speedup` (the 2-call warmup, then Adams-Bashforth 2/3/4) ->
denormalised mel. The DDPM and DPM-Solver++ samplers and the shallow
(q_sample) start are not ported yet and raise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from bisinger_tpu_torch.models.diffnet import DiffNet
from bisinger_tpu_torch.models.fs2 import FastSpeech2MIDI


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
    """Owns the fs2 conditioner and the DiffNet denoiser."""

    def __init__(self, hp: dict, vocab_size: int, out_dims: int = 80):
        super().__init__()
        if not hp.get("use_midi"):
            raise NotImplementedError("the port runs the FastSpeech2MIDI conditioner only")
        if hp.get("diff_decoder_type", "wavenet") != "wavenet":
            raise NotImplementedError("the port's denoiser is the DiffNet (wavenet)")
        self.hp = hp
        self.fs2 = FastSpeech2MIDI(hp, vocab_size)
        self.denoise_fn = DiffNet(hp, out_dims)
        # float32 as the reference's buffers; kept on the device so that the
        # sampler's per-step reads need no host-to-device copy
        alphas_cumprod = np.cumprod(1.0 - make_betas(hp), axis=0).astype(np.float32)
        self.register_buffer("alphas_cumprod", torch.from_numpy(alphas_cumprod),
                             persistent=False)
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

    def plms_sample_loop(self, x, cond_proj, k: int, interval: int, stack=None):
        """PLMS reverse loop (`diffusion.py:227-277`): one denoiser call per
        step after a 2-call warmup; k/interval + 1 calls in all."""
        ts = np.arange(0, k, interval)[::-1]
        b = x.shape[0]

        def dn(xx, tv: int):
            tb = torch.full((b,), tv, dtype=torch.long, device=x.device)
            return self.denoise_fn(xx, tb, cond_proj, stack)

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

    def forward(self, txt_tokens, mel2ph=None, spk_id=None, pitch_midi=None, midi_dur=None,
                is_slur=None, lang=None, speechsing=None, max_frames: Optional[int] = None,
                start_noise=None, generator: Optional[torch.Generator] = None):
        """Inference: -> dict with mel_out [B, T, 80], mel2ph, decoder_inp,
        fs2_mel. `start_noise` [B, T, 80] pins the gaussian start; else it
        is drawn from `generator`."""
        hp = self.hp
        if not hp.get("gaussian_start"):
            raise NotImplementedError("the shallow (q_sample) start is not ported")
        if hp.get("diff_sampler", "plms") != "plms" or not hp.get("pndm_speedup"):
            raise NotImplementedError("the port's sampler is PLMS (pndm_speedup > 0)")
        ret = self.fs2(txt_tokens, mel2ph=mel2ph, spk_id=spk_id, pitch_midi=pitch_midi,
                       midi_dur=midi_dur, is_slur=is_slur, lang=lang, speechsing=speechsing,
                       max_frames=max_frames)
        ret["fs2_mel"] = ret["mel_out"]
        shape = ret["mel_out"].shape
        if start_noise is None:
            start_noise = torch.randn(shape, generator=generator, device=txt_tokens.device)
        elif tuple(start_noise.shape) != tuple(shape):
            raise ValueError(f"start_noise {tuple(start_noise.shape)} != {tuple(shape)}")
        cond_proj = self.denoise_fn.cond_projections(ret["decoder_inp"]).contiguous()
        stack = self.denoise_fn.stack_weights()
        x = self.plms_sample_loop(start_noise, cond_proj, hp["K_step"], int(hp["pndm_speedup"]),
                                  stack)
        x = self.denorm_spec(x)
        if mel2ph is not None:
            x = x * (ret["mel2ph"] > 0).to(x.dtype)[:, :, None]
        ret["mel_out"] = x
        return ret
