"""NSF HiFi-GAN generator, inference
(counterpart of `bisinger_tpu/models/hifigan.py:43-111, 187-221, 247-414`).

conv_pre (k7) -> per stage: leaky_relu(0.1) -> ConvTranspose up ->
+ LayerNorm(ReLU(strided noise_conv(harmonic source))) -> MRF stage (K2,
`ops/mrf_stage`) -> leaky_relu(0.01) -> conv_post (k7) -> tanh.
The NSF source's random phase and noise can be handed in as tensors so
that tests pin them. No time fold, no sub-pixel lowering, no PQMF.

As `bisinger_tpu/models/hifigan.py:263-400`, conv_pre, the upsample and
noise convs compute in `compute_dtype`, the noise LayerNorm in fp32 (so
the stage input is fp32 again), and the MRF stages run through
`mrf_stage_bf16` (the TPU kernel's bf16 rounding) under bfloat16 and
`mrf_stage` under float32; the NSF source and conv_post are fp32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bisinger_tpu_torch.models.common import Conv, compute_dtype, layer_norm, scale
from bisinger_tpu_torch.ops.mrf_stage import mrf_stage, mrf_stage_bf16, pack_stage_weights

LRELU_SLOPE = 0.1


def sine_gen(f0, sample_rate: int, harmonic_num: int = 8, sine_amp: float = 0.1,
             noise_std: float = 0.003, voiced_threshold: float = 0.0, phase=None, noise=None,
             generator: Optional[torch.Generator] = None):
    """Harmonic sine bank (`hifigan.py:43-81`). f0 [B, T, 1] at the sample
    rate. `phase` [B, H+1] ~ U[0, 1) (column 0 is ignored: the fundamental
    gets none) and `noise` [B, T, H+1] ~ N(0, 1) are drawn from `generator`
    when not given. Returns (sine_waves [B, T, H+1], uv [B, T, 1])."""
    b, t, _ = f0.shape
    dim = harmonic_num + 1
    mult = torch.arange(1, dim + 1, dtype=f0.dtype, device=f0.device)
    rad = torch.remainder(f0 * mult / sample_rate, 1.0)
    if phase is None:
        phase = torch.rand((b, dim), generator=generator, device=f0.device, dtype=f0.dtype)
    phase = torch.cat([torch.zeros_like(phase[:, :1]), phase[:, 1:]], dim=1)
    rad = torch.cat([rad[:, :1] + phase[:, None, :], rad[:, 1:]], dim=1)
    # fp32-stable phase: subtract 1 wherever the running sum wraps
    tmp_over_one = torch.remainder(torch.cumsum(rad, dim=1), 1.0)
    wrap = (tmp_over_one[:, 1:] - tmp_over_one[:, :-1]) < 0
    shift = F.pad(wrap.to(f0.dtype) * -1.0, (0, 0, 1, 0))
    sines = torch.sin(torch.cumsum(rad + shift, dim=1) * 2 * np.pi)
    uv = (f0 > voiced_threshold).to(f0.dtype)
    if noise is None:
        noise = torch.randn(sines.shape, generator=generator, device=f0.device, dtype=f0.dtype)
    noise = (uv * noise_std + (1.0 - uv) * sine_amp / 3.0) * noise
    return sines * sine_amp * uv + noise, uv


class SourceModuleHnNSF(nn.Module):
    """tanh(Dense(harmonic bank)) -> one excitation channel."""

    def __init__(self, sample_rate: int, harmonic_num: int = 8):
        super().__init__()
        self.sample_rate, self.harmonic_num = sample_rate, harmonic_num
        self.merge = nn.Linear(harmonic_num + 1, 1)

    def forward(self, f0, phase=None, noise=None, generator=None):
        sine_wavs, uv = sine_gen(f0, self.sample_rate, self.harmonic_num, phase=phase,
                                 noise=noise, generator=generator)
        return torch.tanh(self.merge(sine_wavs)), uv


def leaky_relu(x, slope: float):
    """jax.nn.leaky_relu in x's dtype: the slope is rounded to it first."""
    if x.dtype == torch.float32:
        return F.leaky_relu(x, slope)
    return torch.where(x >= 0, x, scale(x, slope))


class ResBlock1(nn.Module):
    """Parameters of one MRF residual block (conv1_i dilated, conv2_i);
    the stage's blocks run together in K2."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int]):
        super().__init__()
        for i, d in enumerate(dilations):
            self.add_module(f"conv1_{i}", nn.Conv1d(channels, channels, kernel_size,
                                                    dilation=d, padding=d * (kernel_size - 1) // 2))
            self.add_module(f"conv2_{i}", nn.Conv1d(channels, channels, kernel_size,
                                                    padding=(kernel_size - 1) // 2))


class HifiGanGenerator(nn.Module):
    """mel [B, T, 80], f0 [B, T] -> waveform [B, T * hop]."""

    def __init__(self, hp: dict, n_mels: int = 80):
        super().__init__()
        if str(hp.get("resblock", "1")) != "1":
            raise NotImplementedError("the port's MRF runs ResBlock1")
        if int(hp.get("vocoder_multiband", 1)) > 1:
            raise NotImplementedError("PQMF multiband is not ported")
        if hp.get("use_denoise") or not hp.get("use_nsf", True):
            raise NotImplementedError("the port runs the NSF vocoder without post-denoising")
        self.rates = list(hp["upsample_rates"])
        self.rk = list(hp["resblock_kernel_sizes"])
        self.rd = [list(d) for d in hp["resblock_dilation_sizes"]]
        c0 = hp["upsample_initial_channel"]
        self.dtype_ = dt = compute_dtype(hp)
        self.conv_pre = Conv(n_mels, c0, 7, dtype=dt)
        self.m_source = SourceModuleHnNSF(hp["audio_sample_rate"], harmonic_num=8)
        c_prev = c0
        for i, (u, k) in enumerate(zip(self.rates, hp["upsample_kernel_sizes"])):
            c = c0 // (2 ** (i + 1))
            self.add_module(f"up_{i}", nn.ConvTranspose1d(c_prev, c, k, u, padding=(k - u) // 2))
            s = int(np.prod(self.rates[i + 1:]))
            self.add_module(f"noise_conv_{i}",
                            Conv(1, c, 2 * s, stride=s, padding=s // 2, dtype=dt) if s > 1
                            else Conv(1, c, 1, dtype=dt))
            self.add_module(f"noise_norm_{i}", nn.LayerNorm(c, eps=1e-6))
            for j, (kj, dj) in enumerate(zip(self.rk, self.rd)):
                self.add_module(f"res_{i}_{j}", ResBlock1(c, kj, dj))
            c_prev = c
        self.conv_post = Conv(c_prev, 1, 7)

    def stage_weights(self, i: int):
        """(w in compute_dtype, b fp32) of stage i, packed for K2."""
        blocks = [getattr(self, f"res_{i}_{j}") for j in range(len(self.rk))]
        return pack_stage_weights(blocks, self.rk, self.rd, self.dtype_)

    def upsample(self, i: int, x):
        """ConvTranspose1d of stage i in compute_dtype (`ops/subpixel.py:127-145`)."""
        up, dt = getattr(self, f"up_{i}"), self.dtype_
        y = F.conv_transpose1d(x.transpose(1, 2).to(dt), up.weight.to(dt), None, up.stride,
                               up.padding)
        return (y + up.bias.to(dt)[:, None]).transpose(1, 2)

    def forward(self, mel, f0, phase=None, noise=None, generator=None):
        hop = int(np.prod(self.rates))
        f0_up = torch.repeat_interleave(f0, hop, dim=1)[:, :, None]
        har, _ = self.m_source(f0_up, phase, noise, generator)
        stage = mrf_stage_bf16 if self.dtype_ == torch.bfloat16 else mrf_stage
        x = self.conv_pre(mel)
        for i in range(len(self.rates)):
            x = self.upsample(i, leaky_relu(x, LRELU_SLOPE))
            xs = F.relu(getattr(self, f"noise_conv_{i}")(har))
            xs = layer_norm(getattr(self, f"noise_norm_{i}"), xs)
            x = (x + xs[:, :x.shape[1]]).contiguous()  # fp32: the norm's output promotes x
            w, b = self.stage_weights(i)
            x = stage(x, w, b, self.rk, self.rd)
        x = F.leaky_relu(x)  # slope 0.01, as the reference's final activation
        return torch.tanh(self.conv_post(x))[..., 0]
