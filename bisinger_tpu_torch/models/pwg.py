"""Parallel WaveGAN: generator, discriminators and the cyclic-noise source
(counterpart of `bisinger_tpu/models/pwg.py:36-395`), [B, T, C] layout.

- `ParallelWaveGANGenerator` (`:134-178`): noise z [B, T * hop] and mel
  [B, T, 80] -> waveform [B, T * hop]. The mel is edge-padded by the
  aux context window and run through conv_in VALID (`:93-99`), then
  raised to the sample rate by `UpsampleNetwork`: per scale s a
  nearest-neighbour stretch and ONE (2s+1)-tap time kernel shared by all
  80 bins, run depthwise with SAME padding (`:56-75`). A non-causal
  WaveNet of `pwg_layers` gated blocks in `pwg_stacks` dilation cycles
  conditions on it; the skips' sum (times sqrt(1 / layers)) goes through
  ReLU, 1x1, ReLU, 1x1. The JAX generator takes its widths from its
  dataclass defaults and only `pwg_upsample_scales` from the
  hyperparameters; the port reads the `pwg_*` keys and `aux_context_window`
  of configs/tts/pwg.yaml with those defaults (equal to the YAML's values),
  and refuses scales whose product is not `hop_size` (ROADMAP Queue 3).
  Everything computes in fp32 whatever `compute_dtype` says, as the JAX
  module sets no dtype.
- `ParallelWaveGANDiscriminator` (`:181-205`): 9 dilated convs (dilation i,
  1 for the first, the reference's quirk) with leaky ReLU 0.2, then one
  conv to a logit a sample; `ResidualParallelWaveGANDiscriminator`
  (`:208-245`): the WaveNet blocks without conditioning.
- `pulse_gen`, `cyclic_noise_gen`, `source_module_cyc_noise` (`:248-395`):
  the cyclic-noise excitation. Their normal draws are handed in as tensors
  (`draws`: "sine", "pulse", "ir", "noise") or drawn from `generator`; the
  phase's running sum is taken in fp64 (as `models/hifigan.sine_gen`), and
  its steps by `phase_steps`.

flax's SAME padding of a stride-1 conv puts the smaller half of
dilation * (k - 1) zeros on the left.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bisinger_tpu_torch.models.hifigan import phase_steps

PWG_DEFAULTS = dict(pwg_layers=30, pwg_stacks=3, pwg_residual_channels=64,
                    pwg_gate_channels=128, pwg_skip_channels=64, pwg_aux_channels=80,
                    aux_context_window=2, pwg_upsample_scales=(4, 4, 4, 2))


def pwg_settings(hp) -> Dict:
    """The generator's keys of `hp` with JAX's defaults; raises ValueError
    when the upsample scales do not multiply to `hop_size`."""
    out = {k: hp.get(k, v) for k, v in PWG_DEFAULTS.items()}
    out["pwg_upsample_scales"] = [int(s) for s in out["pwg_upsample_scales"]]
    prod = int(np.prod(out["pwg_upsample_scales"]))
    if prod != int(hp["hop_size"]):
        raise ValueError(f"pwg_upsample_scales {out['pwg_upsample_scales']} multiply to {prod}, "
                         f"hop_size is {hp['hop_size']}: the aux features would not cover the "
                         "noise; set pwg_upsample_scales to a product of hop_size")
    return out


def same_conv(conv: nn.Conv1d, x):
    """`conv` (stride 1) over x [B, T, C] with flax's SAME padding."""
    total = conv.dilation[0] * (conv.kernel_size[0] - 1)
    y = F.conv1d(F.pad(x.transpose(1, 2), (total // 2, total - total // 2)), conv.weight,
                 conv.bias, dilation=conv.dilation)
    return y.transpose(1, 2)


def pointwise(conv: nn.Conv1d, x):
    """A 1x1 conv over x [B, T, C]."""
    return F.conv1d(x.transpose(1, 2), conv.weight, conv.bias).transpose(1, 2)


class UpsampleNetwork(nn.Module):
    """Per scale: nearest stretch by s, then one shared (2s+1)-tap kernel
    (`conv_{i}_kernel`, flax's (k, 1, 1)) over every bin, SAME."""

    def __init__(self, upsample_scales: Sequence[int]):
        super().__init__()
        self.scales = list(upsample_scales)
        for i, s in enumerate(self.scales):
            k = 2 * s + 1
            self.register_parameter(f"conv_{i}_kernel", nn.Parameter(torch.full((k, 1, 1), 1.0 / k)))

    def forward(self, c):
        b, _, m = c.shape
        for i, s in enumerate(self.scales):
            c = torch.repeat_interleave(c, s, dim=1)
            w = getattr(self, f"conv_{i}_kernel").reshape(1, 1, -1)
            y = F.conv1d(c.transpose(1, 2).reshape(b * m, 1, -1), w, padding=s)
            c = y.reshape(b, m, -1).transpose(1, 2)
        return c


class ConvInUpsampleNetwork(nn.Module):
    """Edge padding by the context window, conv_in VALID (no bias), then
    `UpsampleNetwork`."""

    def __init__(self, upsample_scales: Sequence[int], in_channels: int = 80,
                 aux_channels: int = 80, aux_context_window: int = 2):
        super().__init__()
        self.aw = aux_context_window
        self.conv_in = nn.Conv1d(in_channels, aux_channels, 2 * aux_context_window + 1,
                                 bias=False)
        self.upsample = UpsampleNetwork(upsample_scales)

    def forward(self, c):
        x = c.transpose(1, 2)
        if self.aw > 0:
            x = F.pad(x, (self.aw, self.aw), mode="replicate")
        return self.upsample(self.conv_in(x).transpose(1, 2))


class PWGResidualBlock(nn.Module):
    """Gated WaveNet block: dilated conv (+ 1x1 of the aux features when
    `aux_channels`), tanh * sigmoid, 1x1 skip and 1x1 out; returns ((out +
    x) * sqrt(0.5), skip)."""

    def __init__(self, residual_channels: int = 64, gate_channels: int = 128,
                 skip_channels: int = 64, aux_channels: Optional[int] = 80,
                 kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(residual_channels, gate_channels, kernel_size, dilation=dilation)
        if aux_channels:
            self.aux_conv = nn.Conv1d(aux_channels, gate_channels, 1, bias=False)
        self.skip_conv = nn.Conv1d(gate_channels // 2, skip_channels, 1)
        self.out_conv = nn.Conv1d(gate_channels // 2, residual_channels, 1)

    def forward(self, x, c=None):
        y = same_conv(self.conv, x)
        if c is not None:
            y = y + pointwise(self.aux_conv, c)
        a, b = y.chunk(2, dim=-1)
        y = torch.tanh(a) * torch.sigmoid(b)
        return (pointwise(self.out_conv, y) + x) * math.sqrt(0.5), pointwise(self.skip_conv, y)


class ParallelWaveGANGenerator(nn.Module):
    """z [B, T * hop] + mel [B, T, 80] -> wav [B, T * hop], fp32."""

    def __init__(self, hp: dict, n_mels: int = 80):
        super().__init__()
        s = pwg_settings(hp)
        self.scales = s["pwg_upsample_scales"]
        self.hop = int(np.prod(self.scales))
        self.layers = s["pwg_layers"]
        per_stack = self.layers // s["pwg_stacks"]
        res, skip = s["pwg_residual_channels"], s["pwg_skip_channels"]
        self.upsample_net = ConvInUpsampleNetwork(self.scales, n_mels, s["pwg_aux_channels"],
                                                  s["aux_context_window"])
        self.first_conv = nn.Conv1d(1, res, 1)
        for i in range(self.layers):
            self.add_module(f"block_{i}", PWGResidualBlock(
                res, s["pwg_gate_channels"], skip, s["pwg_aux_channels"],
                dilation=2 ** (i % per_stack)))
        self.post_conv_1 = nn.Conv1d(skip, skip, 1)
        self.post_conv_2 = nn.Conv1d(skip, 1, 1)

    def forward(self, z, mel):
        c = self.upsample_net(mel.float())[:, :z.shape[1]]
        x = pointwise(self.first_conv, z[:, :, None].float())
        skips = 0.0
        for i in range(self.layers):
            x, skip = getattr(self, f"block_{i}")(x, c)
            skips = skips + skip
        y = F.relu(skips * math.sqrt(1.0 / self.layers))
        y = pointwise(self.post_conv_2, F.relu(pointwise(self.post_conv_1, y)))
        return y[..., 0]


class ParallelWaveGANDiscriminator(nn.Module):
    """wav [B, T] -> logits [B, T]."""

    def __init__(self, layers: int = 10, conv_channels: int = 64, kernel_size: int = 3):
        super().__init__()
        self.n = layers - 1
        cin = 1
        for i in range(self.n):
            self.add_module(f"conv_{i}", nn.Conv1d(cin, conv_channels, kernel_size,
                                                   dilation=i if i > 0 else 1))
            cin = conv_channels
        self.conv_out = nn.Conv1d(cin, 1, kernel_size)

    def forward(self, x):
        x = x[:, :, None]
        for i in range(self.n):
            x = F.leaky_relu(same_conv(getattr(self, f"conv_{i}"), x), 0.2)
        return same_conv(self.conv_out, x)[..., 0]


class ResidualParallelWaveGANDiscriminator(nn.Module):
    """wav [B, T] -> logits [B, T]: 1x1 in, gated blocks without
    conditioning, the skips' sum times sqrt(1 / layers), leaky ReLU 0.2 and
    two 1x1 convs."""

    def __init__(self, layers: int = 30, stacks: int = 3, residual_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64, kernel_size: int = 3,
                 out_channels: int = 1):
        super().__init__()
        if layers % stacks:
            raise ValueError(f"layers {layers} is not a multiple of stacks {stacks}")
        self.layers, per_stack = layers, layers // stacks
        self.first_conv = nn.Conv1d(1, residual_channels, 1)
        for i in range(layers):
            self.add_module(f"block_{i}", PWGResidualBlock(
                residual_channels, gate_channels, skip_channels, None, kernel_size,
                2 ** (i % per_stack)))
        self.post_conv_1 = nn.Conv1d(skip_channels, skip_channels, 1)
        self.post_conv_2 = nn.Conv1d(skip_channels, out_channels, 1)
        self.out_channels = out_channels

    def forward(self, x):
        x = F.leaky_relu(pointwise(self.first_conv, x[:, :, None]), 0.2)
        skips = 0.0
        for i in range(self.layers):
            x, skip = getattr(self, f"block_{i}")(x)
            skips = skips + skip
        y = F.leaky_relu(skips * math.sqrt(1.0 / self.layers), 0.2)
        y = pointwise(self.post_conv_2, F.leaky_relu(pointwise(self.post_conv_1, y), 0.2))
        return y[..., 0] if self.out_channels == 1 else y


# --------------------------------------------------------------------------
# The cyclic-noise excitation (`bisinger_tpu/models/pwg.py:248-395`)
# --------------------------------------------------------------------------
def _normal(draws, key, shape, like, generator):
    if draws is not None and key in draws:
        d = draws[key]
        d = torch.from_numpy(np.array(d)) if isinstance(d, np.ndarray) else d
        return d.to(like.device, like.dtype)
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def pulse_gen(f0, sample_rate: int, pulse_amp: float = 0.1, noise_std: float = 0.003,
              voiced_threshold: float = 0.0, draws=None, generator=None):
    """f0 [B, T, 1] at the sample rate (0 = unvoiced) -> (pulse_train,
    sine_wav, uv, pulse_noise), each [B, T, 1]. The sine's phase restarts at
    the last step of every unvoiced stretch; a pulse sits on each voiced
    local maximum of the sine and at each voiced onset. Draws: "sine" (the
    unvoiced noise floor) and "pulse", N(0, 1) of f0's shape."""
    rad = phase_steps(f0, sample_rate)
    uv = (f0 > voiced_threshold).to(f0.dtype)
    uv_next = torch.cat([uv[:, 1:], torch.ones_like(uv[:, :1])], dim=1)
    u_loc = (uv < 1) & (uv_next > 0)
    csum = torch.cumsum(rad.double(), dim=1)
    t_idx = torch.arange(f0.shape[1], device=f0.device)[None, :, None]
    reset = torch.cummax(torch.where(u_loc, t_idx, torch.full_like(t_idx, -1)), dim=1).values
    sub = torch.where(reset >= 0, torch.gather(csum, 1, reset.clamp_min(0)),
                      torch.zeros_like(csum))
    pure_sine = (torch.cos((csum - sub) * (2 * np.pi)) * pulse_amp).to(f0.dtype)
    noise = (1.0 - uv) * pulse_amp / 3.0 * _normal(draws, "sine", f0.shape, f0, generator)
    sine_wav = pure_sine * uv + noise
    sine_prev = torch.cat([pure_sine[:, -1:], pure_sine[:, :-1]], dim=1)
    uv_prev = torch.cat([torch.zeros_like(uv[:, :1]), uv[:, :-1]], dim=1)
    sine_next = torch.cat([pure_sine[:, 1:], pure_sine[:, :1]], dim=1)
    uv_next0 = torch.cat([uv[:, 1:], torch.zeros_like(uv[:, :1])], dim=1)
    loc = (((pure_sine > sine_prev) & (pure_sine > sine_next) & (uv_prev > 0)
            & (uv_next0 > 0) & (uv > 0)) | ((uv_prev < 1) & (uv > 0))).to(f0.dtype)
    pulse_noise = noise_std * _normal(draws, "pulse", f0.shape, f0, generator)
    pulse_train = pure_sine * loc + pulse_noise * loc + pulse_noise * (1.0 - uv)
    return pulse_train, sine_wav, uv, pulse_noise


def cyclic_noise_gen(f0, beta, sample_rate: int, noise_std: float = 0.003,
                     voiced_threshold: float = 0.0, f0_floor: float = 80.0, draws=None,
                     generator=None):
    """Exponentially decayed noise bursts convolved onto a unit pulse train:
    (cyc_noise, pulse_train, sine_wav, uv, noise). The impulse response has
    ceil(4.6 * sr / f0_floor) taps ("ir", N(0, 1)), decays as exp(-t *
    f0_mean / (beta * sr)) and is cut at 4.6 * sr / f0_mean."""
    pulse_train, sine_wav, uv, noise = pulse_gen(f0, sample_rate, 1.0, noise_std,
                                                 voiced_threshold, draws, generator)
    pure_pulse = pulse_train - noise
    n_voiced = torch.clamp_min(uv.sum(), 1.0)
    f0_mean = torch.clamp_min((f0 * uv).sum() / n_voiced, f0_floor * 0.999)
    ir_len = int(np.ceil(4.6 * sample_rate / f0_floor))
    t_ir = torch.arange(ir_len, dtype=f0.dtype, device=f0.device)
    decay = torch.exp(-t_ir * f0_mean / beta / sample_rate)
    trunc = (t_ir < 4.6 * sample_rate / f0_mean).to(f0.dtype)
    ir = _normal(draws, "ir", (ir_len,), f0, generator) * noise_std * decay * trunc
    sig = F.pad(pure_pulse[..., 0], (ir_len - 1, 0))[:, None, :]
    cyc = F.conv1d(sig, torch.flip(ir, (0,))[None, None, :])[:, 0, :, None]
    any_voiced = (uv.sum() > 0).to(f0.dtype)
    return cyc * any_voiced + noise * (1.0 - uv), pulse_train, sine_wav, uv, noise


def source_module_cyc_noise(f0_upsampled, beta, sample_rate: int, noise_std: float = 0.003,
                            voiced_threshold: float = 0.0, draws=None, generator=None):
    """The cyclic-noise excitation for NSF: (cyc [B, T, 1], noise [B, T, 1],
    uv); "noise" is the N(0, 1) draw of the second output."""
    cyc, _, _, uv, _ = cyclic_noise_gen(f0_upsampled, beta, sample_rate, noise_std,
                                        voiced_threshold, draws=draws, generator=generator)
    noise = _normal(draws, "noise", uv.shape, uv, generator) * noise_std / 3.0
    return cyc, noise, uv
