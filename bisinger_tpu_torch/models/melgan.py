"""MelGAN generator and multi-scale discriminator (counterpart of
`bisinger_tpu/models/melgan.py:30-142`), [B, T, C] layout, fp32.

Generator: reflect pad 3 -> conv_pre (k7, VALID, `melgan_channels`) ->
per scale s of `melgan_upsample_scales`: leaky ReLU 0.2, a transposed conv
(k = 2s, stride s, flax's SAME: output T * s) to half the channels, a
`ResidualStack` (dilations 1, 3, 9, reflect-padded) -> leaky ReLU ->
reflect pad 3 -> conv_post (k7) -> tanh.

flax's SAME transposed conv (`lax.conv_transpose`, no kernel flip) pads
the stride-dilated input by ceil((k + s - 2) / 2) on the left and the rest
of k + s - 2 on the right; torch's `conv_transpose1d` without padding pads
k - 1 on both sides, so the port runs it unpadded and crops the
difference from each end (asymmetric for an odd s). The weights load as a
ConvTranspose1d's, taps reversed (`weights.to_torch_layout`).

Discriminator: conv0 (16, k15), four strided grouped convs (k41, stride 4,
groups in / 4, channels x4 up to 1024), conv5 (k5), conv_out (k3), all
with flax's SAME padding (the smaller half on the left, `hifigan.same_pad`)
and leaky ReLU 0.2; the multi-scale one runs 3 of them with flax's SAME
average pool (window 4, stride 2, the padded zeros counted) between.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch.nn.functional as F
from torch import nn

from bisinger_tpu_torch.models.hifigan import avg_pool_same, same_pad

LRELU_SLOPE = 0.2


def _lrelu(x):
    return F.leaky_relu(x, LRELU_SLOPE)


def conv_transpose_same(up: nn.ConvTranspose1d, x):
    """flax's ConvTranspose(k, stride s, SAME) of x [B, C, T] -> [B, C', T * s]."""
    k, s = up.kernel_size[0], up.stride[0]
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    y = F.conv_transpose1d(x, up.weight, up.bias, s)
    left, right = k - 1 - pad_a, k - 1 - (pad_len - pad_a)
    return y[:, :, left: y.shape[-1] - right]


class ResidualStack(nn.Module):
    """Per dilation d: lrelu -> reflect pad -> dilated conv_i (VALID) ->
    lrelu -> 1x1 out_i, plus a 1x1 skip_i of the input."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3, 9)):
        super().__init__()
        self.dilations, self.k = list(dilations), kernel_size
        for i, d in enumerate(self.dilations):
            self.add_module(f"conv_{i}", nn.Conv1d(channels, channels, kernel_size, dilation=d))
            self.add_module(f"out_{i}", nn.Conv1d(channels, channels, 1))
            self.add_module(f"skip_{i}", nn.Conv1d(channels, channels, 1))

    def forward(self, x):  # [B, C, T]
        for i, d in enumerate(self.dilations):
            p = (self.k - 1) // 2 * d
            y = getattr(self, f"conv_{i}")(F.pad(_lrelu(x), (p, p), mode="reflect"))
            x = getattr(self, f"out_{i}")(_lrelu(y)) + getattr(self, f"skip_{i}")(x)
        return x


class MelGanGenerator(nn.Module):
    """mel [B, T, 80] -> wav [B, T * prod(melgan_upsample_scales)]."""

    def __init__(self, hp: dict, in_channels: int = 80):
        super().__init__()
        self.scales = list(hp.get("melgan_upsample_scales", [8, 8, 2, 2]))
        c = int(hp.get("melgan_channels", 512))
        self.conv_pre = nn.Conv1d(in_channels, c, 7)
        for i, s in enumerate(self.scales):
            self.add_module(f"up_{i}", nn.ConvTranspose1d(c, c // 2, 2 * s, s))
            c //= 2
            self.add_module(f"res_{i}", ResidualStack(c))
        self.conv_post = nn.Conv1d(c, 1, 7)

    def forward(self, mel):
        x = self.conv_pre(F.pad(mel.float().transpose(1, 2), (3, 3), mode="reflect"))
        for i in range(len(self.scales)):
            x = conv_transpose_same(getattr(self, f"up_{i}"), _lrelu(x))
            x = getattr(self, f"res_{i}")(x)
        x = self.conv_post(F.pad(_lrelu(x), (3, 3), mode="reflect"))
        return x.tanh()[:, 0]


class MelGanDiscriminator(nn.Module):
    """wav [B, T] -> (logits [B, T'], feature maps [B, C, T_i])."""

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv1d(1, 16, 15)
        ch = 16
        for i in range(4):
            in_ch, ch = ch, min(ch * 4, 1024)
            self.add_module(f"conv{i + 1}", nn.Conv1d(in_ch, ch, 41, 4, groups=max(1, in_ch // 4)))
        self.conv5 = nn.Conv1d(ch, ch, 5)
        self.conv_out = nn.Conv1d(ch, 1, 3)

    def forward(self, wav):
        x = wav[:, None]
        feats = []
        for name in ("conv0", "conv1", "conv2", "conv3", "conv4", "conv5"):
            conv = getattr(self, name)
            x = _lrelu(conv(same_pad(x, conv.kernel_size[0], conv.stride[0])))
            feats.append(x)
        x = self.conv_out(same_pad(x, 3, 1))
        return x[:, 0], feats


class MelGanMultiScaleDiscriminator(nn.Module):
    """`scales` discriminators, the waveform average-pooled between them:
    [(logits, feature maps)] a scale."""

    def __init__(self, scales: int = 3):
        super().__init__()
        self.scales = scales
        for i in range(scales):
            self.add_module(f"disc_{i}", MelGanDiscriminator())

    def forward(self, wav):
        outs, x = [], wav
        for i in range(self.scales):
            outs.append(getattr(self, f"disc_{i}")(x))
            if i < self.scales - 1:
                x = avg_pool_same(x)
        return outs
