"""Duration predictor and the PitchExtractor's conv stacks, [B, T, C].

Counterpart of `bisinger_tpu/models/predictors.py:20-115, 213-308`
(ConvReluLN, DurationPredictor with the MSE head, PitchPredictor,
EnergyPredictor, Prenet, ConvStacks). The duration predictor's layers end in dropout
(`predictor_dropout`), which runs only when a caller passes
`deterministic=False`: FastSpeech2 calls its predictors without that
argument (`bisinger_tpu/models/fs2.py:203,211`), so flax runs them
deterministically in training too, and so does the port. The
PitchExtractor's modules take `deterministic` as flax's do: its pitch
predictor's dropout and its Prenet's batch statistics run in training.
The convs (and ConvStacks' input projection) run in `dtype`; the norms
compute in fp32 and return fp32, and the output heads are fp32, as in
the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bisinger_tpu_torch.models.common import (
    Conv,
    Dropout,
    Linear,
    batch_norm,
    group_norm,
    layer_norm,
    sinusoidal_positions,
)


class ConvReluLN(nn.Module):
    """SAME Conv -> ReLU -> LayerNorm(eps 1e-12) -> dropout
    (`predictors.py:20-48`)."""

    def __init__(self, cin: int, channels: int, kernel_size: int, dtype=torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.Conv_0 = Conv(cin, channels, kernel_size, dtype=dtype)
        self.LayerNorm_0 = nn.LayerNorm(channels, eps=1e-12)
        self.dropout = Dropout(dropout)

    def forward(self, x, deterministic: bool = True):
        x = layer_norm(self.LayerNorm_0, F.relu(self.Conv_0(x)))
        return x if deterministic else self.dropout(x)


class DurationPredictor(nn.Module):
    """Conv stack -> linear -> [B, T] log durations (`predictors.py:51-115`)."""

    offset = 1.0

    def __init__(self, cin: int, n_layers: int = 2, n_chans: int = 384, kernel_size: int = 3,
                 dtype=torch.float32, dropout: float = 0.0):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"conv_{i}", ConvReluLN(cin if i == 0 else n_chans, n_chans,
                                                    kernel_size, dtype, dropout))
        self.linear = nn.Linear(n_chans, 1)

    def forward(self, x, x_padding=None, deterministic: bool = True):
        keep = None if x_padding is None else (1.0 - x_padding.to(x.dtype))[:, :, None]
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x, deterministic)
            if keep is not None:
                x = x * keep
        x = self.linear(x)
        if keep is not None:
            x = x * keep
        return x[:, :, 0]

    def out2dur(self, xs):
        """Log-domain head -> integer frame counts (`predictors.py:98-103`)."""
        return torch.clamp(torch.round(torch.exp(xs) - self.offset), min=0.0).long()


class PitchPredictor(nn.Module):
    """Sinusoidal positions + conv stack -> linear (`predictors.py:213-237`);
    each layer's dropout runs when `deterministic` is False."""

    def __init__(self, cin: int, n_layers: int = 5, n_chans: int = 384, odim: int = 2,
                 kernel_size: int = 5, dtype=torch.float32, dropout: float = 0.0):
        super().__init__()
        self.n_layers = n_layers
        self.pos_embed_alpha = nn.Parameter(torch.ones(1))
        for i in range(n_layers):
            self.add_module(f"conv_{i}", ConvReluLN(cin if i == 0 else n_chans, n_chans,
                                                    kernel_size, dtype, dropout))
        self.linear = nn.Linear(n_chans, odim)

    def forward(self, x, deterministic: bool = True):
        nonpad = (x.abs().sum(-1) != 0).long()
        x = x + self.pos_embed_alpha * sinusoidal_positions(nonpad, x.shape[-1])
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x, deterministic)
        return self.linear(x)


class EnergyPredictor(PitchPredictor):
    """The energy head of FastSpeech2: a `PitchPredictor` (`predictors.py:243-246`)."""


class Prenet(nn.Module):
    """3 x (conv k=5 -> ReLU -> BatchNorm, masked) -> Dense, masked
    (`predictors.py:247-284`). BatchNorm with the running statistics, or with
    the batch's (padding frames included: the mask comes after the norm),
    updating the running ones, when `deterministic` is False."""

    def __init__(self, cin: int = 80, out_dim: int = 256, kernel: int = 5, n_layers: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"conv_{i}", Conv(cin if i == 0 else out_dim, out_dim, kernel,
                                              dtype=dtype))
            self.add_module(f"norm_{i}", nn.BatchNorm1d(out_dim, eps=1e-5))
        self.out_proj = nn.Linear(out_dim, out_dim)

    def forward(self, x, deterministic: bool = True):
        nonpad = 1.0 - (x.abs().sum(-1) == 0).to(x.dtype)[:, :, None]
        for i in range(self.n_layers):
            x = F.relu(getattr(self, f"conv_{i}")(x))
            x = batch_norm(getattr(self, f"norm_{i}"), x, use_running_average=deterministic)
            x = x * nonpad
        return self.out_proj(x) * nonpad


class ConvStacks(nn.Module):
    """Residual conv stack with GroupNorm (flax eps 1e-6)
    (`predictors.py:287-308`)."""

    def __init__(self, cin: int, n_layers: int = 5, n_chans: int = 256, odim: int = 256,
                 kernel_size: int = 5, dtype=torch.float32):
        super().__init__()
        self.n_layers = n_layers
        self.in_proj = Linear(cin, n_chans, dtype=dtype)
        for i in range(n_layers):
            self.add_module(f"conv_{i}", Conv(n_chans, n_chans, kernel_size, dtype=dtype))
            self.add_module(f"norm_{i}", nn.GroupNorm(n_chans // 16, n_chans, eps=1e-6))
        self.out_proj = nn.Linear(n_chans, odim)

    def forward(self, x):
        x = self.in_proj(x)
        for i in range(self.n_layers):
            y = getattr(self, f"conv_{i}")(x)
            y = group_norm(getattr(self, f"norm_{i}"), y)
            x = x + F.relu(y)  # fp32 from here: the norm's output promotes x
        return self.out_proj(x.to(self.out_proj.weight.dtype))
