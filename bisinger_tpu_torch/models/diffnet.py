"""DiffNet denoiser (counterpart of `bisinger_tpu/models/diffnet.py:32-200`).

in-proj 1x1 (80 -> C) -> ReLU -> L gated residual layers -> skip sum /
sqrt(L) -> 1x1 -> ReLU -> 1x1 (C -> 80). The conditioner projections are
step-invariant: `cond_projections` computes them once per utterance, and
`stack_weights` stacks the layers' weights once per sampling loop. The
residual layers run through K1 (`ops/diffnet_stack.residual_stack`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from bisinger_tpu_torch.models.common import Conv
from bisinger_tpu_torch.ops.diffnet_stack import residual_stack


def diffusion_step_embedding(t, dim: int):
    """[sin | cos] of the step over log-spaced frequencies (`diffnet.py:32-39`)."""
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class ResidualBlock(nn.Module):
    """Parameters of one gated residual layer (`diffnet.py:47-85`); the
    layers run together in K1."""

    def __init__(self, channels: int, cond_dims: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.diffusion_projection = nn.Linear(channels, channels)
        self.dilated_conv = Conv(channels, 2 * channels, 3, dilation=dilation)
        self.conditioner_projection = nn.Linear(cond_dims, 2 * channels)
        self.output_projection = nn.Linear(channels, 2 * channels)


class DiffNet(nn.Module):
    def __init__(self, hp: dict, in_dims: int = 80):
        super().__init__()
        c = hp["residual_channels"]
        self.channels, self.n_layers = c, hp["residual_layers"]
        self.dilations = [2 ** (i % hp["dilation_cycle_length"]) for i in range(self.n_layers)]
        self.input_projection = nn.Linear(in_dims, c)
        self.mlp_0 = nn.Linear(c, 4 * c)
        self.mlp_1 = nn.Linear(4 * c, c)
        for i, d in enumerate(self.dilations):
            self.add_module(f"res_{i}", ResidualBlock(c, hp["hidden_size"], d))
        self.skip_projection = nn.Linear(c, c)
        self.output_projection = nn.Linear(c, in_dims)

    def blocks(self):
        return [getattr(self, f"res_{i}") for i in range(self.n_layers)]

    def cond_projections(self, cond):
        """[B, T, H] -> [L, B, T, 2C]."""
        return torch.stack([blk.conditioner_projection(cond) for blk in self.blocks()])

    def stack_weights(self):
        """The layers' weights in K1's layout: (wstep [L,C,C] as in->out,
        bstep [L,C], wd [L,3,C,2C], bd [L,2C], wo [L,C,2C], bo [L,2C])."""
        blks = self.blocks()
        return (
            torch.stack([b.diffusion_projection.weight.t() for b in blks]),
            torch.stack([b.diffusion_projection.bias for b in blks]),
            torch.stack([b.dilated_conv.weight.permute(2, 1, 0) for b in blks]).contiguous(),
            torch.stack([b.dilated_conv.bias for b in blks]),
            torch.stack([b.output_projection.weight.t() for b in blks]).contiguous(),
            torch.stack([b.output_projection.bias for b in blks]),
        )

    def forward(self, spec, diffusion_step, cond_proj, stack=None):
        """spec [B, T, M], diffusion_step [B] int, cond_proj [L, B, T, 2C]
        -> predicted noise [B, T, M]."""
        wstep, bstep, wd, bd, wo, bo = stack if stack is not None else self.stack_weights()
        x = F.relu(self.input_projection(spec))
        s = self.mlp_0(diffusion_step_embedding(diffusion_step, self.channels))
        s = self.mlp_1(s * torch.tanh(F.softplus(s)))  # Mish
        step_proj = torch.einsum("bc,lcd->lbd", s, wstep) + bstep[:, None, :]
        skip = residual_stack(x.contiguous(), cond_proj, step_proj.contiguous(), wd, bd, wo, bo,
                              self.dilations)
        y = F.relu(self.skip_projection(skip * (1.0 / math.sqrt(self.n_layers))))
        return self.output_projection(y)
