"""The denoisers (counterpart of `bisinger_tpu/models/diffnet.py:32-268`):
the DiffNet (`diff_decoder_type: wavenet`) and the FFT denoiser (`fft`).

in-proj 1x1 (80 -> C) -> ReLU -> L gated residual layers -> skip sum /
sqrt(L) -> 1x1 -> ReLU -> 1x1 (C -> 80). The conditioner projections are
step-invariant: `cond_projections` computes them once per utterance, and
`stack_weights` stacks the layers' weights once per sampling loop. The
residual layers run through K1: `ops/diffnet_stack.residual_stack_bf16`
under compute_dtype bfloat16 (the default), `residual_stack` under
float32. As `bisinger_tpu/models/diffnet.py:100-130`, every projection but
the last computes in `compute_dtype`, and the output is fp32.

Training passes `cond` (the fs2 decoder input) instead of `cond_proj`, as
`bisinger_tpu/models/diffnet.py:164-174` does: that path runs the layers
one by one in plain autograd ops (`ResidualBlock.forward`), rounding where
flax's layers round, and never reaches K1, which has no backward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from bisinger_tpu_torch.models.common import (
    Conv,
    FFTBlocks,
    Linear,
    compute_dtype,
    div,
    softplus,
)
from bisinger_tpu_torch.ops.diffnet_stack import residual_stack, residual_stack_bf16


def diffusion_step_embedding(t, dim: int):
    """[sin | cos] of the step over log-spaced frequencies (`diffnet.py:32-39`)."""
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class ResidualBlock(nn.Module):
    """One gated residual layer (`diffnet.py:47-85`). Sampling runs the
    layers together in K1 from `DiffNet.stack_weights`; training runs
    `forward`, every projection in compute_dtype."""

    def __init__(self, channels: int, cond_dims: int, dilation: int, dtype=torch.float32):
        super().__init__()
        self.dilation = dilation
        self.diffusion_projection = Linear(channels, channels, dtype=dtype)
        self.dilated_conv = Conv(channels, 2 * channels, 3, dilation=dilation, dtype=dtype)
        self.conditioner_projection = Linear(cond_dims, 2 * channels, dtype=dtype, conv1x1=True)
        self.output_projection = Linear(channels, 2 * channels, dtype=dtype, conv1x1=True)

    def forward(self, x, cond_proj, step):
        """x [B, T, C], cond_proj [B, T, 2C], step [B, C] -> (the next x, this
        layer's skip), flax's `ResidualBlock.__call__` op for op."""
        y = x + self.diffusion_projection(step)[:, None, :]
        y = self.dilated_conv(y) + cond_proj
        gate, filt = y.chunk(2, dim=-1)
        residual, skip = self.output_projection(torch.sigmoid(gate) * torch.tanh(filt)).chunk(
            2, dim=-1)
        return div(x + residual, math.sqrt(2.0)), skip


class DiffNet(nn.Module):
    def __init__(self, hp: dict, in_dims: int = 80):
        super().__init__()
        c = hp["residual_channels"]
        self.channels, self.n_layers = c, hp["residual_layers"]
        self.dtype_ = dt = compute_dtype(hp)
        self.dilations = [2 ** (i % hp["dilation_cycle_length"]) for i in range(self.n_layers)]
        self.input_projection = Linear(in_dims, c, dtype=dt, conv1x1=True)
        self.mlp_0 = Linear(c, 4 * c, dtype=dt)
        self.mlp_1 = Linear(4 * c, c, dtype=dt)
        for i, d in enumerate(self.dilations):
            self.add_module(f"res_{i}", ResidualBlock(c, hp["hidden_size"], d, dt))
        self.skip_projection = Linear(c, c, dtype=dt, conv1x1=True)
        self.output_projection = Linear(c, in_dims, conv1x1=True)  # fp32: feeds the sampler

    def blocks(self):
        return [getattr(self, f"res_{i}") for i in range(self.n_layers)]

    def cond_projections(self, cond):
        """[B, T, H] -> [L, B, T, 2C] in compute_dtype."""
        return torch.stack([blk.conditioner_projection(cond) for blk in self.blocks()])

    def stack_weights(self):
        """The weights one sampling loop reuses: the layers' in K1's layout,
        (wstep [L,C,C] as in->out, bstep [L,C], wd [L,3,C,2C], bd [L,2C],
        wo [L,C,2C], bo [L,2C]), all but the K1 biases bd and bo (fp32) in
        compute_dtype, and the projections' (weight, bias) in it by name."""
        blks, dt = self.blocks(), self.dtype_
        return (
            torch.stack([b.diffusion_projection.weight.t() for b in blks]).to(dt),
            torch.stack([b.diffusion_projection.bias for b in blks]).to(dt),
            torch.stack([b.dilated_conv.weight.permute(2, 1, 0) for b in blks]).to(dt)
            .contiguous(),
            torch.stack([b.dilated_conv.bias for b in blks]),
            torch.stack([b.output_projection.weight.t() for b in blks]).to(dt).contiguous(),
            torch.stack([b.output_projection.bias for b in blks]),
            {name: getattr(self, name).cast()
             for name in ("input_projection", "mlp_0", "mlp_1", "skip_projection")},
        )

    def forward(self, spec, diffusion_step, cond_proj=None, stack=None, cond=None):
        """spec [B, T, M], diffusion_step [B] int, and cond_proj [L, B, T, 2C]
        (sampling, through K1) or cond [B, T, H] (training) -> predicted
        noise [B, T, M]."""
        if cond is not None:
            return self._forward_layers(spec, diffusion_step, self.cond_projections(cond))
        wstep, bstep, wd, bd, wo, bo, proj = stack if stack is not None else self.stack_weights()
        x = F.relu(self.input_projection(spec, proj["input_projection"]))
        s = self.mlp_0(diffusion_step_embedding(diffusion_step, self.channels), proj["mlp_0"])
        s = self.mlp_1(s * torch.tanh(softplus(s)), proj["mlp_1"])  # Mish
        # each layer's diffusion_projection, batched: the product rounded,
        # then the bias added, in compute_dtype
        step_proj = torch.einsum("bc,lcd->lbd", s, wstep) + bstep[:, None, :]
        stack_fn = residual_stack_bf16 if self.dtype_ == torch.bfloat16 else residual_stack
        skip = stack_fn(x.contiguous(), cond_proj, step_proj.contiguous(), wd, bd, wo, bo,
                        self.dilations)
        y = (skip * (1.0 / math.sqrt(self.n_layers))).to(self.dtype_)
        return self.output_projection(F.relu(self.skip_projection(y, proj["skip_projection"])))

    def _forward_layers(self, spec, diffusion_step, cond_proj):
        """flax's `DiffNet.__call__` without the fused kernel
        (`diffnet.py:186-200`): the layers one by one, the skip sum in
        compute_dtype."""
        x = F.relu(self.input_projection(spec))
        s = self.mlp_0(diffusion_step_embedding(diffusion_step, self.channels))
        s = self.mlp_1(s * torch.tanh(softplus(s)))  # Mish
        skip_sum = None
        for blk, cp in zip(self.blocks(), cond_proj):
            x, skip = blk(x, cp, s)
            skip_sum = skip if skip_sum is None else skip_sum + skip
        y = div(skip_sum, math.sqrt(self.n_layers))
        return self.output_projection(F.relu(self.skip_projection(y)))


class FFTDenoiser(nn.Module):
    """The transformer-decoder denoiser (`diffnet.py:202-262`, the
    reference's `candidate_decoder.py`): in-proj 1x1 (80 -> C) and the
    step's Mish MLP (C -> 4C -> C), then decode_x(x) + decode_cond(cond) +
    decode_time(step) -> FFT blocks (`dec_layers`, the conditioner's FFN
    padding and activation, in compute_dtype) -> get_mel_out (H -> 80).
    Every projection computes in fp32, as flax's. The decoder runs without
    dropout in training too, as flax's runs it with `deterministic=True`
    (`diffnet.py:259`). The conditioner's part is step-invariant:
    `cond_projections` gives it once per utterance as [1, B, T, H]. No
    kernel: the K1 stack is the DiffNet's."""

    def __init__(self, hp: dict, in_dims: int = 80):
        super().__init__()
        dim, h = hp["residual_channels"], hp["hidden_size"]
        self.channels = dim
        self.input_projection = Linear(in_dims, dim, conv1x1=True)
        self.mlp_0 = Linear(dim, 4 * dim)
        self.mlp_1 = Linear(4 * dim, dim)
        self.decode_x = Linear(dim, h)
        self.decode_cond = Linear(h, h, bias=False)
        self.decode_time = Linear(dim, h, bias=False)
        self.decoder = FFTBlocks(h, hp["dec_layers"], hp["dec_ffn_kernel_size"], hp["num_heads"],
                                 use_pos_embed=True, dtype=compute_dtype(hp), dropout=0.0,
                                 padding=hp["ffn_padding"], act=hp["ffn_act"])
        self.get_mel_out = Linear(h, in_dims)

    def cond_projections(self, cond):
        """[B, T, H] -> [1, B, T, H]."""
        return self.decode_cond(cond)[None]

    def stack_weights(self):
        return None  # the samplers' per-loop weights: none beyond the module's

    def forward(self, spec, diffusion_step, cond_proj=None, stack=None, cond=None):
        """spec [B, T, M], diffusion_step [B] and cond_proj [1, B, T, H] (or
        cond [B, T, H]) -> predicted noise [B, T, M]."""
        if cond is not None:
            cond_proj = self.cond_projections(cond)
        x = self.input_projection(spec)
        s = self.mlp_0(diffusion_step_embedding(diffusion_step, self.channels))
        s = self.mlp_1(s * torch.tanh(softplus(s)))  # Mish
        inp = self.decode_x(x) + cond_proj[0] + self.decode_time(s)[:, None, :]
        return self.get_mel_out(self.decoder(inp))


# the denoiser classes by `diff_decoder_type` (`diffusion.py:103`)
DIFF_DECODERS = {"wavenet": DiffNet, "fft": FFTDenoiser}
