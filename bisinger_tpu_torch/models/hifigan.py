"""NSF HiFi-GAN generator, its discriminators and the GAN losses
(counterpart of `bisinger_tpu/models/hifigan.py`).

Generator (`:43-111, 187-221, 247-414`): conv_pre (k7) -> per stage:
leaky_relu(0.1) -> ConvTranspose up -> + LayerNorm(ReLU(strided
noise_conv(harmonic source))) -> MRF stage -> leaky_relu(0.01) ->
conv_post (k7) -> tanh. With `use_nsf` off (the TTS configs' plain
HiFi-GAN) the generator has no harmonic source, no noise_conv and no
noise_norm, as flax's built without an f0 (`:273-278, 320-335`), and
takes f0=None; the stage input then stays in `compute_dtype`, and so do
the MRF state and output (K2's bf16 output rounded to bf16, as the TPU
kernel returns its input's dtype). The NSF source's random phase and noise can be
handed in as tensors so that tests (and the GAN step's two passes) pin
them. With `vocoder_multiband` n > 1 the generator emits n PQMF subbands
at sample_rate / n (`models/pqmf.py` synthesises the waveform): conv_post
has n outputs, the harmonic source stays at the full rate and each
noise_conv strides n times further.

The MRF stage has two paths. In eval mode it runs K2 (`ops/mrf_stage`):
`mrf_stage_bf16` (the TPU kernel's bf16 rounding) under bfloat16,
`mrf_stage` under float32, at stage widths F = 8 to 512 (powers of two,
`ops/_build.py` K2_WIDTHS: the stages of an `upsample_initial_channel`
from 16 to 1024 over four upsamplings, such as the JAX scripts' default
128-channel vocoder, F = 64 to 8). At any other width the wrapper raises on
the card, naming the widths taken, and nothing runs the layers in the
kernel's place; JAX's `fused_mrf_stage` takes any F, and its generator
runs every width through XLA under the default backend
(`bisinger_tpu/models/hifigan.py:365-386`). In train mode it runs the ResBlock1 layers
under autograd, as flax's layers run in a train step (the kernels have no
backward): each conv in `compute_dtype`, its sums rounded there, the
residual state fp32, the mean over the blocks fp32. As
`bisinger_tpu/models/hifigan.py:263-400`, conv_pre, the upsample and
noise convs compute in `compute_dtype`, the noise LayerNorm in fp32 (so
the stage input is fp32 again); the NSF source and conv_post are fp32.

Under `seq` (the mesh as `seq=`; JAX: `hifigan.py:296-300`) mel and f0
are a rank's core frames: the generator runs on them widened by its
receptive field in mel frames (`sequence.vocoder_halo`: conv_pre, each
transposed conv, noise conv and MRF stage, conv_post; 16 frames at the
flagship) from the neighbours' cores, K2 on each stage's widened length,
and the waveform is cut to the core's samples. The chunk's bounds fall on whole frames, so the strided
noise convs stay on their grid. The NSF phase is a running sum over the
whole waveform: a rank starts its fp64 sum from the earlier ranks' core
totals, less its own left halo's share; the random initial phase reaches
sample 0 only, and the phase and noise are drawn (or pinned) at the
global shape, each rank keeping its rows and samples. A multiband
generator is not split (its PQMF synthesis spans the subbands'
samples): `vocoders/` runs it whole.
With `resblock: '2'` the stages hold `ResBlock2`s (one dilated conv a
dilation), which run as layers in both modes: K2 fuses ResBlock1 only, as
the TPU kernel does.

Discriminators (`:416-533`), fp32 as in flax: `MultiPeriodDiscriminator`
(periods 2, 3, 5, 7, 11, 2-D convs over [T / p, p]) and
`MultiScaleDiscriminator` (3 scales of grouped 1-D convs, average-pooled
between scales). flax's SAME padding with a stride pads
(ceil(T / s) - 1) * s + k - T in total, the smaller half on the left;
its average pool counts the padded zeros. Each discriminator runs the real
and the generated waveform as one batch. The feature maps are in torch's
channel-first layout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bisinger_tpu_torch.models.common import Conv, compute_dtype, layer_norm, scale
from bisinger_tpu_torch.ops.mrf_stage import mrf_stage, mrf_stage_bf16, pack_stage_weights
from bisinger_tpu_torch.parallel import groups, sequence

LRELU_SLOPE = 0.1


def phase_steps(f0_k, sample_rate: int):
    """f0 * k / sample_rate mod 1, the NSF phase's per-sample steps, as XLA
    compiles the JAX package's division by a constant: a product with the
    rate's reciprocal in f0's dtype."""
    inv_rate = torch.reciprocal(torch.tensor(float(sample_rate), dtype=f0_k.dtype))
    return torch.remainder(f0_k * inv_rate, 1.0)


def sine_gen(f0, sample_rate: int, harmonic_num: int = 8, sine_amp: float = 0.1,
             noise_std: float = 0.003, voiced_threshold: float = 0.0, phase=None, noise=None,
             generator: Optional[torch.Generator] = None, seq=None):
    """Harmonic sine bank (`hifigan.py:43-81`), its phase summed in fp64.
    f0 [B, T, 1] at the sample rate. `phase` [B, H+1] ~ U[0, 1) (column 0
    is ignored: the fundamental gets none) and `noise` [B, T, H+1] ~ N(0, 1)
    are drawn from `generator` when not given. Returns (sine_waves
    [B, T, H+1], uv [B, T, 1]).

    The NSF branch's gradients follow the sines' rounding closely (the
    noise LayerNorm of a ReLU'd source near its zero crossings divides by
    about sqrt(eps); in fp32 the merge layer's gradient lies 1.85e-3 of the
    largest from the float64 step's, PERF.md §6), so the phase is computed
    the same way on every device: its steps by `phase_steps` (PyTorch's
    CUDA division by a scalar multiplies by the reciprocal, its CPU one
    divides), their running sum in fp64, where the JAX package sums in
    fp32 and subtracts 1 at each wrap: an fp32 sum depends on its order and
    accumulator (PyTorch's CPU cumsum accumulates fp32 in fp64, its CUDA
    one in fp32); in fp64 the whole-cycle count drops out exactly.

    `seq` (mesh, first, last): f0 is a rank's window of the waveform, its
    core samples [first, last): the phase is added only where the window
    starts the waveform, and the running sum starts from the earlier
    ranks' core totals less this window's samples before its core."""
    b, t, _ = f0.shape
    dim = harmonic_num + 1
    mult = torch.arange(1, dim + 1, dtype=f0.dtype, device=f0.device)
    rad = phase_steps(f0 * mult, sample_rate)
    if phase is None:
        phase = torch.rand((b, dim), generator=generator, device=f0.device, dtype=f0.dtype)
    phase = torch.cat([torch.zeros_like(phase[:, :1]), phase[:, 1:]], dim=1)
    if seq is None or seq[0].index == 0:
        rad = torch.cat([rad[:, :1] + phase[:, None, :], rad[:, 1:]], dim=1)
    cycles = torch.cumsum(rad.double(), dim=1)
    if seq is not None:
        m, first, last = seq
        steps = rad.double()
        before = groups.exclusive_prefix(steps[:, first:last].sum(1), m) - \
            steps[:, :first].sum(1)
        cycles = cycles + before[:, None, :]
    sines = torch.sin(torch.remainder(cycles, 1.0) * (2 * np.pi)).to(f0.dtype)
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

    def forward(self, f0, phase=None, noise=None, generator=None, seq=None):
        sine_wavs, uv = sine_gen(f0, self.sample_rate, self.harmonic_num, phase=phase,
                                 noise=noise, generator=generator, seq=seq)
        return torch.tanh(self.merge(sine_wavs)), uv


def leaky_relu(x, slope: float):
    """jax.nn.leaky_relu in x's dtype: the slope is rounded to it first."""
    if x.dtype != torch.bfloat16:
        return F.leaky_relu(x, slope)
    return torch.where(x >= 0, x, scale(x, slope))


class ResBlock1(nn.Module):
    """One MRF residual block: per dilation lrelu -> dilated conv1_i ->
    lrelu -> conv2_i, added to the state (`hifigan.py:187-221`). Its convs
    compute in `dtype`, as flax's with `dtype=`; in eval mode the stage's
    blocks run together in K2 instead."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int],
                 dtype=torch.float32):
        super().__init__()
        self.dilations = list(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"conv1_{i}", Conv(channels, channels, kernel_size, dilation=d,
                                               dtype=dtype))
            self.add_module(f"conv2_{i}", Conv(channels, channels, kernel_size, dtype=dtype))

    def forward(self, x):
        for i in range(len(self.dilations)):
            y = getattr(self, f"conv1_{i}")(leaky_relu(x, LRELU_SLOPE))
            y = getattr(self, f"conv2_{i}")(leaky_relu(y, LRELU_SLOPE))
            x = x + y  # the state's dtype: fp32 after the NSF merge, else the conv's
        return x


class ResBlock2(nn.Module):
    """The lighter MRF block: per dilation lrelu -> dilated conv_i, added to
    the state (`hifigan.py:222-244`). It runs as these layers in eval mode
    too: the JAX package runs K2 for ResBlock1 stages only (`:366-367`)."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int],
                 dtype=torch.float32):
        super().__init__()
        self.dilations = list(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"conv_{i}", Conv(channels, channels, kernel_size, dilation=d,
                                              dtype=dtype))

    def forward(self, x):
        for i in range(len(self.dilations)):
            x = x + getattr(self, f"conv_{i}")(leaky_relu(x, LRELU_SLOPE))
        return x


class HifiGanGenerator(nn.Module):
    """mel [B, T, 80], f0 [B, T] (None without `use_nsf`) -> waveform
    [B, T * hop], or n subbands [B, T * hop / n, n] with `vocoder_multiband`
    n > 1. `tp` is the ('data', 'model') mesh of a tensor-parallel view
    (`parallel/tensor.shard_for_tp`, its ResBlock1s a model rank's share):
    its MRF stages run their layers in eval too, with no K2."""

    tp = None

    def __init__(self, hp: dict, n_mels: int = 80):
        super().__init__()
        self.hp = hp
        self.resblock1 = str(hp.get("resblock", "1")) == "1"
        block = ResBlock1 if self.resblock1 else ResBlock2
        self.rates = list(hp["upsample_rates"])
        self.rk = list(hp["resblock_kernel_sizes"])
        self.rd = [list(d) for d in hp["resblock_dilation_sizes"]]
        self.multiband = n = int(hp.get("vocoder_multiband", 1) or 1)
        c0 = hp["upsample_initial_channel"]
        self.dtype_ = dt = compute_dtype(hp)
        self.conv_pre = Conv(n_mels, c0, 7, dtype=dt)
        self.use_nsf = bool(hp.get("use_nsf", True))
        if self.use_nsf:
            self.m_source = SourceModuleHnNSF(hp["audio_sample_rate"], harmonic_num=8)
        c_prev = c0
        for i, (u, k) in enumerate(zip(self.rates, hp["upsample_kernel_sizes"])):
            c = c0 // (2 ** (i + 1))
            self.add_module(f"up_{i}", nn.ConvTranspose1d(c_prev, c, k, u, padding=(k - u) // 2))
            if self.use_nsf:
                # the harmonic source is at the full rate: stride it to this stage's
                s = int(np.prod(self.rates[i + 1:])) * n
                self.add_module(f"noise_conv_{i}",
                                Conv(1, c, 2 * s, stride=s, padding=s // 2, dtype=dt) if s > 1
                                else Conv(1, c, 1, dtype=dt))
                self.add_module(f"noise_norm_{i}", nn.LayerNorm(c, eps=1e-6))
            for j, (kj, dj) in enumerate(zip(self.rk, self.rd)):
                self.add_module(f"res_{i}_{j}", block(c, kj, dj, dtype=dt))
            c_prev = c
        self.conv_post = Conv(c_prev, n, 7)

    def stage_weights(self, i: int):
        """(w in compute_dtype, b fp32) of stage i, packed for K2."""
        blocks = [getattr(self, f"res_{i}_{j}") for j in range(len(self.rk))]
        return pack_stage_weights(blocks, self.rk, self.rd, self.dtype_)

    def upsample(self, i: int, x):
        """ConvTranspose1d of stage i in compute_dtype (`ops/subpixel.py:127-145`)."""
        up = getattr(self, f"up_{i}")
        dt = self.dtype_ if self.dtype_ == torch.bfloat16 else up.weight.dtype
        y = F.conv_transpose1d(x.transpose(1, 2).to(dt), up.weight.to(dt), None, up.stride,
                               up.padding)
        return (y + up.bias.to(dt)[:, None]).transpose(1, 2)

    def mrf(self, i: int, x):
        """MRF stage i: K2 in eval mode, the blocks' layers in train mode, for
        ResBlock2 stages and under tensor parallelism."""
        if self.training or not self.resblock1 or self.tp is not None:
            blocks = [getattr(self, f"res_{i}_{j}") for j in range(len(self.rk))]
            out = blocks[0](x)
            for blk in blocks[1:]:
                out = out + blk(x)
            return out / len(blocks)
        stage = mrf_stage_bf16 if self.dtype_ == torch.bfloat16 else mrf_stage
        w, b = self.stage_weights(i)
        # the kernels take and give fp32; a bf16 stage input is exact in fp32
        x_in = x.to(torch.promote_types(x.dtype, torch.float32)).contiguous()
        return stage(x_in, w, b, self.rk, self.rd).to(x.dtype)

    def forward(self, mel, f0=None, phase=None, noise=None, generator=None, seq=None):
        if (f0 is not None) != self.use_nsf:
            raise ValueError(f"use_nsf is {self.use_nsf}: the generator takes "
                             f"{'an' if self.use_nsf else 'no'} f0")
        if seq is not None:
            return self._forward_seq(mel, f0, phase, noise, generator, seq)
        har = None
        if self.use_nsf:
            hop = int(np.prod(self.rates)) * self.multiband
            f0_up = torch.repeat_interleave(f0, hop, dim=1)[:, :, None]
            har, _ = self.m_source(f0_up, phase, noise, generator)
        return self._generate(mel, har)

    def _forward_seq(self, mel, f0, phase, noise, generator, m):
        """mel [B, c, 80] and f0 [B, c], this rank's core frames -> the core's
        waveform [B, c * hop]; phase [B x data, H+1] and noise [B x data,
        T * hop, H+1] at the global shape, drawn from `generator` unless
        given."""
        if self.multiband > 1:
            raise NotImplementedError("a multiband generator runs whole under seq "
                                      "(vocoders/hifigan.HifiGAN.generate gathers it)")
        hop = int(np.prod(self.rates))
        for u, k in zip(self.rates, (getattr(self, f"up_{i}").kernel_size[0]
                                     for i in range(len(self.rates)))):
            if (k - u) % 2:
                raise NotImplementedError(f"an upsample of kernel {k} at stride {u} does not "
                                          "keep whole frames: the generator runs whole")
        b, c = mel.shape[:2]
        win = sequence.window(c * m.size, m, sequence.vocoder_halo(self.hp))
        mel_w = sequence.halo_exchange(mel, m, win.halo)
        har = None
        if self.use_nsf:
            dim = self.m_source.harmonic_num + 1
            rows = b * m.shape["data"]
            dev, dt = f0.device, f0.dtype
            if phase is None:
                phase = torch.rand((rows, dim), generator=generator, device=dev, dtype=dt)
            if noise is None:
                noise = torch.randn((rows, win.n_frames * hop, dim), generator=generator,
                                    device=dev, dtype=dt)
            phase = sequence.local_window(phase, m, None)
            noise = sequence.local_window(noise, m, win, scale=hop)
            f0_up = torch.repeat_interleave(sequence.halo_exchange(f0, m, win.halo), hop,
                                            dim=1)[:, :, None]
            har, _ = self.m_source(f0_up, phase, noise, generator,
                                   seq=(m, win.left * hop, (win.left + c) * hop))
        return self._generate(mel_w, har).narrow(1, win.left * hop, c * hop)

    def _generate(self, mel, har):
        """The generator from conv_pre on, with the NSF source `har` (or None)."""
        x = self.conv_pre(mel)
        for i in range(len(self.rates)):
            x = self.upsample(i, leaky_relu(x, LRELU_SLOPE))
            if har is not None:
                xs = F.relu(getattr(self, f"noise_conv_{i}")(har))
                xs = layer_norm(getattr(self, f"noise_norm_{i}"), xs)
                x = x + xs[:, :x.shape[1]]  # fp32: the norm's output promotes x
            x = self.mrf(i, x)
        x = leaky_relu(x, 0.01)  # the reference's final activation
        x = torch.tanh(self.conv_post(x))
        return x[..., 0] if self.multiband == 1 else x


# --------------------------------------------------------------------------
# Discriminators and GAN losses (`hifigan.py:416-533`)
# --------------------------------------------------------------------------
def same_pad(x, k: int, s: int):
    """flax's SAME padding of x [..., T] for a window k at stride s: (ceil(T /
    s) - 1) * s + k - T zeros in total, the smaller half on the left."""
    t = x.shape[-1]
    total = max((-(-t // s) - 1) * s + k - t, 0)
    return F.pad(x, (total // 2, total - total // 2))


class DiscriminatorP(nn.Module):
    """Period discriminator: x [B, T] reflect-padded to a multiple of the
    period, folded to [B, 1, T / p, p], (5, 1) convs at stride (3, 1)."""

    CHANNELS = (32, 128, 512, 1024)

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        cin = 1
        for i, c in enumerate(self.CHANNELS):
            self.add_module(f"conv_{i}", nn.Conv2d(cin, c, (kernel_size, 1), (stride, 1),
                                                   padding=(2, 0)))
            cin = c
        self.conv_4 = nn.Conv2d(cin, 1024, (kernel_size, 1), 1, padding=(2, 0))
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), 1, padding=(1, 0))

    def forward(self, x):
        b, t = x.shape
        n_pad = (self.period - t % self.period) % self.period
        if n_pad:
            x = F.pad(x[:, None], (0, n_pad), mode="reflect")[:, 0]
        x = x.reshape(b, 1, -1, self.period)
        fmap = []
        for i in range(len(self.CHANNELS) + 1):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped 1-D convs with flax's SAME padding."""

    SPECS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16),
             (1024, 41, 4, 16), (1024, 41, 1, 16), (1024, 5, 1, 1))  # (out, k, stride, groups)

    def __init__(self):
        super().__init__()
        cin = 1
        for i, (c, k, s, g) in enumerate(self.SPECS):
            self.add_module(f"conv_{i}", nn.Conv1d(cin, c, k, s, groups=g))
            cin = c
        self.conv_post = nn.Conv1d(cin, 1, 3)

    def forward(self, x):
        x = x[:, None]
        fmap = []
        for i, (_, k, s, _) in enumerate(self.SPECS):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(same_pad(x, k, s)), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(same_pad(x, 3, 1))
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


def _real_and_fake(disc, y, y_hat):
    """One pass of `disc` over real and generated as a batch, split back:
    (out_r, out_g, fmap_r, fmap_g)."""
    out, fmap = disc(torch.cat([y, y_hat]))
    b = y.shape[0]
    return out[:b], out[b:], [f[:b] for f in fmap], [f[b:] for f in fmap]


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.periods = list(periods)
        for p in self.periods:
            self.add_module(f"disc_{p}", DiscriminatorP(p))

    def forward(self, y, y_hat):
        """-> (outs_r, outs_g, fmaps_r, fmaps_g), a list entry a period."""
        res = [_real_and_fake(getattr(self, f"disc_{p}"), y, y_hat) for p in self.periods]
        return tuple(list(r) for r in zip(*res))


def avg_pool_same(x, window: int = 4, stride: int = 2):
    """flax's `avg_pool(x, (4,), (2,), "SAME")` over x [B, T]: the padded
    zeros count in the mean."""
    return F.avg_pool1d(same_pad(x[:, None], window, stride), window, stride)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, num_scales: int = 3):
        super().__init__()
        self.num_scales = num_scales
        for i in range(num_scales):
            self.add_module(f"disc_{i}", DiscriminatorS())

    def forward(self, y, y_hat):
        res = []
        for i in range(self.num_scales):
            if i > 0:
                y, y_hat = avg_pool_same(y), avg_pool_same(y_hat)
            res.append(_real_and_fake(getattr(self, f"disc_{i}"), y, y_hat))
        return tuple(list(r) for r in zip(*res))


def feature_loss(fmap_r, fmap_g):
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2.0


def discriminator_loss(disc_real, disc_gen):
    r_losses = sum(torch.mean((1 - dr) ** 2) for dr in disc_real) / len(disc_real)
    g_losses = sum(torch.mean(dg ** 2) for dg in disc_gen) / len(disc_gen)
    return r_losses, g_losses


def generator_loss(disc_outputs):
    return sum(torch.mean((1 - dg) ** 2) for dg in disc_outputs) / len(disc_outputs)
