"""Duration predictor and the PitchExtractor's conv stacks, [B, T, C].

Counterpart of `bisinger_tpu/models/predictors.py:20-308` (ConvReluLN,
DurationPredictor with its three heads, the CRF's Viterbi decode and
log-likelihood, the mixture head's expectation and NLL, PitchPredictor,
EnergyPredictor, Prenet, ConvStacks). The duration predictor's layers end in
dropout (`predictor_dropout`), which runs only when a caller passes
`deterministic=False`: FastSpeech2 calls its predictors without that argument
(`bisinger_tpu/models/fs2.py:203,211`), so flax runs them deterministically in
training too, and so does the port. The PitchExtractor's modules take
`deterministic` as flax's do: its pitch predictor's dropout and its Prenet's
batch statistics run in training. The convs (and ConvStacks' input projection)
run in `dtype`; the norms compute in fp32 and return fp32, and the output heads
are fp32, as in the JAX package.
"""

from __future__ import annotations

import math

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
    """Conv -> ReLU -> LayerNorm(eps 1e-12) -> dropout (`predictors.py:20-48`);
    the conv SAME, or with `padding` "LEFT" k - 1 zeros before the frames and
    VALID (causal)."""

    def __init__(self, cin: int, channels: int, kernel_size: int, dtype=torch.float32,
                 dropout: float = 0.0, padding: str = "SAME"):
        super().__init__()
        if padding not in ("SAME", "LEFT"):
            raise ValueError(f"conv padding {padding!r}: the predictors have SAME or LEFT")
        self.left = kernel_size - 1 if padding == "LEFT" else 0
        self.Conv_0 = Conv(cin, channels, kernel_size, dtype=dtype,
                           padding=0 if self.left else None)
        self.LayerNorm_0 = nn.LayerNorm(channels, eps=1e-12)
        self.dropout = Dropout(dropout)

    def forward(self, x, deterministic: bool = True):
        if self.left:
            x = F.pad(x, (0, 0, self.left, 0))
        x = layer_norm(self.LayerNorm_0, F.relu(self.Conv_0(x)))
        return x if deterministic else self.dropout(x)


# the head's width by `dur_loss` (`bisinger_tpu/models/fs2.py:83-87`): log
# durations, 5 Gaussians x (weight logit, mean, log sigma), 32 CRF states
DUR_ODIMS = {"mse": 1, "huber": 1, "mog": 15, "crf": 32}


class DurationPredictor(nn.Module):
    """Conv stack -> linear (`predictors.py:51-115`): [B, T] log durations
    (odims 1), or [B, T, odims] for the mixture (15) and CRF (32) heads; the
    CRF head has a learned transition matrix, zero at the start."""

    offset = 1.0

    def __init__(self, cin: int, n_layers: int = 2, n_chans: int = 384, kernel_size: int = 3,
                 dtype=torch.float32, dropout: float = 0.0, padding: str = "SAME",
                 odims: int = 1):
        super().__init__()
        self.n_layers, self.odims = n_layers, odims
        for i in range(n_layers):
            self.add_module(f"conv_{i}", ConvReluLN(cin if i == 0 else n_chans, n_chans,
                                                    kernel_size, dtype, dropout, padding))
        self.linear = nn.Linear(n_chans, odims)
        if odims == 32:
            self.crf_transitions = nn.Parameter(torch.zeros(odims, odims))

    def forward(self, x, x_padding=None, deterministic: bool = True):
        keep = None if x_padding is None else (1.0 - x_padding.to(x.dtype))[:, :, None]
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x, deterministic)
            if keep is not None:
                x = x * keep
        x = self.linear(x)
        if keep is not None:
            x = x * keep
        return x[:, :, 0] if self.odims == 1 else x

    def out2dur(self, xs, padding=None):
        """The head's output -> integer frame counts (`predictors.py:91-113`):
        round(exp(log duration) - 1), at least 0, the log duration the mixture's
        expectation for the mixture head; the CRF head's Viterbi path (its
        states are frame counts), with `padding` [B, T] (true on padding)
        frozen out of the decode."""
        if self.odims == 32:
            mask = None if padding is None else 1.0 - padding.float()
            return crf_viterbi(xs, self.crf_transitions, mask)
        if self.odims == 15:
            xs = mog_expected_log_dur(xs)
        return torch.clamp(torch.round(torch.exp(xs) - self.offset), min=0.0).long()


def crf_viterbi(emissions, transitions, mask=None):
    """The best-scoring state path of a linear-chain CRF
    (`predictors.py:116-150`): emissions [B, T, S] -> [B, T] int64. With
    `mask` [B, T] (1 on the valid steps, the padding trailing) the scores
    and the backpointers stay frozen past each row's last valid step (the
    backpointer the identity there), so the path does not depend on the
    padding; ties go to the lowest state, as jnp.argmax breaks them."""
    b, t, s = emissions.shape
    if mask is None:
        mask = torch.ones((b, t), device=emissions.device)
    keep = mask.float() > 0
    ident = torch.arange(s, device=emissions.device).expand(b, s)
    alpha, backptrs = emissions[:, 0], []
    for i in range(1, t):
        scores = alpha[:, :, None] + transitions[None]  # [B, S_prev, S]
        best, best_prev = scores.max(dim=1)
        k = keep[:, i, None]
        alpha = torch.where(k, best + emissions[:, i], alpha)
        backptrs.append(torch.where(k, best_prev, ident))
    state = alpha.argmax(dim=-1)
    path = [state]
    for bp in reversed(backptrs):
        state = bp.gather(1, state[:, None])[:, 0]
        path.append(state)
    return torch.stack(path[::-1], dim=1)


def crf_log_likelihood(emissions, transitions, tags, mask=None):
    """log p(tags | emissions) of a linear-chain CRF, the path's score less
    log Z by the forward algorithm (`predictors.py:153-186`): emissions
    [B, T, S], tags [B, T] -> [B]; `mask` [B, T] with trailing padding."""
    b, t, s = emissions.shape
    mask = torch.ones((b, t), device=emissions.device) if mask is None else mask.float()
    tags = tags.long()
    em_score = (emissions.gather(-1, tags[..., None])[..., 0] * mask).sum(-1)
    tr_score = (transitions[tags[:, :-1], tags[:, 1:]] * mask[:, 1:]).sum(-1)
    alpha = emissions[:, 0]
    for i in range(1, t):
        new = torch.logsumexp(alpha[:, :, None] + transitions[None], dim=1) + emissions[:, i]
        alpha = torch.where(mask[:, i, None] > 0, new, alpha)
    return em_score + tr_score - torch.logsumexp(alpha, dim=-1)


def mog_expected_log_dur(xs):
    """The mixture's expected log duration, sum softmax(w) * mu over the 5
    components (`predictors.py:189-194`): xs [B, T, 15] -> [B, T]."""
    w, mu, _ = xs.chunk(3, dim=-1)
    return (torch.softmax(w, dim=-1) * mu).sum(-1)


def mog_log_nll(xs, dur_gt, offset: float = 1.0):
    """Per-token NLL of log(dur + offset) under the mixture head
    (`predictors.py:197-211`, log sigma clipped to [-7, 7]): [B, T]."""
    w, mu, log_sigma = xs.chunk(3, dim=-1)
    log_sigma = log_sigma.clamp(-7.0, 7.0)
    target = torch.log(dur_gt + offset)[..., None]
    log_prob = (-0.5 * ((target - mu) / torch.exp(log_sigma)) ** 2 - log_sigma
                - 0.5 * math.log(2 * math.pi))
    return -torch.logsumexp(torch.log_softmax(w, dim=-1) + log_prob, dim=-1)


def mog_dur_nll(xs, dur_gt, offset: float = 1.0, mask=None):
    """The mixture head's NLL: its mean over the tokens of `mask` (at least 1),
    else over every token (`predictors.py:197-211`). Under data parallelism
    the losses take `mog_log_nll` and the global count."""
    nll = mog_log_nll(xs, dur_gt, offset)
    if mask is None:
        return nll.mean()
    m = mask.to(nll.dtype)
    return (nll * m).sum() / torch.clamp_min(m.sum(), 1.0)


class PitchPredictor(nn.Module):
    """Sinusoidal positions + conv stack -> linear (`predictors.py:213-237`);
    each layer's dropout runs when `deterministic` is False."""

    def __init__(self, cin: int, n_layers: int = 5, n_chans: int = 384, odim: int = 2,
                 kernel_size: int = 5, dtype=torch.float32, dropout: float = 0.0,
                 padding: str = "SAME"):
        super().__init__()
        self.n_layers = n_layers
        self.pos_embed_alpha = nn.Parameter(torch.ones(1))
        for i in range(n_layers):
            self.add_module(f"conv_{i}", ConvReluLN(cin if i == 0 else n_chans, n_chans,
                                                    kernel_size, dtype, dropout, padding))
        self.linear = nn.Linear(n_chans, odim)

    def forward(self, x, deterministic: bool = True, seq=None):
        """`seq` (mesh, window): x is a rank's window of the frames
        (`models/pe.py`); the positions count on from the earlier ranks'."""
        nonpad = (x.abs().sum(-1) != 0).long()
        x = x + self.pos_embed_alpha * sinusoidal_positions(nonpad, x.shape[-1], seq=seq)
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

    def forward(self, x, seq=None):
        """`seq` (mesh, window): x is a rank's window of the frames; the
        GroupNorm takes the whole sequence's statistics."""
        x = self.in_proj(x)
        for i in range(self.n_layers):
            y = getattr(self, f"conv_{i}")(x)
            y = group_norm(getattr(self, f"norm_{i}"), y, seq)
            x = x + F.relu(y)  # fp32 from here: the norm's output promotes x
        return self.out_proj(x.to(self.out_proj.weight.dtype))
