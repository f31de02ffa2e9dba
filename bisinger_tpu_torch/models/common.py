"""Shared NN primitives in [B, T, C] layout.

Counterpart of `bisinger_tpu/models/common.py:24-345`. Submodules carry
the flax names so that `weights.load_flax_params` maps a flat key onto a
state_dict entry by path. Dropout sits where flax has `nn.Dropout`; it is
the identity in eval mode (flax's `deterministic=True`) and in train mode
draws its masks from the generator `set_dropout_generator` hands it.

Mixed precision follows the JAX package's contract
(`bisinger_tpu/models/common.py:24-33`): `compute_dtype` (bf16 by
default) is the type of the activations inside the heavy stacks; params,
module outputs and the softmax and normalisation statistics stay fp32.
`Linear` and `Conv` compute as flax's `nn.Dense` / `nn.Conv` with a
`dtype`: input, kernel and bias cast to it, the product (fp32 sums)
rounded, then the bias added in it. Without a dtype they compute in fp32,
as flax promotes a bf16 input against fp32 params. In bf16, the
activations that JAX builds from several ops (GELU, softplus) run one
op at a time, each result rounded, as XLA runs them; the norms
(`layer_norm`, `group_norm`, `batch_norm`) compute flax's formula in fp32,
so that a bf16 cast after them rounds the values JAX rounds; BatchNorm
also in training, with flax's batch statistics. "fp32" is the parameters'
dtype: a model cast to float64 computes those parts in fp64, the
reference that `tools/step_parity` holds an fp32 train step against.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from bisinger_tpu_torch.parallel import groups
from bisinger_tpu_torch.parallel import mesh as dp


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(hp) -> torch.dtype:
    """The activation dtype of `hp["compute_dtype"]`, which `config.py`
    has checked (`bisinger_tpu/models/common.py:24`)."""
    return DTYPES[hp["compute_dtype"]]


def scale(x, s: float):
    """x * s as JAX multiplies an array by a Python scalar: s is first
    rounded to x's dtype."""
    if x.dtype != torch.bfloat16:
        return x * s
    return x * bf16_const(s)


def bf16_const(v: float) -> float:
    """v rounded to bf16, as JAX rounds a weakly typed scalar against a bf16
    array; a bf16 tensor times this float is one product rounded once."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


_GELU_C1 = bf16_const(math.sqrt(2.0 / math.pi))
_GELU_C3 = bf16_const(0.044715)


def div(x, s: float):
    """x / s as JAX divides an array by a Python scalar: s is first rounded
    to x's dtype."""
    return x / (s if x.dtype != torch.bfloat16 else bf16_const(s))


def grad_scale(x, s: float):
    """x in value, with s times its gradient (`bisinger_tpu/models/fs2.py:45-49`)."""
    sg = x.detach()
    return sg + s * (x - sg)


class Dropout(nn.Module):
    """flax's `nn.Dropout(rate)`: in train mode each value is kept with
    probability 1 - rate and divided by it, else zeroed; the mask is drawn
    from `self.generator` (a `torch.Generator` on the input's device, set by
    `set_dropout_generator`), at the global batch's shape under data
    parallelism, of which this rank keeps its rows, so that a step does not
    depend on the number of ranks. The identity in eval mode or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = dp.draw_rows(lambda s: torch.rand(s, generator=self.generator,
                                                 device=x.device), x.shape) < keep
        return torch.where(mask, div(x, keep), torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(module: nn.Module, generator) -> None:
    """Hand every Dropout under `module` the generator its masks come from."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def checkpointed(layer: nn.Module, *args):
    """`layer(*args)` under `torch.utils.checkpoint` (JAX's `nn.remat`): the
    layer's activations are not kept for the backward pass but recomputed
    there. checkpoint's `preserve_rng_state` restores the global generators
    only, and the layer's Dropouts draw from their own (`set_dropout_generator`),
    so each of those is rewound for the recompute to the state it had when
    the forward pass drew, and set back after it: the recompute draws the
    forward's masks, and the draws after the step are the ones without remat."""
    gens = list({id(m.generator): m.generator for m in layer.modules()
                 if isinstance(m, Dropout) and m.generator is not None}.values())
    drawn = []

    def run(*a):
        if not drawn:  # the forward pass
            drawn.append([g.get_state() for g in gens])
            return layer(*a)
        now = [g.get_state() for g in gens]  # the recompute, in the backward pass
        for g, st in zip(gens, drawn[0]):
            g.set_state(st)
        try:
            return layer(*a)
        finally:
            for g, st in zip(gens, now):
                g.set_state(st)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


def gelu_tanh(x):
    """jax.nn.gelu (tanh form) in x's dtype, one op at a time as XLA runs
    it: 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))) * x, every
    intermediate rounded."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    inner = (x + (x * x * x) * _GELU_C3) * _GELU_C1
    return x * ((torch.tanh(inner) + 1.0) * 0.5)


def softplus(x):
    """jax.nn.softplus, max(x, 0) + log1p(exp(-|x|)), op by op in x's dtype."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def silu(x):
    """jax.nn.silu, x * sigmoid(x): in bf16 the sigmoid rounded, then the
    product, as XLA runs the two ops."""
    return x * torch.sigmoid(x)


def relu(x):
    """F.relu, looked up at each call (tools/step_parity pins its kinks by
    patching F.relu)."""
    return F.relu(x)


# the FFN activations of `ffn_act` (`bisinger_tpu/models/common.py:180-185`)
ACTIVATIONS = {"gelu": gelu_tanh, "relu": relu, "swish": silu}


def layer_norm(ln: nn.LayerNorm, x):
    """flax's LayerNorm of x over the last axis, in fp32 whatever x's dtype:
    fast variance E[x^2] - E[x]^2 and (x - mean) * (rsqrt(var + eps) *
    scale) + bias, the order of `flax.linen.normalization`."""
    x = x.to(ln.weight.dtype)
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean, 0.0)
    return (x - mean) * (torch.rsqrt(var + ln.eps) * ln.weight) + ln.bias


def group_norm(gn: nn.GroupNorm, x, seq=None):
    """flax's GroupNorm of x [B, T, C] (statistics over T and each group's
    channels), in fp32, as `layer_norm`. Under `seq` (mesh, window) x is a
    rank's window of the frames: the sums of x and x^2 over its core are
    summed over the `seq` ranks, so every rank takes the whole sequence's
    statistics."""
    b, t, c = x.shape
    g = gn.num_groups
    xg = x.to(gn.weight.dtype).reshape(b, t, g, c // g)
    if seq is None:
        mean = xg.mean((1, 3), keepdim=True)
        sq = (xg * xg).mean((1, 3), keepdim=True)
    else:
        m, win = seq
        core = win.core(xg)
        sums = dp.all_reduce_sum(torch.stack([core.sum((1, 3), keepdim=True),
                                              (core * core).sum((1, 3), keepdim=True)]),
                                 group=m.group)
        mean, sq = sums / (win.n_frames * (c // g))
    var = torch.clamp_min(sq - mean * mean, 0.0)
    mul = torch.rsqrt(var + gn.eps) * gn.weight.reshape(g, c // g)
    return ((xg - mean) * mul).reshape(b, t, c) + gn.bias


BN_MOMENTUM = 0.9  # flax's convention for torch's momentum 0.1 (`predictors.py:270-278`)


def batch_norm(bn: nn.BatchNorm1d, x, use_running_average: bool = True):
    """flax's BatchNorm of x [B, T, C], in fp32: (x - mean) * (rsqrt(var +
    eps) * scale) + bias. With the running statistics, or, in training
    (`use_running_average=False`), with the batch's over every B x T frame
    in fp32: the mean and the biased variance E[x^2] - E[x]^2 (clamped at
    0), which also update the running ones as running = 0.9 * running +
    0.1 * batch (torch's BatchNorm1d would store the unbiased variance).
    Under data parallelism the batch is the global one, as under JAX's
    SPMD: the sums of x and x^2 are summed over the ranks (differentiably)
    before the division, so every rank normalises with, and stores, the
    same statistics."""
    x = x.to(bn.weight.dtype)
    if use_running_average:
        mean, var = bn.running_mean, bn.running_var
    else:
        n = x.shape[0] * x.shape[1] * dp.data_size()
        sums = dp.all_reduce_sum(torch.stack([x.sum((0, 1)), (x * x).sum((0, 1))]))
        mean = sums[0] / n
        var = torch.clamp_min(sums[1] / n - mean * mean, 0.0)
        with torch.no_grad():
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1 - BN_MOMENTUM) * var)
    return (x - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias


class Linear(nn.Linear):
    """nn.Linear computing in `dtype` (None: fp32), as flax's nn.Dense.
    `conv1x1` marks one that holds a flax 1x1 nn.Conv (kernel (1, in, out)),
    for `weights.export_flax_params`."""

    def __init__(self, cin: int, cout: int, bias: bool = True, dtype=None,
                 conv1x1: bool = False):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = dtype
        self.conv1x1 = conv1x1

    def cast(self):
        """(weight, bias) in the compute dtype, for a caller that reuses them
        over many calls (`forward(x, params)`)."""
        dt = self.compute_dtype or torch.float32
        return self.weight.to(dt), None if self.bias is None else self.bias.to(dt)

    def forward(self, x, params=None):
        dt = self.compute_dtype or torch.float32
        if dt == torch.float32:  # the parameters' dtype: fp64 in a float64 reference run
            return F.linear(x.to(self.weight.dtype), self.weight, self.bias)
        w, b = params if params is not None else self.cast()
        y = F.linear(x.to(dt), w)
        return y if b is None else y + b


class Conv(nn.Conv1d):
    """Conv1d over [B, T, C] computing in `dtype` (None: fp32), as flax's
    nn.Conv. `padding=None` is flax's SAME for odd kernels:
    dilation * (k - 1) / 2 zeros on each side."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1,
                 stride: int = 1, padding: Optional[int] = None, dtype=None):
        if padding is None:
            padding = dilation * (k - 1) // 2
        super().__init__(cin, cout, k, stride=stride, padding=padding, dilation=dilation)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or torch.float32
        x = x.transpose(1, 2)
        if dt == torch.float32:  # the parameters' dtype: fp64 in a float64 reference run
            return super().forward(x.to(self.weight.dtype)).transpose(1, 2)
        y = F.conv1d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding,
                     self.dilation)
        return (y + self.bias.to(dt)[:, None]).transpose(1, 2)


class Embedding(nn.Module):
    """nn.Embedding under `embed`; the padding_idx row reads as zero
    (reference `common.py:36-54`)."""

    def __init__(self, num_embeddings: int, features: int, padding_idx: Optional[int] = None):
        super().__init__()
        self.embed = nn.Embedding(num_embeddings, features)
        self.padding_idx = padding_idx

    def forward(self, ids):
        emb = self.embed(ids)
        if self.padding_idx is not None:
            emb = torch.where((ids != self.padding_idx)[..., None], emb, torch.zeros_like(emb))
        return emb


def sinusoidal_table(num_positions: int, dim: int, padding_idx: Optional[int] = 0) -> np.ndarray:
    """[sin | cos] table, row `padding_idx` zeroed (`common.py:57-70`)."""
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64) * -(math.log(10000) / (half - 1)))
    pos = np.arange(num_positions, dtype=np.float64)[:, None] * freq[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((num_positions, 1))], axis=1)
    if padding_idx is not None:
        table[padding_idx, :] = 0
    return table.astype(np.float32)


def sinusoidal_positions(nonpad_mask, dim: int, padding_idx: int = 0, seq=None):
    """[B, T] nonpadding mask -> [B, T, dim] position embeddings. Under
    `seq` (mesh, window) the mask is a rank's window of the frames: the
    count starts from the earlier ranks' nonpadding core frames, less this
    window's left halo."""
    t = nonpad_mask.shape[1]
    mask = nonpad_mask.long()
    positions = torch.cumsum(mask, dim=1)
    if seq is not None:
        m, win = seq
        t = win.n_frames
        before = groups.exclusive_prefix(win.core(mask).sum(1), m) - mask[:, :win.left].sum(1)
        positions = positions + before[:, None]
    table = torch.from_numpy(sinusoidal_table(t + padding_idx + 1, dim, padding_idx)).to(
        nonpad_mask.device)
    return table[positions * mask + padding_idx]


@functools.lru_cache(maxsize=16)
def rel_positional_encoding(t: int, dim: int, max_len: int = 5000) -> torch.Tensor:
    """ESPnet's legacy RelPositionalEncoding table [1, t, dim]
    (`common.py:84-95`): interleaved sin/cos over the reversed positions
    max_len - 1 .. 0, built in float64 and rounded to fp32; on the CPU, built
    once a shape, as JAX builds it once a trace, not at every step."""
    max_len = max(max_len, t)
    position = np.arange(max_len - 1, -1, -1.0, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float64) * -(math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.from_numpy(pe[None, :t].astype(np.float32))


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections in `dtype`, q scaled by head_dim^-0.5, key
    padding mask filled with fp32's minimum (`common.py:110-154`): logits
    and softmax fp32, the weights cast back to `dtype`."""

    def __init__(self, d: int, num_heads: int, bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.dtype_ = num_heads, dtype
        self.q_proj = Linear(d, d, bias=bias, dtype=dtype)
        self.k_proj = Linear(d, d, bias=bias, dtype=dtype)
        self.v_proj = Linear(d, d, bias=bias, dtype=dtype)
        self.out_proj = Linear(d, d, bias=bias, dtype=dtype)

    def forward(self, query, key, value, key_padding_mask=None):
        b, tq, d = query.shape
        h = self.num_heads
        hd = d // h
        q = scale(self.q_proj(query), hd ** -0.5)

        def split(x):
            return x.reshape(x.shape[0], x.shape[1], h, hd).transpose(1, 2)

        q, k, v = split(q), split(self.k_proj(key)), split(self.v_proj(value))
        logits = q.float() @ k.float().transpose(-1, -2)  # fp32 sums, fp32 logits
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                        torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1).to(self.dtype_)
        out = (weights.float() @ v.float()).to(self.dtype_)
        return self.out_proj(out.transpose(1, 2).reshape(b, tq, d))


class TransformerFFN(nn.Module):
    """Conv(k) -> * k^-0.5 -> act -> Dense (`common.py:157-194`). `padding`
    "SAME" (the flagship's) or "LEFT": k - 1 zeros before the frames, then a
    VALID conv (causal); `act` "gelu" (tanh form), "relu" or "swish"."""

    def __init__(self, hidden: int, filter_size: int, kernel_size: int = 9,
                 dtype=torch.float32, dropout: float = 0.0, padding: str = "SAME",
                 act: str = "gelu"):
        super().__init__()
        if padding not in ("SAME", "LEFT") or act not in ACTIVATIONS:
            raise ValueError(f"ffn padding {padding!r} / act {act!r}: the FFN has SAME or LEFT, "
                             f"{', '.join(ACTIVATIONS)}")
        self.kernel_size, self.left, self.act = kernel_size, padding == "LEFT", ACTIVATIONS[act]
        self.Conv_0 = Conv(hidden, filter_size, kernel_size, dtype=dtype,
                           padding=0 if self.left else None)
        self.dropout = Dropout(dropout)
        self.Dense_0 = Linear(filter_size, hidden, dtype=dtype)

    def forward(self, x):
        if self.left:
            x = F.pad(x, (0, 0, self.kernel_size - 1, 0))
        x = scale(self.Conv_0(x), self.kernel_size ** -0.5)
        return self.Dense_0(self.dropout(self.act(x)))


class EncSALayer(nn.Module):
    """Pre-norm self-attention + conv-FFN, residuals re-masked
    (`common.py:197-243`). x comes and goes in `dtype`; the LayerNorms
    compute in fp32."""

    def __init__(self, hidden: int, num_heads: int, kernel_size: int = 9, dtype=torch.float32,
                 dropout: float = 0.0, padding: str = "SAME", act: str = "gelu"):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.self_attn = MultiHeadAttention(hidden, num_heads, bias=False, dtype=dtype)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=1e-5)
        self.ffn = TransformerFFN(hidden, 4 * hidden, kernel_size, dtype=dtype, dropout=dropout,
                                  padding=padding, act=act)
        self.attn_dropout = Dropout(dropout)
        self.ffn_dropout = Dropout(dropout)

    def forward(self, x, padding_mask):
        nonpad = 1.0 - padding_mask.to(x.dtype)[:, :, None]
        y = layer_norm(self.layer_norm1, x)
        y = self.attn_dropout(self.self_attn(y, y, y, key_padding_mask=padding_mask))
        x = (x + y) * nonpad
        x = (x + self.ffn_dropout(self.ffn(layer_norm(self.layer_norm2, x)))) * nonpad
        return x


class ESM(nn.Module):
    """Embedding Skip Module (`common.py:246-301`):
    Mo = MHA(q=Eo, k=v=LN1(LP)) + LP; Fo = FFN(LN2(Mo)) + Mo.
    `cross_batch=True` attends across the BATCH axis at each token index,
    as the reference does (batch_first=False MHA fed [B, T, H]); under data
    parallelism across the global batch, as under JAX's SPMD: the keys and
    values are every rank's rows (`all_gather_rows`), the queries this
    rank's."""

    def __init__(self, hidden: int, num_heads: int = 8, cross_batch: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.cross_batch = cross_batch
        self.ln1 = nn.LayerNorm(hidden, eps=1e-5)
        self.mh = MultiHeadAttention(hidden, num_heads, bias=True, dtype=dtype)
        self.ln2 = nn.LayerNorm(hidden, eps=1e-5)
        self.ffn1 = Linear(hidden, hidden, dtype=dtype)
        self.ffn2 = Linear(hidden, hidden, dtype=dtype)

    def forward(self, eo, lp):
        lp_norm = layer_norm(self.ln1, lp)
        if self.cross_batch:
            kv = dp.all_gather_rows(lp_norm).transpose(0, 1)
            mo = self.mh(eo.transpose(0, 1), kv, kv).transpose(0, 1)
        else:
            mo = self.mh(eo, lp_norm, lp_norm)
        mo = mo + lp  # fp32: the bf16 attention output promotes against lp
        return self.ffn2(F.relu(self.ffn1(layer_norm(self.ln2, mo)))) + mo


class FFTBlocks(nn.Module):
    """EncSALayer stack with optional sinusoidal positions and a final LN
    (`common.py:304-345`): the stack runs in `dtype`, the final LN in
    fp32, and the output is cast back to the input's dtype. `padding` and
    `act` are the FFNs' (`ffn_padding`, `ffn_act`). With `remat` (the
    config's `remat`, JAX's `nn.remat` on each block) every layer runs under
    `checkpointed` where gradients are taken: the same values, gradients
    and dropout masks, with the layers' activations recomputed in the
    backward pass instead of kept."""

    def __init__(self, hidden: int, num_layers: int, ffn_kernel_size: int = 9,
                 num_heads: int = 2, use_pos_embed: bool = True, dtype=torch.float32,
                 dropout: float = 0.0, padding: str = "SAME", act: str = "gelu",
                 remat: bool = False):
        super().__init__()
        self.hidden, self.num_layers, self.use_pos_embed = hidden, num_layers, use_pos_embed
        self.dtype_ = dtype
        self.remat = bool(remat)
        if use_pos_embed:
            self.pos_embed_alpha = nn.Parameter(torch.ones(1))
            self.pos_dropout = Dropout(dropout)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncSALayer(hidden, num_heads, ffn_kernel_size, dtype,
                                                     dropout, padding, act))
        self.final_ln = nn.LayerNorm(hidden, eps=1e-5)

    def forward(self, x, padding_mask=None):
        if padding_mask is None:
            padding_mask = x.abs().sum(-1) == 0
        out_dtype = x.dtype
        x = x.to(self.dtype_)
        nonpad = 1.0 - padding_mask.to(x.dtype)[:, :, None]
        if self.use_pos_embed:
            x = self.pos_dropout(x + (self.pos_embed_alpha * sinusoidal_positions(
                (~padding_mask).long(), self.hidden)).to(x.dtype))
        x = x * nonpad
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            x = (checkpointed(layer, x, padding_mask) if remat else layer(x, padding_mask)) \
                * nonpad
        return (layer_norm(self.final_ln, x) * nonpad).to(out_dtype)
