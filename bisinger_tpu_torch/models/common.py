"""Shared NN primitives in [B, T, C] layout.

Counterpart of `bisinger_tpu/models/common.py:36-345`. Submodules carry
the flax names so that `weights.load_flax_params` maps a flat key onto a
state_dict entry by path. Inference only: dropout is the identity.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Conv1d):
    """Conv1d over [B, T, C]. `padding=None` is flax's SAME for odd kernels:
    dilation * (k - 1) / 2 zeros on each side."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1,
                 stride: int = 1, padding: Optional[int] = None):
        if padding is None:
            padding = dilation * (k - 1) // 2
        super().__init__(cin, cout, k, stride=stride, padding=padding, dilation=dilation)

    def forward(self, x):
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


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


def sinusoidal_positions(nonpad_mask, dim: int, padding_idx: int = 0):
    """[B, T] nonpadding mask -> [B, T, dim] position embeddings."""
    t = nonpad_mask.shape[1]
    table = torch.from_numpy(sinusoidal_table(t + padding_idx + 1, dim, padding_idx)).to(
        nonpad_mask.device)
    mask = nonpad_mask.long()
    positions = torch.cumsum(mask, dim=1) * mask + padding_idx
    return table[positions]


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections, q scaled by head_dim^-0.5, key padding mask
    filled with the dtype's minimum (`common.py:110-154`)."""

    def __init__(self, d: int, num_heads: int, bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(d, d, bias=bias)
        self.k_proj = nn.Linear(d, d, bias=bias)
        self.v_proj = nn.Linear(d, d, bias=bias)
        self.out_proj = nn.Linear(d, d, bias=bias)

    def forward(self, query, key, value, key_padding_mask=None):
        b, tq, d = query.shape
        h = self.num_heads
        hd = d // h
        q = self.q_proj(query) * hd ** -0.5

        def split(x):
            return x.reshape(x.shape[0], x.shape[1], h, hd).transpose(1, 2)

        q, k, v = split(q), split(self.k_proj(key)), split(self.v_proj(value))
        logits = q @ k.transpose(-1, -2)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                        torch.finfo(logits.dtype).min)
        out = torch.softmax(logits, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, tq, d))


class TransformerFFN(nn.Module):
    """SAME Conv(k) -> * k^-0.5 -> GELU -> Dense (`common.py:157-194`, the
    flagship's `ffn_padding: SAME`, `ffn_act: gelu`)."""

    def __init__(self, hidden: int, filter_size: int, kernel_size: int = 9):
        super().__init__()
        self.kernel_size = kernel_size
        self.Conv_0 = Conv(hidden, filter_size, kernel_size)
        self.Dense_0 = nn.Linear(filter_size, hidden)

    def forward(self, x):
        x = self.Conv_0(x) * self.kernel_size ** -0.5
        return self.Dense_0(F.gelu(x, approximate="tanh"))  # jax.nn.gelu's default


class EncSALayer(nn.Module):
    """Pre-norm self-attention + conv-FFN, residuals re-masked
    (`common.py:197-243`)."""

    def __init__(self, hidden: int, num_heads: int, kernel_size: int = 9):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.self_attn = MultiHeadAttention(hidden, num_heads, bias=False)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=1e-5)
        self.ffn = TransformerFFN(hidden, 4 * hidden, kernel_size)

    def forward(self, x, padding_mask):
        nonpad = 1.0 - padding_mask.to(x.dtype)[:, :, None]
        y = self.layer_norm1(x)
        x = (x + self.self_attn(y, y, y, key_padding_mask=padding_mask)) * nonpad
        x = (x + self.ffn(self.layer_norm2(x))) * nonpad
        return x


class ESM(nn.Module):
    """Embedding Skip Module (`common.py:246-301`):
    Mo = MHA(q=Eo, k=v=LN1(LP)) + LP; Fo = FFN(LN2(Mo)) + Mo.
    `cross_batch=True` attends across the BATCH axis at each token index,
    as the reference does (batch_first=False MHA fed [B, T, H])."""

    def __init__(self, hidden: int, num_heads: int = 8, cross_batch: bool = True):
        super().__init__()
        self.cross_batch = cross_batch
        self.ln1 = nn.LayerNorm(hidden, eps=1e-5)
        self.mh = MultiHeadAttention(hidden, num_heads, bias=True)
        self.ln2 = nn.LayerNorm(hidden, eps=1e-5)
        self.ffn1 = nn.Linear(hidden, hidden)
        self.ffn2 = nn.Linear(hidden, hidden)

    def forward(self, eo, lp):
        lp_norm = self.ln1(lp)
        if self.cross_batch:
            mo = self.mh(eo.transpose(0, 1), lp_norm.transpose(0, 1),
                         lp_norm.transpose(0, 1)).transpose(0, 1)
        else:
            mo = self.mh(eo, lp_norm, lp_norm)
        mo = mo + lp
        return self.ffn2(F.relu(self.ffn1(self.ln2(mo)))) + mo


class FFTBlocks(nn.Module):
    """EncSALayer stack with optional sinusoidal positions and a final LN
    (`common.py:304-345`)."""

    def __init__(self, hidden: int, num_layers: int, ffn_kernel_size: int = 9,
                 num_heads: int = 2, use_pos_embed: bool = True):
        super().__init__()
        self.hidden, self.num_layers, self.use_pos_embed = hidden, num_layers, use_pos_embed
        if use_pos_embed:
            self.pos_embed_alpha = nn.Parameter(torch.ones(1))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncSALayer(hidden, num_heads, ffn_kernel_size))
        self.final_ln = nn.LayerNorm(hidden, eps=1e-5)

    def forward(self, x, padding_mask=None):
        if padding_mask is None:
            padding_mask = x.abs().sum(-1) == 0
        nonpad = 1.0 - padding_mask.to(x.dtype)[:, :, None]
        if self.use_pos_embed:
            x = x + self.pos_embed_alpha * sinusoidal_positions(
                (~padding_mask).long(), self.hidden)
        x = x * nonpad
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, padding_mask) * nonpad
        return self.final_ln(x) * nonpad
