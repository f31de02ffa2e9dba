"""K2: one HiFi-GAN MRF stage (counterpart of
`bisinger_tpu/ops/mrf_pallas.py:fused_mrf_stage`, line 322).

`mrf_stage` runs the kernel of `csrc/mrf_stage.cu` (one launch per stage)
on CUDA tensors and the plain version `mrf_stage_plain` on CPU tensors.
Both take the stage's weights packed by `pack_stage_weights`. Inference
only; the port never time-folds (the TPU kernel's `fold` is always 1).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from bisinger_tpu_torch.ops import _build

LRELU_SLOPE = 0.1
counter = _build.LaunchCounter()


# Kernel against plain version, as max |difference| over the largest |value|
# of the plain output: both compute in fp32 and differ in summation order.
TOLERANCE = 1e-4


def pack_stage_weights(blocks, kernel_sizes: Sequence[int], dilations: Sequence[Sequence[int]]):
    """ResBlock1 modules (each with conv1_i / conv2_i Conv1d) -> (w, b):
    w is the flat concatenation over (block, dilation, conv1 then conv2)
    of each kernel as [k][F_in][F_out]; b is [n_convs, F]."""
    ws, bs = [], []
    for blk, k, dils in zip(blocks, kernel_sizes, dilations):
        for i in range(len(dils)):
            for conv in (getattr(blk, f"conv1_{i}"), getattr(blk, f"conv2_{i}")):
                if conv.kernel_size[0] != k:
                    raise ValueError(f"kernel {conv.kernel_size[0]} != {k}")
                ws.append(conv.weight.permute(2, 1, 0).reshape(-1))
                bs.append(conv.bias)
    return torch.cat(ws).contiguous(), torch.stack(bs).contiguous()


def _tap_conv(x, w, b, k: int, d: int):
    """y[u] = sum_q lrelu(x[u + (q - (k-1)/2) * d]) @ w[q] + b, zero padding."""
    U = x.shape[1]
    r = d * (k - 1) // 2
    xp = F.pad(F.leaky_relu(x, LRELU_SLOPE), (0, 0, r, r))
    y = b
    for q in range(k):
        y = y + xp[:, q * d:q * d + U] @ w[q]
    return y


def mrf_stage_plain(x, w, b, kernel_sizes: Sequence[int], dilations: Sequence[Sequence[int]]):
    """The stage as plain tensor ops, the kernel's arithmetic: per-tap
    products over the [B, U, F] layout. Same arguments as `mrf_stage`."""
    Fch = x.shape[-1]
    out, off, slot = 0.0, 0, 0
    for k, dils in zip(kernel_sizes, dilations):
        y = x
        for d in dils:
            w1 = w[off:off + k * Fch * Fch].view(k, Fch, Fch)
            off += k * Fch * Fch
            t = _tap_conv(y, w1, b[slot], k, d)
            w2 = w[off:off + k * Fch * Fch].view(k, Fch, Fch)
            off += k * Fch * Fch
            y = y + _tap_conv(t, w2, b[slot + 1], k, 1)
            slot += 2
        out = out + y
    return out / len(kernel_sizes)


def mrf_stage_conv1d(x, w, b, kernel_sizes: Sequence[int], dilations: Sequence[Sequence[int]]):
    """The same stage as a chain of torch.nn.functional.conv1d calls: a
    yardstick for timing only; the port never calls it."""
    Fch = x.shape[-1]
    xt = x.transpose(1, 2)
    out, off, slot = 0.0, 0, 0
    for k, dils in zip(kernel_sizes, dilations):
        y = xt
        for d in dils:
            w1 = w[off:off + k * Fch * Fch].view(k, Fch, Fch).permute(2, 1, 0)
            off += k * Fch * Fch
            t = F.conv1d(F.leaky_relu(y, LRELU_SLOPE), w1, b[slot], padding=d * (k - 1) // 2,
                         dilation=d)
            w2 = w[off:off + k * Fch * Fch].view(k, Fch, Fch).permute(2, 1, 0)
            off += k * Fch * Fch
            y = y + F.conv1d(F.leaky_relu(t, LRELU_SLOPE), w2, b[slot + 1],
                             padding=(k - 1) // 2)
            slot += 2
        out = out + y
    return (out / len(kernel_sizes)).transpose(1, 2)


def mrf_stage(x, w, b, kernel_sizes: Sequence[int], dilations: Sequence[Sequence[int]]):
    """x [B,U,F] fp32 -> mean over ResBlock1 blocks [B,U,F] fp32."""
    if x.device.type == "cpu":
        return mrf_stage_plain(x, w, b, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage: no kernel for device {x.device}")
    B, U, Fch = x.shape
    n_blocks, n_dils = len(kernel_sizes), len(dilations[0])
    n_convs = 2 * n_blocks * n_dils
    w_len = 2 * sum(k * n_dils for k in kernel_sizes) * Fch * Fch
    for name, t, shape in (("x", x, (B, U, Fch)), ("w", w, (w_len,)), ("b", b, (n_convs, Fch))):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous float32 tensor on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if Fch not in (32, 64, 128, 256) or any(len(d) != n_dils for d in dilations) \
            or any(k % 2 == 0 for k in kernel_sizes) or n_blocks > 4 or n_dils > 4:
        raise ValueError(f"mrf_stage kernel takes F in (32, 64, 128, 256), odd kernels and "
                         f"up to 4 blocks x 4 dilations, got F={Fch}")
    out = torch.empty_like(x)
    lib = _build.load("mrf_stage")
    err = lib.mrf_stage(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, U, Fch, n_blocks, n_dils,
        ctypes.cast(_build.int_array(kernel_sizes), ctypes.c_void_p),
        ctypes.cast(_build.int_array([d for ds in dilations for d in ds]), ctypes.c_void_p),
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "mrf_stage", lib)
    counter.launches += 1
    return out


def stage_flops(B: int, U: int, Fch: int, kernel_sizes, dilations) -> int:
    """2 FLOP per MAC; each conv is k*F*F MACs per sample, two per dilation."""
    return 2 * B * U * Fch * Fch * sum(2 * k * len(d) for k, d in zip(kernel_sizes, dilations))


def stage_bytes(B: int, U: int, Fch: int, kernel_sizes, dilations) -> int:
    """Input read once, output written once, weights and biases once; fp32."""
    n_w = Fch * Fch * sum(2 * k * len(d) for k, d in zip(kernel_sizes, dilations))
    n_b = Fch * sum(2 * len(d) for d in dilations)
    return 4 * (2 * B * U * Fch + n_w + n_b)

