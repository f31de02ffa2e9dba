"""K2: one HiFi-GAN MRF stage (counterpart of
`bisinger_tpu/ops/mrf_pallas.py:fused_mrf_stage`, line 322).

Two routes, chosen by the vocoder's `compute_dtype`:
- fp32: `mrf_stage` runs `csrc/mrf_stage.cu` (TF32 tensor cores in
  3xTF32, to fp32 accuracy; `_tf32.py` models the arithmetic);
- bf16: `mrf_stage_bf16` runs `csrc/mrf_stage_bf16.cu` (tensor cores,
  wgmma), rounding where the TPU kernel rounds with compute_dtype=bfloat16.
Each runs its kernel (one launch per stage) on CUDA tensors and its plain
version (`mrf_stage_plain`, `mrf_stage_plain_bf16`) on CPU tensors. All
take the stage's weights packed by `pack_stage_weights`. Inference only (on
any device both raise when grad mode is on and an input requires grad);
the port never time-folds (the TPU kernel's `fold` is always 1).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from bisinger_tpu_torch.ops import _build

LRELU_SLOPE = 0.1
# the slope as the TPU kernel's bf16 constant: bf16(0.1)
LRELU_SLOPE_BF16 = 0.10009765625
counter = _build.LaunchCounter()
counter_bf16 = _build.LaunchCounter()


# Kernel against plain version, as max |difference| over the largest |value|
# of the plain output: both compute in fp32 and differ in summation order.
TOLERANCE = 1e-4
# The bf16 route against its plain version, same measure: both round the
# same values at the same places, but a sum taken in another order can land
# on the other side of a bf16 rounding boundary (one bf16 step is 2^-8 of
# the value) and the step is carried through the block's later convs.
TOLERANCE_BF16 = 2e-2
# ... and as mean |difference| over the mean |value|, between the sound
# kernel's reading and that of a rounding point moved (the `conv1_dtype`
# control of the plain version); chip_smoke.py phase 4 reads both.
MEAN_TOLERANCE_BF16 = 1.6e-3


def pack_stage_weights(blocks, kernel_sizes: Sequence[int], dilations: Sequence[Sequence[int]],
                       dtype=torch.float32):
    """ResBlock1 modules (each with conv1_i / conv2_i Conv1d) -> (w, b):
    w is the flat concatenation over (block, dilation, conv1 then conv2)
    of each kernel as [k][F_in][F_out], in `dtype`; b is [n_convs, F] fp32."""
    ws, bs = [], []
    for blk, k, dils in zip(blocks, kernel_sizes, dilations):
        for i in range(len(dils)):
            for conv in (getattr(blk, f"conv1_{i}"), getattr(blk, f"conv2_{i}")):
                if conv.kernel_size[0] != k:
                    raise ValueError(f"kernel {conv.kernel_size[0]} != {k}")
                ws.append(conv.weight.permute(2, 1, 0).reshape(-1))
                bs.append(conv.bias)
    return torch.cat(ws).to(dtype).contiguous(), torch.stack(bs).contiguous()


def _tap_conv(x, w, b, k: int, d: int, mm=torch.matmul):
    """y[u] = sum_q lrelu(x[u + (q - (k-1)/2) * d]) @ w[q] + b, zero padding."""
    U = x.shape[1]
    r = d * (k - 1) // 2
    xp = F.pad(F.leaky_relu(x, LRELU_SLOPE), (0, 0, r, r))
    y = b
    for q in range(k):
        y = y + mm(xp[:, q * d:q * d + U], w[q])
    return y


def mrf_stage_plain(x, w, b, kernel_sizes: Sequence[int], dilations: Sequence[Sequence[int]],
                    mm=torch.matmul):
    """The stage as plain tensor ops, the kernel's arithmetic: per-tap
    products over the [B, U, F] layout. Same arguments as `mrf_stage`;
    `mm` takes the products (`_tf32.mrf_stage_plain_tf32` passes TF32
    ones)."""
    Fch = x.shape[-1]
    out, off, slot = 0.0, 0, 0
    for k, dils in zip(kernel_sizes, dilations):
        y = x
        for d in dils:
            w1 = w[off:off + k * Fch * Fch].view(k, Fch, Fch)
            off += k * Fch * Fch
            t = _tap_conv(y, w1, b[slot], k, d, mm)
            w2 = w[off:off + k * Fch * Fch].view(k, Fch, Fch)
            off += k * Fch * Fch
            y = y + _tap_conv(t, w2, b[slot + 1], k, 1, mm)
            slot += 2
        out = out + y
    return out / len(kernel_sizes)


def _lrelu_bf16(x):
    """lrelu of a bf16 tensor as the TPU kernel's `_lrelu`: bf16(0.1) * v,
    rounded to bf16, where v < 0."""
    return torch.where(x >= 0, x, (x.float() * LRELU_SLOPE_BF16).to(torch.bfloat16))


def _tap_conv_bf16(x, w, b, k: int, d: int):
    """bf16 x [B,U,F], bf16 w [k,F,F], fp32 b -> fp32
    y[u] = sum_q lrelu(x[u + (q - (k-1)/2) * d]) @ w[q] + b: bf16 values,
    fp32 products and sums (`mrf_pallas.py:170-195`)."""
    U = x.shape[1]
    r = d * (k - 1) // 2
    xp = F.pad(_lrelu_bf16(x).float(), (0, 0, r, r))
    wf = w.float()
    y = xp[:, :U] @ wf[0]
    for q in range(1, k):
        y = y + xp[:, q * d:q * d + U] @ wf[q]
    return y + b


def mrf_stage_plain_bf16(x, w, b, kernel_sizes: Sequence[int],
                         dilations: Sequence[Sequence[int]], conv1_dtype=torch.bfloat16):
    """The stage with the TPU kernel's rounding under compute_dtype=bfloat16
    (`mrf_pallas.py:158-200`): the input and the running block state bf16,
    conv1's output rounded to bf16, conv2's added to the state in fp32 and
    the sum rounded; the cross-block mean fp32. x fp32, w bf16 (packed as
    for `mrf_stage`), b fp32 -> fp32. Same arguments as `mrf_stage_bf16`.
    `conv1_dtype` float32 leaves conv1's output unrounded: a control, one
    rounding point moved, that the mean bound must catch."""
    Fch = x.shape[-1]
    x16 = x.to(torch.bfloat16)
    out, off, slot = 0.0, 0, 0
    for k, dils in zip(kernel_sizes, dilations):
        y = x16
        for d in dils:
            w1 = w[off:off + k * Fch * Fch].view(k, Fch, Fch)
            off += k * Fch * Fch
            t = _tap_conv_bf16(y, w1, b[slot], k, d).to(conv1_dtype)
            w2 = w[off:off + k * Fch * Fch].view(k, Fch, Fch)
            off += k * Fch * Fch
            y = (y.float() + _tap_conv_bf16(t, w2, b[slot + 1], k, 1)).to(torch.bfloat16)
            slot += 2
        out = out + y.float()
    return out / len(kernel_sizes)


def mrf_stage_conv1d(x, w, b, kernel_sizes: Sequence[int], dilations: Sequence[Sequence[int]],
                     dtype=None):
    """The same stage as a chain of torch.nn.functional.conv1d calls, in
    `dtype` (default: x's): a yardstick for timing only; the port never
    calls it. Returns x's dtype."""
    out_dtype = x.dtype
    dtype = dtype or x.dtype
    x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
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
    return (out / len(kernel_sizes)).transpose(1, 2).to(out_dtype)


def _check_stage(name, x, w, b, kernel_sizes, dilations, w_dtype):
    B, U, Fch = x.shape
    n_blocks, n_dils = len(kernel_sizes), len(dilations[0])
    n_convs = 2 * n_blocks * n_dils
    w_len = 2 * sum(k * n_dils for k in kernel_sizes) * Fch * Fch
    for arg, t, shape, dtype in (("x", x, (B, U, Fch), torch.float32), ("w", w, (w_len,), w_dtype),
                                 ("b", b, (n_convs, Fch), torch.float32)):
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} needs a contiguous {dtype} tensor on {x.device}, "
                             f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} shape {tuple(t.shape)} != {shape}")
    if Fch not in (32, 64, 128, 256) or any(len(d) != n_dils for d in dilations) \
            or any(k % 2 == 0 for k in kernel_sizes) or n_blocks > 4 or n_dils > 4:
        raise ValueError(f"{name} kernel takes F in (32, 64, 128, 256), odd kernels and "
                         f"up to 4 blocks x 4 dilations, got F={Fch}")


def _launch(fn, lib, x, w, b, kernel_sizes, dilations):
    B, U, Fch = x.shape
    out = torch.empty_like(x)
    err = getattr(lib, fn)(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, U, Fch, len(kernel_sizes),
        len(dilations[0]), ctypes.cast(_build.int_array(kernel_sizes), ctypes.c_void_p),
        ctypes.cast(_build.int_array([d for ds in dilations for d in ds]), ctypes.c_void_p),
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, fn, lib)
    return out


def mrf_stage_bf16(x, w, b, kernel_sizes: Sequence[int], dilations: Sequence[Sequence[int]]):
    """x [B,U,F] fp32, w bf16 (packed), b fp32 -> mean over ResBlock1 blocks
    [B,U,F] fp32, computed in bf16 as `mrf_stage_plain_bf16`."""
    _build.refuse_autograd("mrf_stage_bf16", x, w, b)
    if x.device.type == "cpu":
        return mrf_stage_plain_bf16(x, w, b, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage_bf16: no kernel for device {x.device}")
    _check_stage("mrf_stage_bf16", x, w, b, kernel_sizes, dilations, torch.bfloat16)
    out = _launch("mrf_stage_bf16", _build.load("mrf_stage_bf16"), x, w, b, kernel_sizes,
                  dilations)
    counter_bf16.add(x.shape)
    return out


def mrf_stage(x, w, b, kernel_sizes: Sequence[int], dilations: Sequence[Sequence[int]]):
    """x [B,U,F] fp32 -> mean over ResBlock1 blocks [B,U,F] fp32."""
    _build.refuse_autograd("mrf_stage", x, w, b)
    if x.device.type == "cpu":
        return mrf_stage_plain(x, w, b, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage: no kernel for device {x.device}")
    _check_stage("mrf_stage", x, w, b, kernel_sizes, dilations, torch.float32)
    out = _launch("mrf_stage", _build.load("mrf_stage"), x, w, b, kernel_sizes, dilations)
    counter.add(x.shape)
    return out


def stage_flops(B: int, U: int, Fch: int, kernel_sizes, dilations) -> int:
    """2 FLOP per MAC; each conv is k*F*F MACs per sample, two per dilation."""
    return 2 * B * U * Fch * Fch * sum(2 * k * len(d) for k, d in zip(kernel_sizes, dilations))


def stage_bytes(B: int, U: int, Fch: int, kernel_sizes, dilations, bf16: bool = False) -> int:
    """Input read once, output written once, weights and biases once; fp32,
    or bf16 weights (`bf16`: the input, output and biases stay fp32)."""
    n_w = Fch * Fch * sum(2 * k * len(d) for k, d in zip(kernel_sizes, dilations))
    n_b = Fch * sum(2 * len(d) for d in dilations)
    return 4 * (2 * B * U * Fch + n_b) + (2 if bf16 else 4) * n_w

