"""K1: the DiffNet residual stack (counterpart of
`bisinger_tpu/ops/diffnet_pallas.py:fused_residual_stack`, line 174).

Two routes, chosen by the model's `compute_dtype`:
- fp32: `residual_stack` runs `csrc/diffnet_stack.cu` (TF32 tensor cores
  in 3xTF32, to fp32 accuracy; `_tf32.py` models the arithmetic);
- bf16: `residual_stack_bf16` runs `csrc/diffnet_stack_bf16.cu` (tensor
  cores), rounding where the TPU kernel rounds.
Each runs its kernel (one cooperative launch for all layers) on CUDA
tensors and its plain version (`residual_stack_plain`,
`residual_stack_plain_bf16`) on CPU tensors. Inference only: on any device,
both raise when grad mode is on and an input requires grad.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from bisinger_tpu_torch.ops import _build

counter = _build.LaunchCounter()
counter_bf16 = _build.LaunchCounter()

# Kernel against plain version, as max |difference| over the largest |value|
# of the plain output: both compute in fp32 and differ in summation order,
# compounded over the layers.
TOLERANCE = 2e-4
# The bf16 route against its plain version, same measure: both round the
# same bf16 values at the same places, but a sum taken in another order can
# land a value on the other side of a bf16 rounding boundary (one bf16 step
# is 2^-8 = 3.9e-3 of the value), and such a step in the gate or the hidden
# state is carried through the later layers.
TOLERANCE_BF16 = 2e-2
# ... and as mean |difference| over the mean |value|: such flips are rare,
# so the mean stays near the sound kernel's reading, while a rounding
# point moved (the `skip_dtype` control of the plain version) moves
# every value; the bound lies between the two readings (chip_smoke.py
# phase 3 reads both).
MEAN_TOLERANCE_BF16 = 4e-3
RSQRT2 = 1.0 / math.sqrt(2.0)


def residual_stack_plain(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations: Sequence[int],
                         mm=torch.matmul):
    """The stack as plain tensor ops, the TPU kernel's arithmetic: three
    shifted products for the dilated taps, the gate, the 1x1 output
    product. Same arguments and result as `residual_stack`; `mm` takes the
    products (`_tf32.residual_stack_plain_tf32` passes TF32 ones)."""
    B, T, C = x0.shape
    x = x0
    skip = torch.zeros_like(x0)
    for l, d in enumerate(dilations):
        a = x + step_proj[l][:, None, :]
        ap = torch.nn.functional.pad(a, (0, 0, d, d))  # zeros outside [0, T)
        y = (mm(ap[:, :T], wd[l, 0]) + mm(ap[:, d:d + T], wd[l, 1]) + mm(ap[:, 2 * d:], wd[l, 2])
             + bd[l] + cond_proj[l])
        g = torch.sigmoid(y[..., :C]) * torch.tanh(y[..., C:])
        z = mm(g, wo[l]) + bo[l]
        x = (x + z[..., :C]) / math.sqrt(2.0)
        skip = skip + z[..., C:]
    return skip


def residual_stack_plain_bf16(x0, cond_proj, step_proj, wd, bd, wo, bo,
                              dilations: Sequence[int], skip_dtype=torch.float32):
    """The stack with the TPU kernel's rounding (`diffnet_pallas.py:96-151`):
    the hidden state, (x + step), cond_proj, the gate and the weights bf16;
    products of bf16 values summed in fp32 (bf16 values upcast, fp32
    matmuls); biases, the gate's arithmetic and the skip sum fp32. Same
    arguments and dtypes as `residual_stack_bf16`; returns the fp32 skip.
    `skip_dtype` bfloat16 rounds the skip sum at every layer: a control,
    one rounding point moved, that the mean bound must catch."""
    B, T, C = x0.shape
    x = x0
    skip = torch.zeros((B, T, C), dtype=torch.float32, device=x0.device)
    for l, d in enumerate(dilations):
        a = (x + step_proj[l][:, None, :]).float()  # the bf16 sum, rounded
        ap = torch.nn.functional.pad(a, (0, 0, d, d))  # zeros outside [0, T)
        w = wd[l].float()
        y = ap[:, :T] @ w[0] + ap[:, d:d + T] @ w[1] + ap[:, 2 * d:] @ w[2]
        y = y + bd[l] + cond_proj[l].float()
        g = (torch.sigmoid(y[..., :C]) * torch.tanh(y[..., C:])).to(torch.bfloat16)
        z = g.float() @ wo[l].float() + bo[l]
        x = ((x.float() + z[..., :C]) * RSQRT2).to(torch.bfloat16)
        skip = (skip + z[..., C:]).to(skip_dtype).float()
    return skip


def _check(name, t, shape, device, dtype=torch.float32):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def residual_stack(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations: Sequence[int]):
    """x0 [B,T,C] (after the input projection), cond_proj [L,B,T,2C],
    step_proj [L,B,C], wd [L,3,C,2C], bd [L,2C], wo [L,C,2C], bo [L,2C]
    -> skip sum [B,T,C] fp32 (the caller scales by 1/sqrt(L))."""
    _build.refuse_autograd("residual_stack", x0, cond_proj, step_proj, wd, bd, wo, bo)
    if x0.device.type == "cpu":
        return residual_stack_plain(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations)
    if x0.device.type != "cuda":
        raise ValueError(f"residual_stack: no kernel for device {x0.device}")
    B, T, C = x0.shape
    L = len(dilations)
    dev = x0.device
    _check("x0", x0, (B, T, C), dev)
    _check("cond_proj", cond_proj, (L, B, T, 2 * C), dev)
    _check("step_proj", step_proj, (L, B, C), dev)
    _check("wd", wd, (L, 3, C, 2 * C), dev)
    _check("bd", bd, (L, 2 * C), dev)
    _check("wo", wo, (L, C, 2 * C), dev)
    _check("bo", bo, (L, 2 * C), dev)
    if C != 256 or not 1 <= L <= 64 or min(dilations) < 1:
        raise ValueError(f"residual_stack kernel takes C = 256 and 1 <= L <= 64, "
                         f"got C={C}, L={L}")
    xbuf = torch.empty((2, B, T, C), device=dev, dtype=torch.float32)
    skip = torch.empty((B, T, C), device=dev, dtype=torch.float32)
    lib = _build.load("diffnet_stack")
    err = lib.diffnet_residual_stack(
        x0.data_ptr(), cond_proj.data_ptr(), step_proj.data_ptr(), wd.data_ptr(),
        bd.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        ctypes.cast(_build.int_array(dilations), ctypes.c_void_p),
        xbuf.data_ptr(), skip.data_ptr(), B, T, C, L, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "diffnet_residual_stack", lib)
    counter.add(x0.shape)
    return skip


def residual_stack_bf16(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations: Sequence[int]):
    """x0 [B,T,C] bf16, cond_proj [L,B,T,2C] bf16, step_proj [L,B,C] bf16,
    wd [L,3,C,2C] bf16, bd [L,2C] fp32, wo [L,C,2C] bf16, bo [L,2C] fp32
    -> skip sum [B,T,C] fp32 (the caller scales by 1/sqrt(L))."""
    _build.refuse_autograd("residual_stack_bf16", x0, cond_proj, step_proj, wd, bd, wo, bo)
    if x0.device.type == "cpu":
        return residual_stack_plain_bf16(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations)
    if x0.device.type != "cuda":
        raise ValueError(f"residual_stack_bf16: no kernel for device {x0.device}")
    B, T, C = x0.shape
    L = len(dilations)
    dev, b16 = x0.device, torch.bfloat16
    _check("x0", x0, (B, T, C), dev, b16)
    _check("cond_proj", cond_proj, (L, B, T, 2 * C), dev, b16)
    _check("step_proj", step_proj, (L, B, C), dev, b16)
    _check("wd", wd, (L, 3, C, 2 * C), dev, b16)
    _check("bd", bd, (L, 2 * C), dev)
    _check("wo", wo, (L, C, 2 * C), dev, b16)
    _check("bo", bo, (L, 2 * C), dev)
    if C != 256 or not 1 <= L <= 64 or min(dilations) < 1:
        raise ValueError(f"residual_stack_bf16 kernel takes C = 256 and 1 <= L <= 64, "
                         f"got C={C}, L={L}")
    xbuf = torch.empty((2, B, T, C), device=dev, dtype=b16)
    skip = torch.empty((B, T, C), device=dev, dtype=torch.float32)
    lib = _build.load("diffnet_stack_bf16")
    err = lib.diffnet_residual_stack_bf16(
        x0.data_ptr(), cond_proj.data_ptr(), step_proj.data_ptr(), wd.data_ptr(),
        bd.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        ctypes.cast(_build.int_array(dilations), ctypes.c_void_p),
        xbuf.data_ptr(), skip.data_ptr(), B, T, C, L, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "diffnet_residual_stack_bf16", lib)
    counter_bf16.add(x0.shape)
    return skip


def residual_stack_library(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations: Sequence[int],
                           dtype=None):
    """The same stack as a chain of library calls in `dtype` (default: x0's):
    per layer, the dilated conv as one cuDNN `conv1d` over [B, C, T] and
    the 1x1 output projection as one cuBLAS product, with the gate and the
    sums as elementwise ops. A yardstick for timing only; the port never
    calls it. Returns the fp32 skip sum [B, T, C]."""
    dtype = dtype or x0.dtype
    C = x0.shape[-1]
    x = x0.to(dtype).transpose(1, 2)  # [B, C, T]
    skip = 0.0
    for l, d in enumerate(dilations):
        a = x + step_proj[l].to(dtype)[:, :, None]
        y = torch.nn.functional.conv1d(a, wd[l].to(dtype).permute(2, 1, 0), bd[l].to(dtype),
                                       padding=d, dilation=d)
        y = y + cond_proj[l].to(dtype).transpose(1, 2)
        g = torch.sigmoid(y[:, :C]) * torch.tanh(y[:, C:])
        z = torch.matmul(wo[l].to(dtype).t(), g) + bo[l].to(dtype)[:, None]
        x = (x + z[:, :C]) * RSQRT2
        skip = skip + z[:, C:]
    return skip.transpose(1, 2).float()


def stack_flops(B: int, T: int, C: int, L: int) -> int:
    """16*C^2 FLOP per frame per layer: 3 taps C->2C and a 1x1 C->2C."""
    return 16 * C * C * B * T * L


def stack_bytes(B: int, T: int, C: int, L: int, bf16: bool = False) -> int:
    """Each input read once and the output written once: fp32 throughout,
    or (`bf16`) bf16 x0, cond_proj, step_proj and weights with fp32 biases
    and an fp32 output."""
    act = B * T * C + L * B * T * 2 * C + L * B * C + L * 3 * C * 2 * C + L * C * 2 * C
    f32 = 2 * L * 2 * C + B * T * C  # biases, output
    return (2 if bf16 else 4) * act + 4 * f32
