"""K1: the DiffNet residual stack (counterpart of
`bisinger_tpu/ops/diffnet_pallas.py:fused_residual_stack`, line 174).

`residual_stack` runs the kernel of `csrc/diffnet_stack.cu` (one
cooperative launch for all layers) on CUDA tensors and the plain version
`residual_stack_plain` on CPU tensors. Inference only.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from bisinger_tpu_torch.ops import _build

counter = _build.LaunchCounter()

# Kernel against plain version, as max |difference| over the largest |value|
# of the plain output: both compute in fp32 and differ in summation order,
# compounded over the layers.
TOLERANCE = 2e-4


def residual_stack_plain(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations: Sequence[int]):
    """The stack as plain tensor ops, the TPU kernel's arithmetic: three
    shifted products for the dilated taps, the gate, the 1x1 output
    product. Same arguments and result as `residual_stack`."""
    B, T, C = x0.shape
    x = x0
    skip = torch.zeros_like(x0)
    for l, d in enumerate(dilations):
        a = x + step_proj[l][:, None, :]
        ap = torch.nn.functional.pad(a, (0, 0, d, d))  # zeros outside [0, T)
        y = (ap[:, :T] @ wd[l, 0] + ap[:, d:d + T] @ wd[l, 1] + ap[:, 2 * d:] @ wd[l, 2]
             + bd[l] + cond_proj[l])
        g = torch.sigmoid(y[..., :C]) * torch.tanh(y[..., C:])
        z = g @ wo[l] + bo[l]
        x = (x + z[..., :C]) / math.sqrt(2.0)
        skip = skip + z[..., C:]
    return skip


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 tensor on {device}, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def residual_stack(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations: Sequence[int]):
    """x0 [B,T,C] (after the input projection), cond_proj [L,B,T,2C],
    step_proj [L,B,C], wd [L,3,C,2C], bd [L,2C], wo [L,C,2C], bo [L,2C]
    -> skip sum [B,T,C] fp32 (the caller scales by 1/sqrt(L))."""
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
    if C % 32 or not 32 <= C <= 512 or not 1 <= L <= 64 or min(dilations) < 1:
        raise ValueError(f"residual_stack kernel takes 32 <= C <= 512 with C % 32 == 0 and "
                         f"1 <= L <= 64, got C={C}, L={L}")
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
    counter.launches += 1
    return skip


def stack_flops(B: int, T: int, C: int, L: int) -> int:
    """16*C^2 FLOP per frame per layer: 3 taps C->2C and a 1x1 C->2C."""
    return 16 * C * C * B * T * L


def stack_bytes(B: int, T: int, C: int, L: int) -> int:
    """Each input read once and the output written once, fp32."""
    inputs = B * T * C + L * B * T * 2 * C + L * B * C + L * 3 * C * 2 * C + L * 2 * C \
        + L * C * 2 * C + L * 2 * C
    return 4 * (inputs + B * T * C)
