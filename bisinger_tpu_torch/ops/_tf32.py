"""A CPU model of the fp32 kernels' products on the TF32 tensor cores
(`csrc/mma_tf32.cuh`).

TF32 keeps 10 of fp32's 23 mantissa bits. The fp32 routes of K1
(`csrc/diffnet_stack.cu`) and K2 (`csrc/mrf_stage.cu`) split each fp32
operand into hi = tf32(v) and lo = tf32(v - hi) and take a product as
a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi (3xTF32), which is fp32's accuracy
to about 2^-21 of a product. A single TF32 product (`passes=1`) keeps
about 5e-4 of it: the control that shows the kernels' split is done.
Plain torch functions, for the CPU tests and for `chip_smoke.py`.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from bisinger_tpu_torch.ops.diffnet_stack import residual_stack_plain
from bisinger_tpu_torch.ops.mrf_stage import mrf_stage_plain

_HALF_ULP = 1 << 12  # half a unit in the last of 10 mantissa bits
_KEEP = ~((1 << 13) - 1)  # sign, exponent and the top 10 mantissa bits


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 as `cvt.rna.tf32.f32` does: to nearest, ties
    away from zero, kept in fp32 with the low 13 mantissa bits zero.
    Adding half an ulp to the int32 view rounds the magnitude, whatever the
    sign; infinities and NaNs are left as they are."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + _HALF_ULP) & _KEEP).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def split_tf32(x: torch.Tensor):
    """x -> (hi, lo): hi = round_tf32(x), lo = round_tf32(x - hi)."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b as the tensor cores take it with TF32 operands and fp32 sums:
    one product of the rounded operands (`passes=1`), or the kernels'
    three (`passes=3`), the cross terms first."""
    if passes == 1:
        return round_tf32(a) @ round_tf32(b)
    if passes != 3:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def residual_stack_plain_tf32(x0, cond_proj, step_proj, wd, bd, wo, bo,
                              dilations: Sequence[int], passes: int = 3):
    """K1's plain version (`residual_stack_plain`) with TF32 products."""
    return residual_stack_plain(x0, cond_proj, step_proj, wd, bd, wo, bo, dilations,
                                mm=functools.partial(matmul_tf32, passes=passes))


def mrf_stage_plain_tf32(x, w, b, kernel_sizes: Sequence[int],
                         dilations: Sequence[Sequence[int]], passes: int = 3):
    """K2's plain version (`mrf_stage_plain`) with TF32 products."""
    return mrf_stage_plain(x, w, b, kernel_sizes, dilations,
                           mm=functools.partial(matmul_tf32, passes=passes))
