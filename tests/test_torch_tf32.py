"""The CPU model of the fp32 kernels' TF32 arithmetic (`ops/_tf32.py`).

The fp32 routes of K1 and K2 run their products on the TF32 tensor cores
in 3xTF32: each operand split into hi = tf32(v) and lo = tf32(v - hi),
three products. Here, at `TINY` widths on the CPU:
- the split: hi keeps 10 mantissa bits, hi + lo is v to 2^-21 of |v|, and
  ties round away from zero (as `cvt.rna.tf32.f32`);
- the plain versions with 3-pass products lie within 1e-5 of the largest
  value of the fp32 plain versions, and with single-pass products (the
  card's control, `chip_smoke.py`) above that: the ground for holding the
  kernels at least 10x under the control on the card;
- the 3-pass plain versions against the JAX package's Pallas kernels in
  interpret mode, with the bounds of `test_torch_diffnet.py` (5% of the
  largest value: the Pallas stack feeds bf16 operands) and
  `test_torch_hifigan.py` (3e-5, fp32 compute). Only the K2 case tells
  3-pass from single-pass TF32 against JAX (there single-pass reads 4.1e-4
  of the largest value, 2.8e-3 absolute, and 3-pass 3.1e-7); the K1 case shows the model in range of the Pallas stack, and
  K1's separation of the passes rests on the port's fp32 plain version
  (`test_three_passes_hold_fp32_and_one_does_not`).

One CPU thread, as every port test: `torch_port_helpers` sets it on import.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bisinger_tpu.ops.diffnet_pallas import fused_residual_stack
from bisinger_tpu.ops.mrf_pallas import fused_mrf_stage
from bisinger_tpu_torch.ops._tf32 import (
    mrf_stage_plain_tf32,
    residual_stack_plain_tf32,
    round_tf32,
    split_tf32,
)
from bisinger_tpu_torch.ops.diffnet_stack import residual_stack_plain
from bisinger_tpu_torch.ops.mrf_stage import mrf_stage_plain

from test_torch_diffnet import _stack_inputs
from test_torch_hifigan import RD, RK, _stage
from torch_port_helpers import max_err, t

LOW13 = (1 << 13) - 1


def _values(seed=0):
    r = np.random.default_rng(seed)
    mags = 10.0 ** r.uniform(-30, 30, 4096)
    return torch.from_numpy((mags * r.choice([-1.0, 1.0], 4096)).astype(np.float32))


@pytest.mark.parametrize("case", ["ten_bits", "hi_plus_lo", "ties_away"])
def test_split_tf32(case):
    x = _values()
    hi, lo = split_tf32(x)
    if case == "ten_bits":
        assert int((hi.view(torch.int32) & LOW13).abs().max()) == 0
        assert int((lo.view(torch.int32) & LOW13).abs().max()) == 0
        # nearest: |x - hi| is at most half of hi's last place
        assert bool(((x - hi).abs() <= hi.abs() * 2.0 ** -11).all())
    elif case == "hi_plus_lo":
        rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
        assert rel <= 2.0 ** -21
    else:
        # 1 + 2^-11 lies halfway between 1 and 1 + 2^-10 (2 + 2^-10 between 2
        # and 2 + 2^-9): away from zero, either sign
        ulp = 2.0 ** -10
        ties = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 3 * ulp / 2, 2 + ulp])
        want = torch.tensor([1 + ulp, -(1 + ulp), 1 + 2 * ulp, 2 + 2 * ulp])
        assert torch.equal(round_tf32(ties), want)
        below = torch.tensor([1 + ulp / 2 - 2.0 ** -23])
        assert torch.equal(round_tf32(below), torch.tensor([1.0]))


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_three_passes_hold_fp32_and_one_does_not(kernel):
    if kernel == "k1":
        args = [t(a) for a in _stack_inputs(2, 40, 32, 4, seed=3)]
        dils = [1, 2, 4, 8]
        ref = residual_stack_plain(*args, dils)
        three = residual_stack_plain_tf32(*args, dils, passes=3)
        one = residual_stack_plain_tf32(*args, dils, passes=1)
    else:
        g = torch.Generator().manual_seed(4)
        F = 32
        x = torch.randn((2, 300, F), generator=g)
        w = torch.randn((2 * F * F * 63,), generator=g) * (7 * F) ** -0.5
        b = 0.1 * torch.randn((18, F), generator=g)
        ref = mrf_stage_plain(x, w, b, RK, RD)
        three = mrf_stage_plain_tf32(x, w, b, RK, RD, passes=3)
        one = mrf_stage_plain_tf32(x, w, b, RK, RD, passes=1)
    assert _rel(three, ref) <= 1e-5
    assert _rel(one, ref) > 1e-5
    # the card holds the kernel 10x under the control: the model leaves room
    assert _rel(one, ref) >= 10 * _rel(three, ref)


def test_stack_three_passes_match_pallas_interpret():
    B, T, dils, t_chunk, b_chunk = 2, 64, [1, 2, 4, 8], 16, 1
    args = _stack_inputs(B, T, 32, len(dils), seed=B * 100 + T)
    ref = np.asarray(fused_residual_stack(*args, dils, t_chunk=t_chunk, b_chunk=b_chunk,
                                          interpret=True))
    got = residual_stack_plain_tf32(*[t(a) for a in args], dils).numpy()
    scale = np.abs(ref).max()
    assert scale > 0.1
    assert max_err(got, ref) / scale < 0.05


def test_mrf_three_passes_match_pallas_interpret(tmp_path):
    x, jparams, w, b = _stage(tmp_path, C=32, U=300)
    ref = np.asarray(fused_mrf_stage(jnp.asarray(x), jparams, RK, RD, fold=1, u_chunk=128,
                                     compute_dtype=jnp.float32, tap_mode="static",
                                     interpret=True))
    got = mrf_stage_plain_tf32(t(x), w, b, RK, RD).numpy()
    assert np.abs(got - x).max() > 0.05, "vacuous: the stage must change x"
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=3e-5)
