"""K1 and K2 at the widths the JAX package's scripts and configs use beyond
the flagship's, on the CPU.

The kernels take every residual channel count C that is a multiple of 32
from 32 to 512 (K1) and the stage widths F = 8 to 512 (K2), one library a
width (`ops/_build.py` WIDTHS). Here, where no card is: each plain version
against the JAX package's Pallas kernel in interpret mode at C = 64 and 128
and at F = 8 and 16 (the bounds of tests/test_torch_diffnet.py and
tests/test_torch_hifigan.py); K1-bf16's weight pack unpacked back to wd and
wo at every width its wide path takes; and the wrappers' checks, which
accept every listed width and refuse the rest with a message naming them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bisinger_tpu.models.hifigan as jhifigan
from bisinger_tpu.ops.diffnet_pallas import fused_residual_stack
from bisinger_tpu.ops.mrf_pallas import fused_mrf_stage
from bisinger_tpu_torch.models.hifigan import ResBlock1
from bisinger_tpu_torch.ops import _build, diffnet_stack, mrf_stage

from torch_port_helpers import max_err, t, to_port

torch.set_num_threads(1)

K1_WIDTHS = tuple(range(32, 513, 32))
K2_WIDTHS = (8, 16, 32, 64, 128, 256, 512)
RK = (3, 7, 11)
RD = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


def test_the_widths_are_listed_once():
    assert _build.K1_WIDTHS == K1_WIDTHS and _build.K2_WIDTHS == K2_WIDTHS
    assert _build.WIDTHS == {"diffnet_stack": K1_WIDTHS, "diffnet_stack_bf16": K1_WIDTHS,
                             "mrf_stage": K2_WIDTHS, "mrf_stage_bf16": K2_WIDTHS}
    # one library a kernel and width, each under its own name
    paths = {_build.library_path(n, w) for n, w in _build.targets()}
    assert len(paths) == 2 * len(K1_WIDTHS) + 2 * len(K2_WIDTHS)
    assert _build.targets(["mrf_stage"], {"mrf_stage": [8, 512]}) == \
        [("mrf_stage", 8), ("mrf_stage", 512)]
    with pytest.raises(ValueError, match="widths"):
        _build.targets(["diffnet_stack"], [48])


def _stack_inputs(B, T, C, L, seed):
    r = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * r.standard_normal(s)).astype(np.float32)  # noqa: E731
    return (f(B, T, C), f(L, B, T, 2 * C), f(L, B, C), f(L, 3, C, 2 * C, sc=C ** -0.5),
            f(L, 2 * C, sc=0.1), f(L, C, 2 * C, sc=C ** -0.5), f(L, 2 * C, sc=0.1))


# K1's plain versions against the Pallas kernel in interpret mode at the
# convergence run's and the toy sampler's C = 64 and at 128 (a few frames,
# 3 layers): fp32 within 5% of the largest value (the Pallas kernel feeds
# bf16 operands: tests/test_torch_diffnet.py's bound). The bf16 plain
# version rounds where the kernel rounds, and the fp32 sums differ in order
# only; but one sum landing on the other side of a bf16 rounding of the
# hidden state moves every later layer's values: at C = 64 that happens
# once here (relative max 2.07e-3, mean 1.57e-4; C = 128 1.9e-5 and
# 6.3e-7), so the bound is the kernels' own for such flips,
# `TOLERANCE_BF16` (2e-2) on the max, with 1e-3 on the mean, which a
# rounding point moved everywhere would pass (tests/test_torch_hifigan.py's
# bf16 mean bound)
@pytest.mark.parametrize("C", [64, 128])
@pytest.mark.parametrize("route", ["fp32", "bf16"])
def test_stack_plain_matches_pallas_interpret_at_other_widths(route, C):
    dils = [1, 2, 4]
    args = _stack_inputs(2, 24, C, len(dils), seed=C)
    ref = np.asarray(fused_residual_stack(*args, dils, t_chunk=16, b_chunk=1, interpret=True))
    scale = np.abs(ref).max()
    assert scale > 0.1
    if route == "fp32":
        got = diffnet_stack.residual_stack_plain(*[t(a) for a in args], dils).numpy()
        assert max_err(got, ref) / scale < 0.05
    else:
        x0, cond, step, wd, bd, wo, bo = [t(a) for a in args]
        b16 = torch.bfloat16
        got = diffnet_stack.residual_stack_plain_bf16(
            x0.to(b16), cond.to(b16), step.to(b16), wd.to(b16), bd, wo.to(b16), bo, dils)
        diff = np.abs(got.numpy() - ref)
        assert diff.max() / scale <= diffnet_stack.TOLERANCE_BF16
        assert diff.mean() / np.abs(ref).mean() <= 1e-3


def _stage(tmp_path, C, U, dtype, seed=0):
    """Flax ResBlock1 params of one stage at width C, the same blocks packed
    for the port, an input."""
    x = np.random.default_rng(seed).standard_normal((2, U, C)).astype(np.float32)
    jparams, blocks = [], []
    for j, (k, d) in enumerate(zip(RK, RD)):
        p = jhifigan.ResBlock1(channels=C, kernel_size=k, dilations=d).init(
            jax.random.PRNGKey(seed * 10 + j), x)["params"]
        # the reference init (std 0.01) makes the convs nearly the identity
        p = jax.tree_util.tree_map(lambda a: a * 8.0, p)
        jparams.append(p)
        blocks.append(to_port(ResBlock1(C, k, d), p, tmp_path, name=f"res_{C}_{j}.npz"))
    w, b = mrf_stage.pack_stage_weights(blocks, RK, RD, dtype)
    return x, jparams, w.detach(), b.detach()


# K2's plain versions against the Pallas kernel in interpret mode at the
# 128-channel vocoder's narrowest stages, F = 16 and 8 (the bounds of
# tests/test_torch_hifigan.py: fp32 3e-5; bf16 relative max 1e-2, mean 1e-3)
@pytest.mark.parametrize("F", [8, 16])
@pytest.mark.parametrize("route", ["fp32", "bf16"])
def test_mrf_plain_matches_pallas_interpret_at_other_widths(tmp_path, route, F):
    dtype = torch.float32 if route == "fp32" else torch.bfloat16
    x, jparams, w, b = _stage(tmp_path, F, 200, dtype, seed=F)
    ref = np.asarray(fused_mrf_stage(
        jnp.asarray(x), jparams, RK, RD, fold=1, u_chunk=128,
        compute_dtype=jnp.float32 if route == "fp32" else jnp.bfloat16, tap_mode="roll",
        interpret=True))
    plain = mrf_stage.mrf_stage_plain if route == "fp32" else mrf_stage.mrf_stage_plain_bf16
    got = plain(t(x), w, b, RK, RD).numpy()
    assert np.abs(got - x).max() > 0.05, "vacuous: the stage must change x"
    if route == "fp32":
        np.testing.assert_allclose(got, ref, atol=3e-5, rtol=3e-5)
    else:
        diff = np.abs(got - ref)
        assert diff.max() / np.abs(ref).max() < 1e-2
        assert diff.mean() / np.abs(ref).mean() < 1e-3


# K1-bf16's wide path at every width it takes (C % 64 == 0): the pack holds
# 4 (C / 64)^2 ring stages a layer and unpacks to wd and wo bit for bit; a
# width the wide path does not take is refused
@pytest.mark.parametrize("C", [c for c in K1_WIDTHS if c % 64 == 0])
def test_pack_unpacks_at_every_wide_width(C):
    L = 2
    g = torch.Generator().manual_seed(C)
    wd = torch.randn((L, 3, C, 2 * C), generator=g).to(torch.bfloat16)
    wo = torch.randn((L, C, 2 * C), generator=g).to(torch.bfloat16)
    packed = diffnet_stack.pack_weights_bf16(wd, wo)
    assert tuple(packed.shape) == (L, 4 * (C // 64) ** 2, 8192)
    wd2, wo2 = diffnet_stack.unpack_weights_bf16(packed, C)
    assert torch.equal(wd2, wd) and torch.equal(wo2, wo)
    assert diffnet_stack.uses_wide_path(32, 1024, C)
    assert not diffnet_stack.uses_wide_path(4, 256, C)


def test_pack_and_wide_path_refuse_other_widths():
    with pytest.raises(ValueError, match="C % 64"):
        diffnet_stack.pack_weights_bf16(torch.zeros((1, 3, 96, 192), dtype=torch.bfloat16),
                                        torch.zeros((1, 96, 192), dtype=torch.bfloat16))
    assert not diffnet_stack.uses_wide_path(32, 1024, 96)



# The wide path also needs its window beside the ring in shared memory (the
# C entry's rule, `wide::smem_bytes` against the 227 KB of sm_90): at C = 256
# dilations up to 14, at C = 512 (64-frame tiles) up to 8; above, the narrow
# path runs and no pack is made
@pytest.mark.parametrize("C,dmax,wide", [(64, 8, True), (256, 8, True), (256, 14, True),
                                         (256, 15, False), (384, 8, True), (512, 8, True),
                                         (512, 9, False)])
def test_the_wide_path_needs_its_window_in_shared_memory(C, dmax, wide):
    import os
    import re

    with open(os.path.join(os.path.dirname(diffnet_stack.__file__), "..", "csrc",
                           "diffnet_stack_bf16.cu")) as f:
        src = f.read()
    assert int(re.search(r"constexpr int NS = (\d+);", src).group(1)) == diffnet_stack.WIDE_RING
    assert diffnet_stack.uses_wide_path(32, 1024, C, dmax) is wide
    assert diffnet_stack.uses_wide_path(4, 256, C, dmax) is False


# The wrappers' checks (the card's path; on the CPU the wrappers run the plain
# versions at any width): every listed width passes, the others raise naming
# the widths taken
@pytest.mark.parametrize("C", list(K1_WIDTHS) + [16, 48, 100, 544, 1024])
def test_k1_checks_take_the_listed_widths(C):
    for name, lib in (("residual_stack", "diffnet_stack"),
                      ("residual_stack_bf16", "diffnet_stack_bf16")):
        if C in K1_WIDTHS:
            diffnet_stack._check_stack(name, lib, C, 20, [1, 2, 4, 8] * 5)
        else:
            with pytest.raises(ValueError, match=r"takes widths 32, 64, .*, 512, got"):
                diffnet_stack._check_stack(name, lib, C, 20, [1, 2, 4, 8] * 5)
    with pytest.raises(ValueError, match="1 <= L <= 64"):
        diffnet_stack._check_stack("residual_stack", "diffnet_stack", 256, 65, [1] * 65)


@pytest.mark.parametrize("F", list(K2_WIDTHS) + [4, 24, 48, 384, 1024])
def test_k2_checks_take_the_listed_widths(F):
    n_w = 2 * F * F * sum(k * len(d) for k, d in zip(RK, RD))
    x, b = torch.zeros((1, 16, F)), torch.zeros((18, F))
    for name, wdt in (("mrf_stage", torch.float32), ("mrf_stage_bf16", torch.bfloat16)):
        w = torch.zeros((n_w,), dtype=wdt)
        if F in K2_WIDTHS:
            mrf_stage._check_stage(name, x, w, b, RK, RD, wdt)
        else:
            with pytest.raises(ValueError, match=r"takes widths 8, 16, 32, 64, 128, 256, 512"):
                mrf_stage._check_stage(name, x, w, b, RK, RD, wdt)


# K2-bf16's mean bound by stage width: MEAN_TOLERANCE_BF16 up to F = 256,
# 1.9e-3 at F = 512, where the sound kernel read 1.59e-3 to 1.63e-3 on an
# H100 and the rounding-moved control 2.29e-3 to 2.31e-3
def test_k2_bf16_mean_bound_by_width():
    assert all(mrf_stage.mean_tolerance_bf16(F) == mrf_stage.MEAN_TOLERANCE_BF16
               for F in K2_WIDTHS if F <= 256)
    assert 1.63e-3 < mrf_stage.mean_tolerance_bf16(512) < 2.29e-3
