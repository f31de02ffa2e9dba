"""K2's plain version and the port's NSF HiFi-GAN against the JAX package,
on the CPU at small widths.

Tolerances: 3e-5 for the MRF stage against both the Pallas kernel in
interpret mode (fp32 compute) and the ResBlock1 XLA path, the bound of
tests/test_mrf_pallas.py:61; 1e-4 abs for the NSF source and the whole
generator, where fp32 phase sums in another order are the difference.
The NSF phase and noise are numpy draws handed to both sides.

K2's bf16 plain version (`mrf_stage_plain_bf16`) rounds where the Pallas
kernel with compute_dtype=bfloat16 rounds. Against it in interpret mode:
1e-2 of the largest value and 1e-3 of the mean |value| on the mean
difference (measured 3.0e-3 and 1.3e-4: the fp32 sums differ in order,
which moves a bf16 rounding of the state now and then, and the move is
carried through the block). Against the flax ResBlock1 stack in bf16
(XLA), which keeps the residual state fp32 and rounds each conv's output
instead: 1e-2 of the largest value (measured 4.4e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bisinger_tpu.models.hifigan as jhifigan
from bisinger_tpu.ops.mrf_pallas import fused_mrf_stage
from bisinger_tpu_torch.models.hifigan import HifiGanGenerator, ResBlock1, phase_steps, sine_gen
from bisinger_tpu_torch.ops.mrf_stage import (
    mrf_stage,
    mrf_stage_bf16,
    mrf_stage_conv1d,
    mrf_stage_plain,
    mrf_stage_plain_bf16,
    pack_stage_weights,
)

from torch_port_helpers import hparams, max_err, t, to_port

RK = (3, 7, 11)
RD = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


def _stage(tmp_path, C, U, B=2, seed=0):
    """Flax ResBlock1 params for one stage, the same blocks in the port, an input."""
    x = np.random.default_rng(seed).standard_normal((B, U, C)).astype(np.float32)
    jparams, blocks = [], []
    for j, (k, d) in enumerate(zip(RK, RD)):
        p = jhifigan.ResBlock1(channels=C, kernel_size=k, dilations=d).init(
            jax.random.PRNGKey(seed * 10 + j), x)["params"]
        # the reference init (std 0.01) makes the convs nearly the identity;
        # scale them up so every conv matters to the comparison
        p = jax.tree_util.tree_map(lambda a: a * 8.0, p)
        jparams.append(p)
        blocks.append(to_port(ResBlock1(C, k, d), p, tmp_path, name=f"res_{j}.npz"))
    w, b = pack_stage_weights(blocks, RK, RD)
    return x, jparams, w.detach(), b.detach()


@pytest.mark.parametrize("tap_mode", ["static", "roll"])
def test_mrf_plain_matches_pallas_interpret(tmp_path, tap_mode):
    x, jparams, w, b = _stage(tmp_path, C=32, U=300)
    ref = np.asarray(fused_mrf_stage(jnp.asarray(x), jparams, RK, RD, fold=1, u_chunk=128,
                                     compute_dtype=jnp.float32, tap_mode=tap_mode,
                                     interpret=True))
    got = mrf_stage_plain(t(x), w, b, RK, RD).numpy()
    assert np.abs(got - x).max() > 0.05, "vacuous: the stage must change x"
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("C,U", [(32, 200), (64, 96)])
def test_mrf_plain_matches_xla_resblocks(tmp_path, C, U):
    x, jparams, w, b = _stage(tmp_path, C=C, U=U, seed=C)
    ref = 0.0
    for j, (k, d) in enumerate(zip(RK, RD)):
        ref = ref + jhifigan.ResBlock1(channels=C, kernel_size=k, dilations=d).apply(
            {"params": jparams[j]}, x)
    ref = np.asarray(ref / len(RK))
    got = mrf_stage(t(x), w, b, RK, RD).numpy()  # CPU tensor: the plain version
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(mrf_stage_conv1d(t(x), w, b, RK, RD).numpy(), got, atol=3e-5)


def _bf16_stage(tmp_path, C, U):
    x, jparams, _, b = _stage(tmp_path, C=C, U=U)
    blocks = [to_port(ResBlock1(C, k, d), p, tmp_path, name=f"res16_{j}.npz")
              for j, (k, d, p) in enumerate(zip(RK, RD, jparams))]
    w, _ = pack_stage_weights(blocks, RK, RD, torch.bfloat16)
    return x, jparams, w.detach(), b


def test_mrf_plain_bf16_matches_pallas_interpret(tmp_path):
    # the roll taps, the generator's default (`hifigan.py:379`); the static
    # ones compute the same function and are held in fp32 above
    x, jparams, w, b = _bf16_stage(tmp_path, C=32, U=300)
    ref = np.asarray(fused_mrf_stage(jnp.asarray(x), jparams, RK, RD, fold=1, u_chunk=128,
                                     compute_dtype=jnp.bfloat16, tap_mode="roll",
                                     interpret=True))
    got = mrf_stage_plain_bf16(t(x), w, b, RK, RD).numpy()
    assert np.abs(got - x).max() > 0.05, "vacuous: the stage must change x"
    diff = np.abs(got - ref)
    assert diff.max() / np.abs(ref).max() < 1e-2
    assert diff.mean() / np.abs(ref).mean() < 1e-3


def test_mrf_plain_bf16_matches_flax_bf16_resblocks(tmp_path):
    x, jparams, w, b = _bf16_stage(tmp_path, C=32, U=200)
    ref = 0.0
    for j, (k, d) in enumerate(zip(RK, RD)):
        ref = ref + jhifigan.ResBlock1(channels=32, kernel_size=k, dilations=d,
                                       dtype=jnp.bfloat16).apply({"params": jparams[j]},
                                                                 jnp.asarray(x))
    ref = np.asarray(ref / len(RK))
    got = mrf_stage_bf16(t(x), w, b, RK, RD).numpy()  # CPU tensor: the plain version
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-2


def test_mrf_wrapper_rejects_other_devices(tmp_path):
    x, _, w, b = _stage(tmp_path, C=32, U=64)
    with pytest.raises(ValueError, match="no kernel"):
        mrf_stage(t(x).to("meta"), w.to("meta"), b.to("meta"), RK, RD)
    with pytest.raises(ValueError, match="no kernel"):
        mrf_stage_bf16(t(x).to("meta"), w.to(torch.bfloat16).to("meta"), b.to("meta"), RK, RD)


def _pinned_jax_random(monkeypatch, phase, noise):
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), dtype=jnp.float32, **kw: jnp.asarray(phase, dtype))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32, **kw: jnp.asarray(noise, dtype))


def _f0(B, T, seed):
    r = np.random.default_rng(seed)
    f0 = r.uniform(150.0, 450.0, (B, T)).astype(np.float32)
    f0[:, T // 3: T // 3 + 3] = 0.0  # an unvoiced stretch
    return f0


def test_sine_gen_matches(monkeypatch):
    B, T, sr = 2, 4096, 24000
    f0 = np.repeat(_f0(B, 32, 1), 128, axis=1)[:, :, None]
    r = np.random.default_rng(2)
    phase = r.uniform(size=(B, 9)).astype(np.float32)
    noise = r.standard_normal((B, T, 9)).astype(np.float32)
    with monkeypatch.context() as mp:
        _pinned_jax_random(mp, phase, noise)
        ref, ref_uv, _ = jhifigan.sine_gen(jnp.asarray(f0), jax.random.PRNGKey(0), sr)
    got, uv = sine_gen(t(f0), sr, phase=t(phase), noise=t(noise))
    np.testing.assert_array_equal(uv.numpy(), np.asarray(ref_uv))
    assert max_err(got.numpy(), ref) <= 1e-4


def test_nsf_phase_steps_round_as_xla():
    """The NSF phase's per-sample steps (f0 * k / sample_rate mod 1, 9
    harmonics of f0 from 40 Hz to 1.1 kHz) equal XLA's compiled division by
    the constant bit for bit; PyTorch's true division on the CPU rounds some
    of them the other way (its CUDA one multiplies by the reciprocal)."""
    r = np.random.default_rng(0)
    f0_k = (r.uniform(40.0, 1100.0, (4096, 1)) * np.arange(1, 10)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: (v / 24000) % 1.0)(jnp.asarray(f0_k)))
    np.testing.assert_array_equal(phase_steps(t(f0_k), 24000).numpy(), ref)
    assert (torch.remainder(t(f0_k) / 24000, 1.0).numpy() != ref).any()


def test_generator_matches(tmp_path, monkeypatch):
    jhp, hp = hparams()
    B, T = 2, 16
    mel = np.random.default_rng(3).standard_normal((B, T, 80)).astype(np.float32)
    f0 = _f0(B, T, 4)
    jgen = jhifigan.HifiGanGenerator(hp=jhp)
    params = jgen.init({"params": jax.random.PRNGKey(0), "nsf": jax.random.PRNGKey(1)},
                       mel, f0)["params"]
    gen = to_port(HifiGanGenerator(hp), params, tmp_path)
    r = np.random.default_rng(5)
    phase = r.uniform(size=(B, 9)).astype(np.float32)
    noise = r.standard_normal((B, T * 128, 9)).astype(np.float32)
    with monkeypatch.context() as mp:
        _pinned_jax_random(mp, phase, noise)
        ref = np.asarray(jgen.apply({"params": params}, mel, f0,
                                    rngs={"nsf": jax.random.PRNGKey(2)}))
    with torch.no_grad():
        got = gen(t(mel), t(f0), phase=t(phase), noise=t(noise)).numpy()
    assert got.shape == ref.shape == (B, T * 128)
    assert np.abs(ref).max() > 1e-3
    assert max_err(got, ref) <= 1e-4
