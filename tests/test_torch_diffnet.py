"""K1's plain version and the port's DiffNet / PLMS sampler against the JAX
package, on the CPU at small widths.

Tolerances: 1e-4 abs against the flax fp32 (XLA) path, where both sides
compute in fp32 and differ only in summation order; 5% of the output's
largest value against the Pallas kernel run in interpret mode, which feeds
bf16 operands (the bound of tests/test_diffnet_pallas.py).

K1's bf16 plain version (`residual_stack_plain_bf16`) rounds where the
Pallas kernel rounds: against it in interpret mode, 1e-3 of the largest
value (measured 1.4e-7: the fp32 sums differ in order only, which can move
a bf16 rounding). Against the flax modules in bf16 (XLA), which round the
conv outputs, the biases and the skip sum to bf16 where the kernel keeps
fp32, 2% of the largest value (measured 7.1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bisinger_tpu.models.diffnet import DiffNet as JDiffNet
from bisinger_tpu.models.diffnet import diffusion_step_embedding as j_step_embedding
from bisinger_tpu.models.diffusion import GaussianDiffusion as JGaussianDiffusion
from bisinger_tpu.ops.diffnet_pallas import fused_residual_stack
from bisinger_tpu_torch.models.diffnet import DiffNet, diffusion_step_embedding
from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
from bisinger_tpu_torch.ops.diffnet_stack import (
    residual_stack,
    residual_stack_library,
    residual_stack_plain,
    residual_stack_plain_bf16,
)

from torch_port_helpers import VOCAB, hparams, max_err, midi_batch, noisy, t, to_port

M = 80


def _diffnet_pair(tmp_path, B, T, seed=0, **kw):
    jhp, hp = hparams(**kw)
    rng = np.random.default_rng(seed)
    spec = rng.standard_normal((B, T, M)).astype(np.float32)
    cond = rng.standard_normal((B, T, jhp["hidden_size"])).astype(np.float32)
    steps = rng.integers(0, 1000, (B,)).astype(np.int32)
    jnet = JDiffNet(hp=jhp, in_dims=M)
    params = jnet.init(jax.random.PRNGKey(seed), spec, steps, cond=cond)["params"]
    params = noisy(dict(params), ("output_projection", "kernel"), seed + 1)
    net = to_port(DiffNet(hp, M), params, tmp_path)
    return jnet, params, net, spec, cond, steps


def test_step_embedding_matches():
    steps = np.array([0, 3, 77, 999], np.int32)
    ref = np.asarray(j_step_embedding(jnp.asarray(steps), 32))
    got = diffusion_step_embedding(t(steps), 32).numpy()
    assert max_err(got, ref) <= 1e-4


@pytest.mark.parametrize("B,T", [(2, 32), (3, 45)])
def test_diffnet_matches_flax(tmp_path, B, T):
    jnet, params, net, spec, cond, steps = _diffnet_pair(tmp_path, B, T)
    cp_ref = jnet.apply({"params": params}, cond, method=JDiffNet.cond_projections)
    ref = np.asarray(jnet.apply({"params": params}, spec, steps, cond_proj=cp_ref))
    assert np.abs(ref).max() > 0.01, "vacuous comparison"
    with torch.no_grad():
        cp = net.cond_projections(t(cond))
        got = net(t(spec), t(steps).long(), cp).numpy()
    assert max_err(cp.numpy(), cp_ref) <= 1e-4
    assert max_err(got, ref) <= 1e-4


def _stack_inputs(B, T, C, L, seed):
    r = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * r.standard_normal(s)).astype(np.float32)  # noqa: E731
    return (f(B, T, C), f(L, B, T, 2 * C), f(L, B, C), f(L, 3, C, 2 * C, sc=0.1),
            f(L, 2 * C, sc=0.1), f(L, C, 2 * C, sc=0.1), f(L, 2 * C, sc=0.1))


@pytest.mark.parametrize(
    "B,T,dils,t_chunk,b_chunk",
    [
        (2, 64, [1, 2, 4, 8], 16, 1),  # chunk boundaries every 16 frames, batch tiles
        (1, 32, [1, 2, 4, 8, 1, 2], 128, 0),  # one chunk: edge padding dominates
    ],
)
def test_stack_plain_matches_pallas_interpret(B, T, dils, t_chunk, b_chunk):
    C = 32
    args = _stack_inputs(B, T, C, len(dils), seed=B * 100 + T)
    ref = np.asarray(fused_residual_stack(*args, dils, t_chunk=t_chunk, b_chunk=b_chunk,
                                          interpret=True))
    got = residual_stack_plain(*[t(a) for a in args], dils).numpy()
    scale = np.abs(ref).max()
    assert scale > 0.1
    # whole output, then the edges and a chunk boundary on their own
    assert max_err(got, ref) / scale < 0.05
    edges = [(0, 8), (T - 8, T)] + ([(t_chunk - 8, t_chunk + 8)] if t_chunk < T else [])
    for lo, hi in edges:
        assert max_err(got[:, lo:hi], ref[:, lo:hi]) / scale < 0.05, (lo, hi)


def _bf16_args(args):
    """fp32 stack inputs -> the bf16 route's: bf16 activations and weights,
    fp32 biases (as torch tensors)."""
    x0, cond, step, wd, bd, wo, bo = [t(a) for a in args]
    b16 = torch.bfloat16
    return (x0.to(b16), cond.to(b16), step.to(b16), wd.to(b16), bd, wo.to(b16), bo)


@pytest.mark.parametrize(
    "B,T,dils,t_chunk,b_chunk",
    [
        (2, 64, [1, 2, 4, 8], 16, 1),
        (1, 32, [1, 2, 4, 8, 1, 2], 128, 0),
    ],
)
def test_stack_plain_bf16_matches_pallas_interpret(B, T, dils, t_chunk, b_chunk):
    C = 32
    args = _stack_inputs(B, T, C, len(dils), seed=B * 100 + T + 1)
    ref = np.asarray(fused_residual_stack(*args, dils, t_chunk=t_chunk, b_chunk=b_chunk,
                                          interpret=True))
    got = residual_stack_plain_bf16(*_bf16_args(args), dils)
    assert got.dtype == torch.float32
    scale = np.abs(ref).max()
    assert scale > 0.1
    assert max_err(got.numpy(), ref) / scale < 1e-3


def test_stack_plain_bf16_matches_flax_bf16_blocks(tmp_path):
    """The flax ResidualBlocks in bf16 (XLA) against the bf16 plain version
    on the same bf16 inputs: x0, cond_proj and the per-layer step projection
    as the flax module makes them."""
    B, T = 2, 32
    jnet, params, _, spec, cond, steps = _diffnet_pair(tmp_path, B, T, compute_dtype="bfloat16")
    variables = {"params": params}

    def flax_stack(m, spec, steps, cond):
        C = m.hp["residual_channels"]
        x = jax.nn.relu(m.input_projection(spec))
        s = m.mlp_0(j_step_embedding(steps, C))
        s = m.mlp_1(s * jnp.tanh(jax.nn.softplus(s)))
        cp = m.cond_projections(cond)
        steps_l = jnp.stack([blk.diffusion_projection(s) for blk in m.blocks])
        x0, skip = x, 0.0
        for i, blk in enumerate(m.blocks):
            x, sk = blk(x, cp[i], s)
            skip = skip + sk
        return x0, cp, steps_l, skip

    x0, cp, step_proj, ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda *a: jnet.apply(variables, *a, method=flax_stack))(spec, steps, cond))
    L, p = jnet.hp["residual_layers"], params
    wd = np.stack([p[f"res_{i}"]["dilated_conv"]["kernel"] for i in range(L)])
    bd = np.stack([p[f"res_{i}"]["dilated_conv"]["bias"] for i in range(L)])
    wo = np.stack([p[f"res_{i}"]["output_projection"]["kernel"][0] for i in range(L)])
    bo = np.stack([p[f"res_{i}"]["output_projection"]["bias"] for i in range(L)])
    b16 = torch.bfloat16
    got = residual_stack_plain_bf16(
        t(x0.astype(np.float32)).to(b16), t(cp.astype(np.float32)).to(b16),
        t(step_proj.astype(np.float32)).to(b16), t(wd).to(b16), t(bd), t(wo).to(b16), t(bo),
        [2 ** (i % 4) for i in range(L)])
    ref = ref.astype(np.float32)
    scale = np.abs(ref).max()
    assert scale > 0.1
    assert max_err(got.numpy(), ref) / scale < 0.02


def test_stack_library_chain_computes_the_stack():
    """The library-call yardstick chip_smoke.py times beside K1 (cuDNN
    conv1d and cuBLAS products) computes the same stack: fp32 within 1e-5
    of the largest value, bf16 within 2% (it rounds every op to bf16)."""
    dils = [1, 2, 4, 8]
    args = [t(a) for a in _stack_inputs(2, 40, 32, len(dils), seed=9)]
    ref = residual_stack_plain(*args, dils).numpy()
    scale = np.abs(ref).max()
    assert max_err(residual_stack_library(*args, dils).numpy(), ref) / scale < 1e-5
    got16 = residual_stack_library(*args, dils, dtype=torch.bfloat16)
    assert got16.dtype == torch.float32 and max_err(got16.numpy(), ref) / scale < 0.02


def test_stack_wrapper_uses_plain_on_cpu_and_rejects_other_devices():
    args = [t(a) for a in _stack_inputs(1, 16, 32, 2, seed=5)]
    out = residual_stack(*args, [1, 2])
    np.testing.assert_array_equal(out.numpy(), residual_stack_plain(*args, [1, 2]).numpy())
    with pytest.raises(ValueError, match="no kernel"):
        residual_stack(*[a.to("meta") for a in args], [1, 2])


def test_plms_loop_matches_jax(tmp_path):
    """Same start noise and cond_proj through both PLMS loops
    (K=40, speedup 5: 9 denoiser calls incl. the 2-call warmup)."""
    jhp, hp = hparams()
    batch = midi_batch(b=2, n_tokens=8, n_frames=24)
    jm = JGaussianDiffusion(hp=jhp, vocab_size=VOCAB)
    # under jax.jit: one compile instead of dispatching every op of the init
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        txt_tokens=batch["txt_tokens"], mel2ph=batch["mel2ph"], spk_embed=batch["spk_ids"],
        pitch_midi=batch["pitch_midi"], midi_dur=batch["midi_dur"], is_slur=batch["is_slur"],
        lang=batch["lang"], speechsing=batch["speechsing"],
        method=JGaussianDiffusion.init_path))()["params"]
    params = noisy(dict(params), ("denoise_fn", "output_projection", "kernel"), 3, 0.2)
    model = to_port(GaussianDiffusion(hp, VOCAB), params, tmp_path)
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 24, M)).astype(np.float32)
    cond = r.standard_normal((2, 24, 32)).astype(np.float32)

    def jloop(m, x, cond):
        cp = m.denoise_fn.cond_projections(cond)
        return m.plms_sample_loop(x, cp, jhp["K_step"], jhp["pndm_speedup"])

    ref = np.asarray(jm.apply({"params": params}, x, cond, method=jloop))
    calls = []
    real_forward = model.denoise_fn.forward
    model.denoise_fn.forward = lambda *a, **k: calls.append(1) or real_forward(*a, **k)
    with torch.no_grad():
        cp = model.denoise_fn.cond_projections(t(cond))
        got = model.plms_sample_loop(t(x), cp, hp["K_step"], hp["pndm_speedup"]).numpy()
    assert len(calls) == hp["K_step"] // hp["pndm_speedup"] + 1
    assert np.abs(got - x).max() > 0.1, "the loop must move x"
    assert max_err(got, ref) <= 1e-4
