"""Pipeline parallelism of the DiffNet (`bisinger_tpu_torch/parallel/
pipeline.py`) on the CPU: 4 gloo ranks as a ('data' 1, 'pipe' 4) mesh,
each a process of its own (`tests/torch_sp_worker.py`), at
tests/test_pipeline.py's hp (L=8, cycle 2, 32 channels, hidden 48) in
fp32, each rank holding its stage's two layers, loaded from the npz.

  - the pipelined denoiser at n_micro 1 and 2 against JAX's plain DiffNet
    within atol 1e-4 (tests/test_pipeline.py's bound);
  - a PLMS loop through it (K=8, stride 2) against the port's unsharded
    loop within 1e-4;
  - `split_stages` and `cond_projections_stacked` as JAX's, and the bad
    dilation split refused; the stage loader refuses another stage's keys;
  - K1's write-last mode in both plain versions: x_last is the state after
    the last layer (JAX's `_block_fwd` chain in fp32; in bf16 a stack split
    in two gives the whole stack's x_last exactly and its skip sum to fp32
    rounding).

Parameters are drawn on the port's side with flax's initialisers, the
output projection replaced by noise as tests/test_pipeline.py does.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bisinger_tpu.models.diffnet import DiffNet as JDiffNet
from bisinger_tpu.parallel import pipeline as jpipe
from bisinger_tpu.vocoders.hifigan import unflatten_params
from bisinger_tpu_torch.models.diffnet import DiffNet
from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
from bisinger_tpu_torch.ops import diffnet_stack
from bisinger_tpu_torch.parallel import pipeline
from bisinger_tpu_torch.training.tasks import flax_init_
from bisinger_tpu_torch.weights import export_flax_params, load_flax_params

from test_torch_sequence_parallel import spawn, wait
from torch_port_helpers import hparams, max_err

B, T, M, H, C, L = 4, 32, 80, 48, 32, 8
NET = dict(residual_layers=L, residual_channels=C, dilation_cycle_length=2, hidden_size=H,
           compute_dtype="float32")
PLMS = dict(timesteps=8, K_step=8, pndm_speedup=2)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The DiffNet's flat weights and inputs; the 4 ranks started on the
    pipelined cases; JAX's plain DiffNet and the port's unsharded PLMS loop
    meanwhile. Returns (flat, inputs, refs, the ranks' results)."""
    tmp = tmp_path_factory.mktemp("pp")
    out_dir = tmp / "out"
    out_dir.mkdir()
    jhp, php = hparams(**NET, **PLMS)
    net = flax_init_(DiffNet(php, M), 0)
    flat = export_flax_params(net)
    r = np.random.RandomState(0)
    for k in ("output_projection/kernel", "output_projection/bias"):
        flat[k] = (r.randn(*flat[k].shape) * 0.1).astype(np.float32)
    inputs = dict(spec=r.randn(B, T, M).astype(np.float32),
                  cond=r.randn(B, T, H).astype(np.float32),
                  t=r.randint(0, 100, (B,)).astype(np.int64))
    np.savez(tmp / "params.npz", **{f"denoise_fn/{k}": v for k, v in flat.items()})
    np.savez(tmp / "inputs.npz", **inputs)
    with open(tmp / "hp.json", "w") as f:
        json.dump(php, f)
    common = dict(hp=str(tmp / "hp.json"), params=str(tmp / "params.npz"),
                  inputs=str(tmp / "inputs.npz"))
    cases = [dict(common, name="micro1", kind="denoiser", n_micro=1),
             dict(common, name="micro2", kind="denoiser", n_micro=2),
             dict(common, name="plms", kind="plms", n_micro=2)]
    with open(tmp / "spec.json", "w") as f:
        json.dump(dict(mesh=["pipe", 4, 1], out=str(out_dir), cases=cases), f)
    procs = spawn(tmp / "spec.json", tmp)
    try:
        jnet = JDiffNet(hp=jhp, in_dims=M)
        tree = unflatten_params(flat)
        refs = dict(jax=np.asarray(jax.jit(lambda p, x, t, c: jnet.apply(
            {"params": p}, x, t, cond=c))(tree, inputs["spec"], inputs["t"], inputs["cond"])))
        model = GaussianDiffusion(php, 8, M)
        load_flax_params(model.denoise_fn, flat)
        with torch.no_grad():
            cp = model.denoise_fn.cond_projections(torch.as_tensor(inputs["cond"]))
            x = model.plms_sample_loop(torch.as_tensor(inputs["spec"]), cp, PLMS["K_step"],
                                       PLMS["pndm_speedup"], model.denoise_fn.stack_weights())
        refs["plms"] = model.denorm_spec(x).numpy()
        results = wait(procs, out_dir)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return flat, inputs, refs, results


@pytest.mark.parametrize("n_micro", [1, 2])
def test_pipelined_denoiser_matches_jax_plain_diffnet(env, n_micro):
    """Every rank returns the same noise, JAX's plain DiffNet's within 1e-4."""
    flat, inputs, refs, results = env
    outs = [r[f"micro{n_micro}"] for r in results]
    assert all(np.array_equal(o, outs[0]) for o in outs)
    assert np.abs(refs["jax"]).max() > 1e-3
    np.testing.assert_allclose(outs[0], refs["jax"], atol=1e-4)


def test_plms_through_the_pipeline_matches_the_unsplit_loop(env):
    flat, inputs, refs, results = env
    outs = [r["plms"] for r in results]
    assert all(np.array_equal(o, outs[0]) for o in outs)
    assert max_err(refs["plms"], inputs["spec"]) > 1e-2
    np.testing.assert_allclose(outs[0], refs["plms"], atol=1e-4)


def test_mesh_layout(env):
    for rank, r in enumerate(env[3]):
        assert r["layout"].tolist() == [0, rank, rank]


# ---- without ranks ---------------------------------------------------------------
def test_split_stages_and_cond_projections_as_jax(env):
    flat, inputs, _, _ = env
    tree = unflatten_params(flat)
    shared, blocks = pipeline.split_stages(tree, 4, 2)
    jshared, jblocks = jpipe.split_stages(jax.tree_util.tree_map(jnp.asarray, tree), 4, 2)
    assert len(blocks) == len(jblocks) == 2 and set(shared) == set(jshared)
    assert "input_projection" in shared and "res_0" not in shared
    for got, want in zip(blocks, jblocks):
        for k in ("dilated_conv", "conditioner_projection"):
            assert got[k]["kernel"].shape == want[k]["kernel"].shape
            np.testing.assert_array_equal(got[k]["kernel"], np.asarray(want[k]["kernel"]))
    assert blocks[0]["dilated_conv"]["kernel"].shape == (4, 3, C, 2 * C)
    got = pipeline.cond_projections_stacked(tree, torch.as_tensor(inputs["cond"]), 4)
    want = jpipe.cond_projections_stacked(tree, jnp.asarray(inputs["cond"]), 4)
    assert tuple(got.shape) == (4, 2, B, T, 2 * C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_split_stages_rejects_bad_dilation_split(env):
    """8 layers over 8 stages is one block a stage with cycle 2: the stages
    would run different dilations; refused as JAX refuses it."""
    tree = unflatten_params(env[0])
    with pytest.raises(AssertionError):
        jpipe.split_stages(tree, 8, 2)
    with pytest.raises(AssertionError, match="multiple of dilation_cycle_length=2"):
        pipeline.split_stages(tree, 8, 2)
    _, php = hparams(**NET)
    with pytest.raises(AssertionError, match="multiple of dilation_cycle_length=2"):
        pipeline.stage_layers(php, 8, 0)


def test_stage_loader_refuses_another_stages_keys(env, tmp_path):
    """A stage of layers 2-3 loads the shared projections and its layers
    from the npz (the other layers unread), and refuses a dict holding
    layer 5's keys, and one missing its own."""
    flat = {f"denoise_fn/{k}": v for k, v in env[0].items()}
    np.savez(tmp_path / "p.npz", **flat)
    _, php = hparams(**NET)
    stage = DiffNet(php, M, layers=pipeline.stage_layers(php, 4, 1))
    assert [n for n, _ in stage.named_children() if n.startswith("res_")] == ["res_2", "res_3"]
    pipeline.load_stage_params(stage, str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(stage.res_3.dilated_conv.weight.detach().numpy(),
                                  flat["denoise_fn/res_3/dilated_conv/kernel"].transpose(2, 1, 0))
    own = {k: v for k, v in flat.items() if "/res_" not in k or k.split("/")[1] in
           ("res_2", "res_3")}
    pipeline.load_stage_params(stage, own)
    with pytest.raises(KeyError, match="layer 5, not of this stage's layers \\[2, 3\\]"):
        pipeline.load_stage_params(stage, dict(own, **{
            "denoise_fn/res_5/dilated_conv/bias": flat["denoise_fn/res_5/dilated_conv/bias"]}))
    with pytest.raises(KeyError, match="not filled"):
        pipeline.load_stage_params(stage, {k: v for k, v in own.items() if "res_3" not in k})


def _stack_inputs(seed, L_, C_=C, T_=T, bf16=False):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=g)  # noqa: E731
    args = [torch.relu(r(2, T_, C_)), r(L_, 2, T_, 2 * C_), r(L_, 2, C_, sc=0.5),
            r(L_, 3, C_, 2 * C_, sc=(3 * C_) ** -0.5), r(L_, 2 * C_, sc=0.1),
            r(L_, C_, 2 * C_, sc=C_ ** -0.5), r(L_, 2 * C_, sc=0.1)]
    if bf16:
        for i in (0, 1, 2, 3, 5):
            args[i] = args[i].to(torch.bfloat16)
    return args


def test_write_last_plain_fp32_is_jaxs_block_chain():
    """`residual_stack_plain(write_last=True)`: the skip of the default call,
    bit for bit, and x_last the state after JAX's `_block_fwd` chain
    (`bisinger_tpu/parallel/pipeline.py:104`) within 1e-5, as its skip sum."""
    L_ = 4
    dils = [1, 2, 1, 2]
    x0, cond, step, wd, bd, wo, bo = _stack_inputs(1, L_)
    skip, x_last = diffnet_stack.residual_stack_plain(x0, cond, step, wd, bd, wo, bo, dils,
                                                      write_last=True)
    assert torch.equal(skip, diffnet_stack.residual_stack_plain(x0, cond, step, wd, bd, wo, bo,
                                                                dils))
    h, sk = jnp.asarray(x0.numpy()), 0.0
    for i, d in enumerate(dils):
        # the layer's step projection handed in as the step, through an identity
        p = {"diffusion_projection": {"kernel": jnp.eye(C), "bias": jnp.zeros(C)},
             "dilated_conv": {"kernel": wd[i].numpy(), "bias": bd[i].numpy()},
             "output_projection": {"kernel": wo[i].numpy()[None], "bias": bo[i].numpy()}}
        h, s_ = jpipe._block_fwd(p, h, cond[i].numpy(), step[i].numpy(), d)
        sk = sk + s_
    assert max_err(x_last.numpy(), x0.numpy()) > 1e-2
    np.testing.assert_allclose(x_last.numpy(), np.asarray(h), atol=1e-5)
    np.testing.assert_allclose(skip.numpy(), np.asarray(sk), atol=1e-5)


def test_write_last_plain_bf16_splits_a_stack():
    """The bf16 plain version in two halves with write_last, the first's x_last
    feeding the second: the whole stack's x_last bit for bit, and its skip
    sum within fp32 rounding of the values (the halves' skips are added)."""
    dils = [1, 2, 4, 8] * 2
    x0, cond, step, wd, bd, wo, bo = _stack_inputs(2, 8, bf16=True)
    skip, x_last = diffnet_stack.residual_stack_plain_bf16(x0, cond, step, wd, bd, wo, bo, dils,
                                                           write_last=True)
    assert x_last.dtype == torch.bfloat16
    assert torch.equal(skip, diffnet_stack.residual_stack_plain_bf16(
        x0, cond, step, wd, bd, wo, bo, dils))
    h = x0
    total = 0.0
    for part in (slice(0, 4), slice(4, 8)):
        s, h = diffnet_stack.residual_stack_plain_bf16(
            h, cond[part], step[part], wd[part], bd[part], wo[part], bo[part], dils[part],
            write_last=True)
        total = total + s
    assert torch.equal(h, x_last)
    assert max_err(total.numpy(), skip.numpy()) <= 1e-5 * float(skip.abs().max())
