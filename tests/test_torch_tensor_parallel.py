"""Tensor parallelism of the port (`bisinger_tpu_torch/parallel/tensor.py`,
the mesh's `model` axis) on the CPU in fp32: 4 gloo ranks, each a process of
its own (`tests/torch_tp_worker.py`, one thread each), started before the
JAX compiles they are held against.

  1.-3. The port's TP DiffNet (4 layers, C=256, dilation cycle 2), NSF
     HiFi-GAN (`upsample_initial_channel` 32, the NSF phase and noise numpy
     draws handed to both sides) and PitchExtractor on a ('data' 2, 'model'
     2) mesh against JAX's forward under `tensor_parallel_shardings` on
     `make_mesh(num_data=4, num_model=2)` of the 8-device CPU mesh, at the
     shapes and bounds of tests/test_multichip.py:92-190 (DiffNet rtol 2e-4
     atol 2e-5; waveform 5e-3 / 5e-4; f0_denorm_pred 2e-4 / 2e-3).
  4. `tensor_parallel_shardings` shards the axis JAX's rule shards for every
     key of the three trees, at model 2 and at model 8, where the axis does
     not divide the generator's narrowest stages.
  5. `SVSInferTorch.synthesize` at TINY widths under `make_mesh(1, 2)`
     against one process, within PERF.md §2's parity bounds (mel 1e-3, f0 1
     Hz, waveform 2e-3).
  6. One train step at mesh_shape {data: 2, model: 2} on the 4 ranks: every
     rank's state identical, and within 1e-6 of the {data: 2, model: 1}
     step (ranks 0 and 1), the data-parallel step that
     tests/test_torch_data_parallel.py holds against JAX's SPMD step.

Parameters are drawn on the port's side with flax's initialisers
(`flax_init_`), the zero-initialised output projections replaced by noise.
"""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _batch
from bisinger_tpu.models.diffnet import DiffNet as JDiffNet
from bisinger_tpu.models.hifigan import HifiGanGenerator as JHifiGan
from bisinger_tpu.models.pe import PitchExtractor as JPitchExtractor
from bisinger_tpu.parallel import make_mesh as j_make_mesh
from bisinger_tpu.parallel import tensor_parallel_shardings as j_shardings
from bisinger_tpu.vocoders.hifigan import unflatten_params
from bisinger_tpu_torch.inference.pipeline import make_batch
from bisinger_tpu_torch.models.diffnet import DiffNet
from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
from bisinger_tpu_torch.models.pe import PitchExtractor
from bisinger_tpu_torch.parallel import mesh as dp
from bisinger_tpu_torch.parallel import tensor
from bisinger_tpu_torch.training.tasks import DiffSingerMIDITask, PitchExtractionTask, flax_init_
from bisinger_tpu_torch.weights import export_flax_params, flax_shapes

from torch_port_helpers import hparams, max_err

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_tp_worker.py")
WORLD, VOCAB, B, T = 4, 32, 2, 64
DIFFNET = dict(residual_layers=4, residual_channels=256, dilation_cycle_length=2,
               compute_dtype="float32")
VOC = dict(upsample_initial_channel=32, use_nsf=True, compute_dtype="float32")
TRAIN = dict(dropout=0.1, lr=1e-3, warmup_updates=2, decay_steps=2, clip_grad_norm=1.0)
TASKS = ("DiffSingerMIDITask", "PitchExtractionTask")


def _noisy(flat, prefix, seed):
    for k in [k for k in flat if k.startswith(prefix)]:
        flat[k] = 0.05 * np.random.default_rng(seed).standard_normal(
            flat[k].shape).astype(np.float32)
    return flat


def _generator_params(php, seed):
    gen = flax_init_(HifiGanGenerator(php), seed)
    g = torch.Generator().manual_seed(seed)
    for i in range(len(php["upsample_rates"])):  # flax's init (flax_init_ leaves them)
        up = getattr(gen, f"up_{i}")
        with torch.no_grad():
            up.weight.copy_(torch.randn(up.weight.shape, generator=g)
                            * (up.weight.shape[0] * up.weight.shape[2]) ** -0.5)
            up.bias.zero_()
    return export_flax_params(gen)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Writes every case, starts the 4 ranks, and meanwhile runs JAX's TP
    forwards and the port's one-process synthesize; returns (cases, refs,
    the ranks' results)."""
    tmp = tmp_path_factory.mktemp("tp")
    out_dir = tmp / "out"
    out_dir.mkdir()
    r = np.random.RandomState(0)
    cases, specs = {}, []

    def write(name, obj):
        path = tmp / name
        if name.endswith(".json"):
            with open(path, "w") as f:
                json.dump(obj, f)
        else:
            np.savez(path, **obj)
        return str(path)

    def case(name, kind, hp, params, inputs, jhp=None, **extra):
        cases[name] = dict(hp=hp, params=params, inputs=inputs, jhp=jhp, **extra)
        specs.append(dict(name=name, kind=kind, hp=write(f"{name}.hp.json", hp),
                          params=write(f"{name}.params.npz", params),
                          inputs=write(f"{name}.inputs.npz", inputs), **extra))

    jhp, php = hparams(**DIFFNET)
    params = _noisy(export_flax_params(flax_init_(DiffNet(php), 3)), "output_projection/", 4)
    case("diffnet", "diffnet", php, params,
         dict(spec=r.randn(2, 64, 80).astype(np.float32),
              cond=r.randn(2, 64, php["hidden_size"]).astype(np.float32),
              t=np.array([3, 7], np.int64)), jhp)
    jhp, php = hparams(**VOC)
    mel = r.randn(2, 24, 80).astype(np.float32)
    case("vocoder", "vocoder", php, _generator_params(php, 5),
         dict(mel=mel, f0=(r.rand(2, 24) * 200 + 100).astype(np.float32),
              pin_phase=r.uniform(size=(2, 9)).astype(np.float32),
              pin_noise=r.standard_normal((2, 24 * 128, 9)).astype(np.float32)), jhp)
    case("pe", "pe", php, export_flax_params(flax_init_(PitchExtractor(php), 6)),
         dict(mel=mel), jhp)
    # 5: the TINY cascade, as tests/test_torch_sequence_parallel.py builds it
    _, thp = hparams()
    model_params = _noisy(export_flax_params(DiffSingerMIDITask(thp, VOCAB, device="cpu").model),
                          "denoise_fn/output_projection/", 7)
    _, voc_hp = hparams(upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
                        upsample_initial_channel=16, resblock_kernel_sizes=[3, 5],
                        resblock_dilation_sizes=[[1, 3], [1, 3]], hop_size=16)
    parts = dict(model_hp=write("syn_model.hp.json", thp),
                 model_params=write("syn_model.npz", model_params),
                 pe_hp=write("syn_pe.hp.json", thp),
                 pe_params=write("syn_pe.npz", export_flax_params(
                     flax_init_(PitchExtractor(thp), 8))),
                 vocoder_hp=write("syn_voc.hp.json", voc_hp),
                 vocoder_params=write("syn_voc.npz", _generator_params(voc_hp, 9)))
    batch = _batch(B, 16, T, VOCAB)
    specs.append(dict(name="synthesize", kind="synthesize", vocab=VOCAB, seed=5,
                      inputs=write("syn_batch.npz", batch), **parts))
    cases["synthesize"] = dict(batch=batch, vocab=VOCAB, seed=5, **parts)
    # 6: the train steps
    train_hp, train_params, start = {}, {}, {}
    for name in TASKS:
        _, hp = hparams(**TRAIN)
        task = PitchExtractionTask(hp, device="cpu") if name == "PitchExtractionTask" else \
            DiffSingerMIDITask(hp, VOCAB, device="cpu")
        flat = export_flax_params(task.model)
        if name == "DiffSingerMIDITask":
            flat = _noisy(flat, "denoise_fn/output_projection/", 10)
        train_hp[name] = write(f"{name}.hp.json", hp)
        train_params[name], start[name] = write(f"{name}.npz", flat), flat
    cases["train"] = dict(params=start)
    specs.append(dict(name="train", kind="train", vocab=VOCAB, seed=11, tasks=list(TASKS),
                      work_dir=str(tmp / "work"),
                      hp=train_hp, params=train_params,
                      batch=write("train_batch.npz", make_batch(4, 16, T, VOCAB, seed=3,
                                                                targets=True))))
    spec_path = write("spec.json", dict(out=str(out_dir), cases=specs))
    init = f"file://{tmp / 'rendezvous'}"
    env = dict(os.environ, WORLD_SIZE=str(WORLD), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    procs = [subprocess.Popen([sys.executable, WORKER, spec_path, "--init", init], cwd=tmp,
                              env=dict(env, RANK=str(k), LOCAL_RANK=str(k)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k in range(WORLD)]
    try:
        refs = dict(jax=_jax_refs(cases), port=_port_synthesize(cases["synthesize"]))
        results = []
        for p in procs:
            out = p.communicate(timeout=240)[0]
            assert p.returncode == 0, out[-3000:]
        results = [dict(np.load(out_dir / f"rank{k}.npz")) for k in range(WORLD)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return cases, refs, results


def _jax_refs(cases):
    """JAX's forwards with the params placed by its tensor_parallel_shardings
    on the ('data' 4, 'model' 2) CPU mesh."""
    mesh = j_make_mesh(num_data=4, num_model=2)
    out = {}
    c = cases["diffnet"]
    params = unflatten_params(c["params"])
    model = JDiffNet(hp=c["jhp"], in_dims=80)
    sh = j_shardings(params, mesh)
    assert not sh["res_0"]["dilated_conv"]["kernel"].is_fully_replicated
    inp = c["inputs"]
    with mesh:
        out["diffnet"] = np.asarray(jax.jit(
            lambda p, s, t, cond: model.apply({"params": p}, s, t, cond=cond))(
                jax.device_put(params, sh), inp["spec"], inp["t"], inp["cond"]))
    c = cases["vocoder"]
    params = unflatten_params(c["params"])
    gen, inp = JHifiGan(hp=c["jhp"]), c["inputs"]
    sh = j_shardings(params, mesh)
    assert not sh["res_0_0"]["conv1_0"]["kernel"].is_fully_replicated
    real = jax.random.uniform, jax.random.normal
    f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
    try:  # the NSF phase and noise: the pinned numpy draws
        jax.random.uniform = lambda key, shape=(), dtype=None, **kw: f64(inp["pin_phase"])
        jax.random.normal = lambda key, shape=(), dtype=None, **kw: f64(inp["pin_noise"])
        # f0 in float64: JAX sums the NSF phase in f0's dtype, the port in fp64
        with jax.enable_x64(True), mesh:
            out["vocoder"] = np.asarray(jax.jit(lambda p, m, f: gen.apply(
                {"params": p}, m, f, jax.random.PRNGKey(1)))(
                    jax.device_put(params, sh), inp["mel"], f64(inp["f0"])))
    finally:
        jax.random.uniform, jax.random.normal = real
    c = cases["pe"]
    flat = c["params"]
    stats = {k for k in flat if k.rsplit("/", 1)[-1] in ("mean", "var")}
    params = unflatten_params({k: v for k, v in flat.items() if k not in stats})
    batch_stats = unflatten_params({k: flat[k] for k in stats})
    pe = JPitchExtractor(hp=c["jhp"])
    sh = j_shardings(params, mesh)
    assert not sh["mel_prenet"]["conv_0"]["kernel"].is_fully_replicated
    with mesh:
        out["pe"] = np.asarray(jax.jit(lambda p, m: pe.apply(
            {"params": p, "batch_stats": batch_stats}, m, deterministic=True)[
                "f0_denorm_pred"])(jax.device_put(params, sh), c["inputs"]["mel"]))
    return out


def _port_synthesize(c):
    from torch_sp_worker import synthesizer

    with torch.no_grad():
        svs = synthesizer(c)
        res = svs.synthesize(c["batch"], generator=torch.Generator().manual_seed(c["seed"]))
    return {k: v.numpy() for k, v in res.items()}


# ---- 1-3: the sharded modules against JAX's TP forward ----------------------------
@pytest.mark.parametrize("name,rtol,atol", [("diffnet", 2e-4, 2e-5), ("vocoder", 5e-3, 5e-4),
                                            ("pe", 2e-4, 2e-3)])
def test_tp_module_matches_jax_tp_forward(runs, name, rtol, atol):
    """Each model group of the ('data' 2, 'model' 2) mesh on the same inputs:
    JAX's TP forward within its own TP test's bounds; the two model ranks of
    a group bit-identical, and neither calls K1 or K2."""
    cases, refs, results = runs
    want = refs["jax"][name]
    assert np.abs(want).max() > (1.0 if name == "pe" else 1e-2)
    for r in results:
        np.testing.assert_allclose(r[name], want, rtol=rtol, atol=atol)
        assert r[f"{name}_kernel_calls"].tolist() == [0, 0]
    for d in (0, 2):
        np.testing.assert_array_equal(results[d][name], results[d + 1][name])


# ---- 4: the rules against JAX's -----------------------------------------------------
def _jax_axis(sharding):
    spec = tuple(sharding.spec)
    return spec.index("model") if "model" in spec else None


@pytest.mark.parametrize("num_data,num_model", [(4, 2), (1, 8)])
def test_shardings_pick_jax_axes(num_data, num_model):
    """For every key of the DiffNet, HiFi-GAN and PE trees, the axis the
    port's rule shards is JAX's; at model 8 the rule drops where the axis
    does not divide the dim (the generator's 4- and 2-channel stages)."""
    mesh = j_make_mesh(num_data=num_data, num_model=num_model)
    port_mesh = types.SimpleNamespace(shape={"data": num_data, "model": num_model})
    _, dhp = hparams(**DIFFNET)
    _, vhp = hparams(**VOC)
    sharded = {}
    for module in (DiffNet(dhp), HifiGanGenerator(vhp), PitchExtractor(vhp)):
        shapes = {k: v for k, v in flax_shapes(module).items()
                  if k.rsplit("/", 1)[-1] not in ("mean", "var")}
        zeros = unflatten_params({k: np.broadcast_to(np.float32(0), s)
                                  for k, s in shapes.items()})
        jflat = dict(jax.tree_util.tree_flatten_with_path(j_shardings(zeros, mesh))[0])
        want = {"/".join(str(getattr(p, "key", p)) for p in path): _jax_axis(s)
                for path, s in jflat.items()}
        got = {k: tensor.sharded_axis(v)
               for k, v in tensor.tensor_parallel_shardings(shapes, port_mesh).items()}
        assert got == want, {k: (got[k], want.get(k)) for k in got if got[k] != want.get(k)}
        sharded.update(got)
    assert sharded["res_0/dilated_conv/kernel"] == 2
    assert sharded["res_0/output_projection/kernel"] == 1
    assert sharded["mel_prenet/conv_0/kernel"] == 2
    assert sharded["pitch_predictor/conv_0/Conv_0/kernel"] == 2
    narrow = sharded["res_2_0/conv1_0/kernel"]  # 4 channels
    assert narrow == (2 if num_model == 2 else None)


# ---- 5: synthesize under make_mesh(1, 2) -----------------------------------------------
def test_synthesize_on_a_model_mesh_matches_one_process(runs):
    """Ranks 0 and 1 under make_mesh(num_data=1, num_model=2), the same batch
    and generator seed: each returns the whole mel, f0, mel2ph and waveform,
    the two bit-identical, within the parity bounds of one process's run."""
    cases, refs, results = runs
    want = refs["port"]
    for r in results[:2]:
        got = {k[len("synthesize_"):]: v for k, v in r.items() if k.startswith("synthesize_")}
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["mel2ph"], want["mel2ph"])
        assert max_err(got["mel"], want["mel"]) <= 1e-3
        assert max_err(got["f0"], want["f0"]) <= 1.0
        assert max_err(got["wav"], want["wav"]) <= 2e-3
        assert got["wav"].shape == (B, T * 16) and np.abs(want["wav"]).max() > 1e-3
    for k in ("mel", "f0", "wav"):
        np.testing.assert_array_equal(results[0][f"synthesize_{k}"],
                                      results[1][f"synthesize_{k}"])
    assert not any(k.startswith("synthesize_") for r in results[2:] for k in r)


# ---- 6: the trainer's mesh ---------------------------------------------------------------
@pytest.mark.parametrize("name", TASKS)
def test_train_step_on_a_model_mesh_matches_data_parallel(runs, name):
    """{data: 2, model: 2}: the four ranks' states (parameters, buffers,
    optimizer, generator) bit-identical; the parameters and the PE's running
    statistics within 1e-6 of the {data: 2, model: 1} step's, which moved
    them."""
    cases, refs, results = runs
    tag22, tag21 = f"{name}_2x2", f"{name}_2x1"
    digests = {str(r[f"{tag22}_digest"]) for r in results}
    assert len(digests) == 1
    assert str(results[0][f"{tag21}_digest"]) == str(results[1][f"{tag21}_digest"])
    assert not any(k.startswith(tag21) for r in results[2:] for k in r)
    got = {k[len(tag22) + 7:]: v for k, v in results[0].items() if k.startswith(tag22 + "_param/")}
    want = {k[len(tag21) + 7:]: v for k, v in results[0].items()
            if k.startswith(tag21 + "_param/")}
    assert set(got) == set(want) and len(got) > 10
    start = cases["train"]["params"][name]
    assert sum(not np.array_equal(want[k], start[k]) for k in want) > len(want) // 2
    for k in want:
        assert max_err(got[k], want[k]) <= 1e-6, k


def test_mesh_layout_is_row_major(runs):
    """rank = data index x 2 + model index, as JAX's create_device_mesh
    orders CPU devices; a Trainer under mesh_shape {data: -1, model: 2}
    shards the batch over the 2 data indices."""
    cases, refs, results = runs
    for k, r in enumerate(results):
        assert r["layout"].tolist() == [k // 2, k % 2, k]
        assert r["trainer_shards"].tolist() == [2, k // 2, 2, 2]


def test_model_axis_sizes_as_jax():
    """make_mesh's sizes (data -1: every remaining rank), and mesh_shape as
    the trainer reads it: data x model must be the number of ranks."""
    m = tensor.make_mesh()
    assert m.shape == {"data": 1, "model": 1} and tensor.context() is None
    with m:
        assert tensor.context() is None  # a model axis of 1 runs unsharded
    with pytest.raises(ValueError, match="Number of ranks 1"):
        tensor.make_mesh(num_data=1, num_model=2)
    assert dp.data_axis_size({"data": -1, "model": 2}, 4) == 2
    assert dp.data_axis_size({"data": 2, "model": 2}, 4) == 2
    for shape in ({"data": -1, "model": 3}, {"data": 2, "model": 2}):
        with pytest.raises(ValueError):
            dp.data_axis_size(shape, 2)
