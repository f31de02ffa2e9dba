"""Long-form synthesis over ranks (`bisinger_tpu_torch/parallel/sequence.py`)
on the CPU: 4 gloo ranks as a ('data' 2, 'seq' 2) mesh, each a process of
its own (`tests/torch_sp_worker.py`, one thread each), TINY widths in fp32.
Each rank holds its row's core frames; the test puts the 4 cores together
and holds them against JAX's unsharded run (cheaper than JAX's own
sharded one, which tests/test_sequence_parallel.py holds to it) and
against the port's unsharded run, at JAX's bounds
(tests/test_sequence_parallel.py): rtol/atol 1e-4 on the mel, 1e-4/1e-5
on the waveform, 1e-4/1e-3 on f0.

  - the task's infer (durations -> PLMS -> mel, `DiffSingerMIDITask.
    infer_step`), JAX's start noise handed to the port;
  - DDPM, DPM-Solver++, the shallow start and the FFT denoiser against the
    port's unsharded run, the start and step noise pinned at the global
    shape;
  - the PE (`predictor_hidden` 32) and the NSF HiFi-GAN of
    `test_longform_vocoder_matches_unsharded`'s overrides (phase and noise
    numpy draws handed to both sides; against JAX at the port's generator
    bound, see the test);
  - with every halo 0 the infer misses its bound (the halo is needed);
    T % seq != 0 raises; the ranks' layout is row-major, as JAX's mesh.

Parameters are drawn on the port's side with flax's initialisers, the
DiffNet's zero output projection replaced by noise.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _batch
from bisinger_tpu.models.hifigan import HifiGanGenerator as JHifiGan
from bisinger_tpu.models.pe import PitchExtractor as JPitchExtractor
from bisinger_tpu.training.tasks import DiffSingerMIDITask as JTask
from bisinger_tpu.vocoders.hifigan import unflatten_params
from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
from bisinger_tpu_torch.models.pe import PitchExtractor
from bisinger_tpu_torch.parallel import sequence
from bisinger_tpu_torch.training.tasks import DiffSingerMIDITask, flax_init_
from bisinger_tpu_torch.weights import export_flax_params, load_flax_params

from torch_port_helpers import TINY, hparams, max_err

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_sp_worker.py")
B, T, VOCAB = 2, 64, 32
N_SEQ, N_DATA = 2, 2
SAMPLERS = {
    "plms": {},
    "ddpm": dict(pndm_speedup=0),
    "dpmpp": dict(diff_sampler="dpmpp", dpm_steps=8),
    "shallow": dict(gaussian_start=False),
    "fft": dict(diff_decoder_type="fft"),
}
VOC = dict(upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8], upsample_initial_channel=16,
           resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]], use_nsf=True,
           hop_size=16, compute_dtype="float32")
PE = dict(predictor_hidden=32, compute_dtype="float32")


def spawn(spec_path, tmp, world=4):
    """The worker ranks of `spec_path`, started at once."""
    init = f"file://{tmp / 'rendezvous'}"
    env = dict(os.environ, WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    return [subprocess.Popen([sys.executable, WORKER, str(spec_path), "--init", init],
                             cwd=tmp, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait(procs, out_dir, timeout=180):
    """Each rank's results, once every rank has ended well."""
    for p in procs:
        try:
            out = p.communicate(timeout=timeout)[0]
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, out[-3000:]
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(len(procs))]


def assemble(parts, scale=1):
    """The ranks' cores [b, c x scale, ...] (rank = d * seq + s) -> [b x data,
    c x scale x seq, ...]."""
    return np.concatenate([np.concatenate(parts[d * N_SEQ:(d + 1) * N_SEQ], axis=1)
                           for d in range(N_DATA)], axis=0)


def _hp(**kw):
    """(JAX's hparams, unsharded; the port's, under the seq axis)."""
    return hparams(**kw)[0], hparams(**dict(kw, sequence_parallel_axis="seq"))[1]


def _diffusion_params(php, seed):
    task = DiffSingerMIDITask(php, VOCAB, device="cpu")
    flat = export_flax_params(task.model)
    for k in [k for k in flat if k.startswith("denoise_fn/output_projection/")]:
        flat[k] = 0.05 * np.random.default_rng(seed).standard_normal(
            flat[k].shape).astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Writes every case's inputs, starts the 4 ranks, and meanwhile runs
    JAX's and the port's unsharded references; returns (cases, refs, the
    ranks' results)."""
    tmp = tmp_path_factory.mktemp("sp")
    out_dir = tmp / "out"
    out_dir.mkdir()
    batch = _batch(B, 16, T, VOCAB)
    rng = jax.random.PRNGKey(0)
    start = np.asarray(jax.random.normal(jax.random.split(rng)[0], (B, T, 80)))
    r = np.random.default_rng(7)
    cases, specs = {}, []

    def case(name, kind, hp, params, inputs, **extra):
        for fn, obj in (("hp", hp), ("params", params), ("inputs", inputs)):
            path = tmp / f"{name}.{fn}.{'json' if fn == 'hp' else 'npz'}"
            if fn == "hp":
                with open(path, "w") as f:
                    json.dump(obj, f)
            else:
                np.savez(path, **obj)
        cases[name] = dict(hp=hp, params=params, inputs=inputs, **extra)
        specs.append(dict(name=name, kind=kind, vocab=VOCAB, hp=str(tmp / f"{name}.hp.json"),
                          params=str(tmp / f"{name}.params.npz"),
                          inputs=str(tmp / f"{name}.inputs.npz"),
                          **{k: v for k, v in extra.items() if k != "jhp"}))

    params = {}
    for name, over in SAMPLERS.items():
        jhp, php = _hp(**over)
        key = "fft" if name == "fft" else "wavenet"
        if key not in params:
            params[key] = _diffusion_params(php, seed=len(params) + 3)
        pins = dict(pin_start_noise=start if name == "plms" else
                    r.standard_normal((B, T, 80)).astype(np.float32))
        if name == "ddpm":
            pins["pin_step_noise"] = r.standard_normal(
                (php["K_step"], B, T, 80)).astype(np.float32)
        case(name, "infer", php, params[key], dict(batch, **pins), jhp=jhp)
    case("plms_halo0", "infer", cases["plms"]["hp"], params["wavenet"], cases["plms"]["inputs"],
         halo0=True)
    jhp, php = _hp(**PE)
    pe = flax_init_(PitchExtractor(php), 11)
    case("pe", "pe", php, export_flax_params(pe),
         dict(mel=np.random.RandomState(0).randn(B, T, 80).astype(np.float32)), jhp=jhp)
    jhp, php = hparams(**VOC)
    gen = flax_init_(HifiGanGenerator(php), 12)
    g = torch.Generator().manual_seed(12)
    for i in range(len(VOC["upsample_rates"])):  # flax's init (flax_init_ leaves them)
        up = getattr(gen, f"up_{i}")
        with torch.no_grad():
            up.weight.copy_(torch.randn(up.weight.shape, generator=g)
                            * (up.weight.shape[0] * up.weight.shape[2]) ** -0.5)
            up.bias.zero_()
    vr = np.random.RandomState(0)
    mel = vr.randn(B, T, 80).astype(np.float32)
    f0 = (np.abs(vr.randn(B, T)).astype(np.float32) * 100 + 100)
    case("vocoder", "vocoder", php, export_flax_params(gen),
         dict(mel=mel, f0=f0, pin_phase=r.uniform(size=(B, 9)).astype(np.float32),
              pin_noise=r.standard_normal((B, T * 16, 9)).astype(np.float32)), jhp=jhp)
    case("uneven", "uneven", php, {}, {})
    case("shard", "shard", php, {}, dict(batch))
    case("groups", "groups", php, {}, {})
    parts = {f"{p}_{fn}": specs[[c["name"] for c in specs].index(n)][fn]
             for p, n in (("model", "plms"), ("pe", "pe"), ("vocoder", "vocoder"))
             for fn in ("hp", "params")}
    case("synthesize", "synthesize", cases["plms"]["hp"], {}, dict(batch), seed=5, **parts)
    spec = tmp / "spec.json"
    with open(spec, "w") as f:
        json.dump(dict(mesh=["seq", N_SEQ, N_DATA], out=str(out_dir), cases=specs), f)
    procs = spawn(spec, tmp)
    try:
        refs = dict(jax=_jax_refs(cases, rng), port=_port_refs(cases))
        results = wait(procs, out_dir)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return cases, refs, results


def _jax_refs(cases, rng):
    """JAX's unsharded infer, PE and vocoder on the same inputs."""
    out = {}
    c = cases["plms"]
    jbatch = {k: jnp.asarray(v) for k, v in c["inputs"].items() if not k.startswith("pin_")}
    task = JTask(c["jhp"], VOCAB)
    jparams = unflatten_params(c["params"])
    out["plms"] = np.asarray(jax.jit(lambda p, b: task.infer_step(p, b, rng)["mel_out"])(
        jparams, jbatch))
    c = cases["pe"]
    flat = c["params"]
    stats = {k for k in flat if k.rsplit("/", 1)[-1] in ("mean", "var")}
    variables = {"params": unflatten_params({k: v for k, v in flat.items() if k not in stats}),
                 "batch_stats": unflatten_params({k: flat[k] for k in stats})}
    pe = JPitchExtractor(hp=c["jhp"])
    out["pe"] = np.asarray(jax.jit(lambda v, m: pe.apply(v, m)["f0_denorm_pred"])(
        variables, c["inputs"]["mel"]))
    c = cases["vocoder"]
    gen = JHifiGan(hp=c["jhp"])
    inp = c["inputs"]
    real = jax.random.uniform, jax.random.normal
    f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
    try:  # the NSF phase and noise: the pinned numpy draws
        jax.random.uniform = lambda key, shape=(), dtype=None, **kw: f64(inp["pin_phase"])
        jax.random.normal = lambda key, shape=(), dtype=None, **kw: f64(inp["pin_noise"])
        # f0 in float64: JAX sums the NSF phase in f0's dtype, the port in
        # fp64 (in fp32 JAX's sum lies 2.1e-4 from both here)
        with jax.enable_x64(True):
            out["vocoder"] = np.asarray(jax.jit(lambda p, m, f: gen.apply(
                {"params": p}, m, f, rngs={"nsf": jax.random.PRNGKey(1)}))(
                    unflatten_params(c["params"]), inp["mel"], f64(inp["f0"])))
    finally:
        jax.random.uniform, jax.random.normal = real
    return out


def _port_refs(cases):
    """The port's unsharded runs of every case (no mesh)."""
    from torch_sp_worker import synthesizer

    out = {}
    with torch.no_grad():
        c = cases["synthesize"]
        svs = synthesizer(dict(c, vocab=VOCAB))
        svs.hp = dict(svs.hp, sequence_parallel_axis="")
        syn = svs.synthesize(c["inputs"], generator=torch.Generator().manual_seed(c["seed"]))
        out["synthesize"] = {k: v.numpy() for k, v in syn.items()}
        for name in SAMPLERS:
            c = cases[name]
            hp = dict(c["hp"], sequence_parallel_axis="")
            task = DiffSingerMIDITask(hp, VOCAB, device="cpu")
            task.load_state(c["params"])
            data = {k: torch.as_tensor(v) for k, v in c["inputs"].items()}
            pins = {k[4:]: data.pop(k) for k in list(data) if k.startswith("pin_")}
            out[name] = task.infer_step(data, **pins)["mel_out"].numpy()
        c = cases["pe"]
        pe = PitchExtractor(c["hp"])
        load_flax_params(pe, c["params"])
        out["pe"] = pe.eval()(torch.as_tensor(c["inputs"]["mel"]))["f0_denorm_pred"].numpy()
        c = cases["vocoder"]
        gen = HifiGanGenerator(c["hp"])
        load_flax_params(gen, c["params"])
        inp = {k: torch.as_tensor(v) for k, v in c["inputs"].items()}
        out["vocoder"] = gen.eval()(inp["mel"], inp["f0"], phase=inp["pin_phase"],
                                    noise=inp["pin_noise"]).numpy()
    return out


# ---- the task's infer, each sampler, the PE and the vocoder -------------------------
def test_longform_infer_matches_jax_unsharded(runs):
    """Durations -> PLMS -> mel on 2 x 2 ranks: JAX's unsharded infer_step
    and the port's within rtol/atol 1e-4."""
    cases, refs, results = runs
    got = assemble([r["plms"] for r in results])
    assert got.shape == refs["jax"]["plms"].shape == (B, T, 80)
    assert np.abs(refs["jax"]["plms"]).max() > 1e-2
    np.testing.assert_allclose(got, refs["jax"]["plms"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, refs["port"]["plms"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["ddpm", "dpmpp", "shallow", "fft"])
def test_longform_samplers_match_unsharded(runs, name):
    """DDPM (40 steps, the step noise pinned at the global shape),
    DPM-Solver++ (8 calls), the shallow start (PLMS) and the FFT denoiser
    (x gathered before each call) on 2 x 2 ranks against the port's
    unsharded run, within rtol/atol 1e-4."""
    cases, refs, results = runs
    got = assemble([r[name] for r in results])
    assert np.abs(refs["port"][name]).max() > 1e-2
    np.testing.assert_allclose(got, refs["port"][name], rtol=1e-4, atol=1e-4)


def test_halo_zero_misses_the_bound(runs):
    """Every halo 0 (the chunk's zero padding reaches the core): the infer
    lies outside the 1e-4 bound of the halo'd run."""
    cases, refs, results = runs
    got = assemble([r["plms_halo0"] for r in results])
    err = max_err(got, refs["port"]["plms"])
    assert err > 1e-4 * (1 + np.abs(refs["port"]["plms"]).max()), err


def test_longform_pe_matches_jax_unsharded(runs):
    cases, refs, results = runs
    got = assemble([r["pe"] for r in results])
    assert np.abs(refs["jax"]["pe"]).max() > 1.0
    np.testing.assert_allclose(got, refs["jax"]["pe"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, refs["port"]["pe"], rtol=1e-4, atol=1e-3)


def test_longform_vocoder_matches_unsharded(runs):
    """The NSF HiFi-GAN with mel, f0 and the harmonic source's window on each
    rank (the phase's running sum carried over the ranks): the port's
    unsharded run within JAX's rtol 1e-4 / atol 1e-5 (measured on the CPU
    3.3e-7 max). JAX's unsharded run differs from the port's unsharded one
    by more than that (9.9e-5 max with JAX's NSF phase summed in float64;
    in fp32 its phase sum adds about 1e-4: the generators' own difference,
    whose parity bound is 1e-4 abs at 2048 samples,
    tests/test_torch_hifigan.py), so the split run is held to JAX's at the
    mel's rtol/atol 1e-4."""
    cases, refs, results = runs
    got = assemble([r["vocoder_split"] for r in results])
    assert got.shape == refs["jax"]["vocoder"].shape == (B, T * 16)
    assert np.abs(refs["jax"]["vocoder"]).max() > 1e-3
    np.testing.assert_allclose(got, refs["port"]["vocoder"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, refs["jax"]["vocoder"], rtol=1e-4, atol=1e-4)


def test_vocoder_run_whole_under_seq(runs):
    """`generate_whole`, the way a PWG or a multiband generator runs under
    seq: every rank's frames and rows gathered, generated whole with the
    draws at the global shape, this rank's samples kept; equal to the
    unsharded run."""
    cases, refs, results = runs
    got = assemble([r["vocoder_whole"] for r in results])
    np.testing.assert_array_equal(got, refs["port"]["vocoder"])


def test_synthesize_over_ranks_matches_one_process(runs):
    """SVSInferTorch.synthesize on every rank with the global batch and a
    generator seeded alike (the start noise, the NSF phase and noise drawn
    at the global shape): each rank's rows and core frames of the mel, f0,
    mel2ph and waveform against one process's run, at JAX's SP bounds."""
    cases, refs, results = runs
    want = refs["port"]["synthesize"]
    got = {k: assemble([r[f"synthesize_{k}"] for r in results]) for k in want}
    np.testing.assert_array_equal(got["mel2ph"], want["mel2ph"])
    np.testing.assert_allclose(got["mel"], want["mel"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["f0"], want["f0"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["wav"], want["wav"], rtol=1e-4, atol=1e-5)
    assert got["wav"].shape == (B, T * 16) and np.abs(want["wav"]).max() > 1e-3


def test_data_helpers_take_the_data_group(runs):
    """all_reduce_sum, all_gather_rows and draw_rows over the mesh's data
    group: ranks {0, 2} and {1, 3} (rank = data x 2 + seq)."""
    cases, refs, results = runs
    for rank, r in enumerate(results):
        s = rank % N_SEQ
        group = [s + 1, s + 3]  # rank + 1 of the two data ranks
        assert r["groups_sum"].tolist() == [sum(group)]
        assert r["groups_rows"].ravel().tolist() == group
        assert r["groups_draw"].tolist() == [2.0 * (rank // N_SEQ), 2.0 * (rank // N_SEQ) + 1]


def test_uneven_frames_raise(runs):
    """T % seq != 0 raises, as JAX's device_put over the seq axis."""
    cases, refs, results = runs
    for r in results:
        assert "do not split evenly over the 2 ranks" in str(r["uneven"])


def test_mesh_layout_and_shard_longform_batch(runs):
    """Ranks lie row-major on the mesh (rank = data index x 2 + seq index),
    as JAX's create_device_mesh orders CPU devices; shard_longform_batch
    gives each its row, its frames widened by the halo asked for (3) within
    the sequence, and every token."""
    cases, refs, results = runs
    batch = cases["shard"]["inputs"]
    for rank, r in enumerate(results):
        d, s = divmod(rank, N_SEQ)
        assert r["layout"].tolist() == [d, s, rank]
        lo, hi = max(0, s * T // 2 - 3), min(T, (s + 1) * T // 2 + 3)
        np.testing.assert_array_equal(r["shard_mels"], batch["mels"][d:d + 1, lo:hi])
        np.testing.assert_array_equal(r["shard_txt_tokens"], batch["txt_tokens"][d:d + 1])
        assert int(r["shard_n_frames"]) == T


# ---- without ranks ---------------------------------------------------------------
def test_halos_at_the_flagship():
    """Each module's halo from the flagship's config: K1's sum of dilations
    (20 layers, cycle 4), the PE's convs, the vocoder's receptive field in
    mel frames; the FFT denoiser has none (it is gathered)."""
    from bisinger_tpu_torch.config import load_hparams_json
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR

    hp = load_hparams_json(os.path.join(FLAGSHIP_DIR, "hparams_diff.json"))
    assert sequence.halo_for(hp, "denoiser") == 75
    assert sequence.halo_for(hp, "pe") == 20
    assert sequence.halo_for(hp, "vocoder") == 16
    assert sequence.halo_for(dict(hp, diff_decoder_type="fft"), "denoiser") is None
    assert sequence.halo_for(dict(hp, ffn_padding="LEFT"), "pe") == 30


def test_an_axis_named_without_a_mesh_raises():
    """`sequence_parallel_axis` set but no mesh entered: no quiet fallback to
    one process; one process is a 1 x 1 mesh, and a mesh larger than the
    ranks raises as JAX's."""
    with pytest.raises(RuntimeError, match="no \\('data', 'seq'\\) mesh is entered"):
        sequence.context({"sequence_parallel_axis": "seq"})
    assert sequence.context({"sequence_parallel_axis": ""}) is None
    with pytest.raises(ValueError, match="Number of ranks 1 must equal"):
        sequence.make_seq_mesh(num_seq=2)
    m = sequence.make_seq_mesh()
    assert m.shape == {"data": 1, "seq": 1} and sequence.time_spec(63, m) == (0, 63)
    with m:
        assert sequence.context({"sequence_parallel_axis": "seq"}) is m
