"""Data-parallel training of the port (`bisinger_tpu_torch/parallel/`)
against JAX's SPMD step on a 2-device `data` mesh, on the CPU: two ranks
over gloo, each a process of its own (`tests/torch_dp_worker.py`, joined
through a `file://` rendezvous in tmp_path, one thread each), TINY widths
in fp32.

  (a) the loaders: the port's `DataLoader(shard_index, num_shards)` yields
      JAX's rows (item names, arrays, the padding to lcm(batch_multiple,
      num_shards)); the device-resident feeder rounds its batch to the
      ranks as JAX's rounds it to the data axis and gathers JAX's rows.
      Decision on the reference's fault (`data/device_corpus.py:110-111`,
      ROADMAP Queue 3): every rank holds the whole corpus and draws the
      global batch's indices from the same seed, then gathers its own rows,
      as JAX's single-process feeder gathers a batch-sharded array; the
      dropped permutation tail stays, as
      tests/test_torch_data.py::test_device_resident_feeder_matches_jax
      holds it.
  (b) one step of AuxDecoderMIDITask, DiffSingerMIDITask (t and noise
      pinned at the global shape) and PitchExtractionTask (dropout masks
      pinned at the global shape) on 2 ranks against JAX's step of the same
      global batch sharded over the mesh: every loss within 1e-5 of its
      value, every gradient within 1e-4 of the largest |gradient|, the
      parameters within 1e-6 beyond what the gradients' difference carries
      through Adam's first step (as tests/test_torch_training.py holds one
      device), the Prenet's running statistics within 1e-6 of max(|value|,
      1); the two ranks' parameters, gradients, buffers and optimizer state
      bit-identical. The batch's halves hold different numbers of valid
      tokens and frames (the two longest train items on rank 0, the two
      shortest on rank 1), so it separates a global masked mean from the
      mean of the ranks' means (the error DistributedDataParallel's
      averaging would make).
  (c) `run`'s trainer on 2 ranks, 3 steps with dropout 0.1, the
      device-resident corpus and 2 mini-steps an update, against 1 process
      on the same global batches; rank 0 alone writes the checkpoint, config.json and the log
      lines; a resume to step 4 through `python -m bisinger_tpu_torch.run`
      on 2 ranks.
  (d) `mesh_shape` as JAX reads it, and no silent fallback: a group that
      cannot form raises, `--binarize` and `--infer` refuse more than one
      rank.

Parameters are drawn with the port's flax-style initialisers, the DiffNet's
zero output projection replaced by noise (tests/test_torch_training.py).
"""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from bisinger_tpu.config import load_hparams as j_load_hparams
from bisinger_tpu.data.dataset import DataLoader as JDataLoader
from bisinger_tpu.data.dataset import M4SingerDataset as JDataset
from bisinger_tpu.data.dataset import collate_batch as j_collate
from bisinger_tpu.data.device_corpus import DeviceResidentFeeder as JFeeder
from bisinger_tpu.parallel import make_mesh, replicate_sharding, shard_batch
from bisinger_tpu.training import tasks as JT
from bisinger_tpu.training.trainer import device_batch
from bisinger_tpu.vocoders.hifigan import flatten_params, unflatten_params
from bisinger_tpu_torch import run
from bisinger_tpu_torch.config import make_hparams
from bisinger_tpu_torch.data.binarizer import binarizer_class
from bisinger_tpu_torch.data.dataset import NON_ARRAY_KEYS, DataLoader, M4SingerDataset
from bisinger_tpu_torch.data.device_corpus import DeviceResidentFeeder
from bisinger_tpu_torch.data.synthetic import make_synthetic_corpus
from bisinger_tpu_torch.parallel import mesh as dp
from bisinger_tpu_torch.training import losses as L
from bisinger_tpu_torch.training import tasks as PT
from bisinger_tpu_torch.training.trainer import Trainer
from bisinger_tpu_torch.utils.text_encoder import build_phone_encoder
from bisinger_tpu_torch.weights import export_flax_params, load_npz

from test_torch_pe_training import _jax_step as _jax_pe_step
from test_torch_pe_training import _masks
from test_torch_training import _diff_draws, _jax_step, _with_noisy_out
from torch_port_helpers import TINY, max_err

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
TRAIN = dict(
    TINY, test_prefixes=["Alto-1#song0"], pitch_extractor="autocorr", bucket_tokens=[32],
    bucket_frames=[512], max_tokens=4000, max_sentences=4, max_eval_sentences=4, max_words=32,
    dropout=0.0, predictor_dropout=0.0, lr=1e-3, warmup_updates=2, decay_steps=2,
    clip_grad_norm=1.0, log_interval=1, val_check_interval=1000, num_sanity_val_steps=1,
    num_ckpt_keep=2, save_codes=False)
PE = dict(lr=1.0, warmup_updates=4, pitch_type="frame", use_uv=True, pitch_loss="l1")
TASKS = ("AuxDecoderMIDITask", "DiffSingerMIDITask", "PitchExtractionTask")


def _pe_batch(seed=0, t=64, pads=(0, 3, 7, 5)):
    """The PitchExtractor's global batch, as tests/test_torch_pe_training.py
    draws its own: log-mels N(-3, 0.5), f0 and uv at random, the last
    `pads[i]` frames of row i padding (the halves' valid frames differ)."""
    r = np.random.default_rng(seed)
    mels = (r.standard_normal((4, t, 80)) * 0.5 - 3).astype(np.float32)
    mel2ph = np.ones((4, t), np.int64)
    for i, n in enumerate(pads):
        mel2ph[i, t - n:] = 0
    mels[mel2ph == 0] = 0.0
    f0 = (7.5 + 0.5 * r.standard_normal((4, t))).astype(np.float32)
    uv = (r.uniform(size=(4, t)) < 0.25).astype(np.float32)
    f0[mel2ph == 0] = 0.0
    return dict(mels=mels, mel2ph=mel2ph, f0=f0, uv=uv)


def _spawn(args, rank, tmp, world=2):
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    return subprocess.Popen([sys.executable] + args, cwd=tmp, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs, timeout=120):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A 12-item synthetic corpus binarized by the port; both packages'
    hparams; the global batch of (b): the two longest train items, then the
    two shortest, collated by JAX's loader."""
    root = tmp_path_factory.mktemp("dp")
    make_synthetic_corpus(str(root / "raw"), n_items=12, seed=0)
    over = dict(TRAIN, raw_data_dir=str(root / "raw"), raw_json_fn="meta.json",
                binary_data_dir=str(root / "binary"))
    php = make_hparams(over)
    binarizer_class("")(php).process()
    jhp = j_load_hparams(overrides=over)
    vocab = build_phone_encoder(php["binary_data_dir"]).vocab_size
    ds = JDataset(jhp, "train", shuffle=False)
    order = np.argsort(ds.sizes, kind="stable")
    batch = device_batch(j_collate([ds[int(i)] for i in (*order[-1:-3:-1], *order[:2][::-1])],
                                   jhp))
    return dict(root=root, over=over, php=php, jhp=jhp, vocab=vocab, batch=batch)


# ---- (a) the loaders -------------------------------------------------------
@pytest.mark.parametrize("batch_multiple,max_sentences", [(2, 4), (3, 4), (1, 3)])
def test_sharded_loader_yields_jax_rows(env, batch_multiple, max_sentences):
    """Each shard of 2 over an epoch and a half: JAX's item names and every
    array equal; the global batch padded to lcm(batch_multiple, 2) rows by
    repeating its last sample."""
    jhp, php = env["jhp"], dict(env["php"], max_sentences=max_sentences)
    jhp = jhp.replace(max_sentences=max_sentences)
    kw = dict(shuffle=True, endless=True, seed=3, batch_multiple=batch_multiple, num_shards=2)
    mult = math.lcm(batch_multiple, 2)
    iters = [(iter(JDataLoader(JDataset(jhp, "train", shuffle=True), jhp, shard_index=s, **kw)),
              iter(DataLoader(M4SingerDataset(php, "train", shuffle=True), php, shard_index=s,
                              **kw))) for s in (0, 1)]
    n_batches = 3 * JDataLoader(JDataset(jhp, "train"), jhp, **kw).batches_per_epoch() // 2 + 1
    padded = 0
    for _ in range(n_batches):
        names = []
        for ji, pi in iters:
            jb, pb = next(ji), next(pi)
            assert jb["item_names"] == pb["item_names"] and jb["nsamples"] == pb["nsamples"]
            names += pb["item_names"]
            jb = device_batch(jb)
            pb = {k: v for k, v in pb.items() if k not in NON_ARRAY_KEYS}
            assert set(jb) == set(pb)
            for k, v in jb.items():
                np.testing.assert_array_equal(np.asarray(v), pb[k], err_msg=k)
        assert len(names) % mult == 0
        real = len(dict.fromkeys(names))
        padded += len(names) - real
        assert all(n == names[real - 1] for n in names[real:])
    assert padded > 0 or mult == 2


def test_device_feeder_rounds_and_gathers_as_jax(env):
    """max_sentences 3 on 2 ranks: both feeders take batches of 4; each
    rank's rows of the first three batches are JAX's global batch's."""
    jhp = env["jhp"].replace(max_sentences=3)
    php = dict(env["php"], max_sentences=3)
    jfeed = JFeeder(JDataset(jhp, "train", shuffle=True), jhp, make_mesh(num_data=2), seed=5)
    feeds = [DeviceResidentFeeder(M4SingerDataset(php, "train", shuffle=True), php, "cpu",
                                  seed=5, shard_index=s, num_shards=2) for s in (0, 1)]
    assert jfeed.batch_size == 4 and all(f.batch_size == 4 for f in feeds)
    for _ in range(3):
        jb = {k: np.asarray(v) for k, v in next(jfeed).items()}
        for s, feed in enumerate(feeds):
            pb = next(feed)
            assert set(pb) == set(jb)
            for k, v in jb.items():
                np.testing.assert_array_equal(pb[k].numpy(), v[2 * s:2 * s + 2], err_msg=k)


# ---- (b) one step on 2 ranks against JAX's SPMD step ------------------------
@pytest.fixture(scope="module")
def two_rank_steps(env, tmp_path_factory):
    """The three tasks' parameters drawn on the port's side, the pinned
    draws, and one step of each on 2 ranks, started at once in two worker
    processes; returns (cases, the workers, their outputs once read)."""
    tmp = tmp_path_factory.mktemp("dp_step")
    batch, vocab = env["batch"], env["vocab"]
    np.savez(tmp / "batch.npz", **{k: np.asarray(v) for k, v in batch.items()})
    rng = jax.random.PRNGKey(17)
    t, noise = _diff_draws(rng, batch, env["jhp"]["K_step"])
    np.savez(tmp / "pins.npz", t=t.numpy(), noise=noise.numpy())
    pe_batch = _pe_batch()
    np.savez(tmp / "pe_batch.npz", **pe_batch)
    masks = np.stack(_masks(5, pe_batch["mels"].shape[:2] + (256,), 3))
    np.savez(tmp / "masks.npz", masks=masks)
    cases = {}
    for name in TASKS:
        php = make_hparams(dict(env["over"], **PE)) if name == "PitchExtractionTask" \
            else env["php"]
        task = PT.task_class(name)(php, device="cpu") if name == "PitchExtractionTask" \
            else PT.task_class(name)(php, vocab, device="cpu")
        params = export_flax_params(task.model)
        if name == "DiffSingerMIDITask":
            params = flatten_params(_with_noisy_out(unflatten_params(params)))
        np.savez(tmp / f"{name}.npz", **params)
        with open(tmp / f"{name}.json", "w") as f:
            json.dump(php, f)
        case = dict(task=name, hp=str(tmp / f"{name}.json"), params=str(tmp / f"{name}.npz"),
                    batch=str(tmp / "batch.npz"), out=str(tmp / name))
        if name == "DiffSingerMIDITask":
            case.update(pins=str(tmp / "pins.npz"), pin_keys=["t", "noise"])
        if name == "PitchExtractionTask":
            case.update(masks=str(tmp / "masks.npz"), batch=str(tmp / "pe_batch.npz"))
        cases[name] = dict(case, lr=task.opt.lr_fn(0), max_norm=task.opt.max_norm,
                           params_flat=params)
    with open(tmp / "spec.json", "w") as f:
        json.dump({"vocab": vocab, "cases": [
            {k: v for k, v in c.items() if k not in ("lr", "max_norm", "params_flat")}
            for c in cases.values()]}, f)
    init = f"file://{tmp / 'rendezvous'}"
    procs = [_spawn([WORKER, "step", str(tmp / "spec.json"), "--init", init], r, tmp)
             for r in (0, 1)]
    state = dict(procs=procs, done=False)

    def results(name):
        if not state["done"]:
            _wait(procs)
            state["done"] = True
        return [dict(np.load(f"{cases[name]['out']}.rank{r}.npz")) for r in (0, 1)]

    yield cases, results, dict(rng=rng, masks=masks, pe_batch=pe_batch)
    for p in procs:
        if p.poll() is None:
            p.kill()


def _jax_spmd_step(env, name, case, pins):
    """JAX's train step of `name` on the global batch sharded over a
    2-device data mesh, from the same parameters: (total, losses, grads,
    new state)."""
    flat = case["params_flat"]
    mesh = make_mesh(num_data=2)
    if name == "PitchExtractionTask":
        jtask = JT.PitchExtractionTask(j_load_hparams(overrides=dict(env["over"], **PE)))
        stats = {k for k in flat if k.rsplit("/", 1)[-1] in ("mean", "var")}
        state = JT.PETrainState.create(
            apply_fn=jtask.model.apply,
            params=unflatten_params({k: v for k, v in flat.items() if k not in stats}),
            batch_stats=unflatten_params({k: flat[k] for k in stats}), tx=jtask.tx)
        batch = pins["pe_batch"]
    else:
        jtask = getattr(JT, name)(env["jhp"], env["vocab"])
        state = JT.TrainState.create(apply_fn=jtask.model.apply,
                                     params=unflatten_params(dict(flat)), tx=jtask.tx)
        batch = env["batch"]
    with mesh:
        state = jax.device_put(state, replicate_sharding(mesh))
        sharded = shard_batch(batch, mesh)
        assert len(sharded["mels"].addressable_shards) == 2
        if name == "PitchExtractionTask":
            return _jax_pe_step(jtask, state, sharded, pins["masks"])
        return _jax_step(jtask, state, sharded, pins["rng"])


@pytest.mark.parametrize("name", TASKS)
def test_two_rank_step_matches_jax_spmd_step(env, two_rank_steps, name):
    cases, results, pins = two_rank_steps
    case = cases[name]
    total, losses, grads, new_state = _jax_spmd_step(env, name, case, pins)
    r0, r1 = results(name)
    # the ranks agree bit for bit: losses, gradients, parameters and the
    # digest of parameters, buffers and optimizer state
    assert set(r0) == set(r1)
    for k in r0:
        assert np.array_equal(r0[k], r1[k]), k
    # every loss within 1e-5 of its value
    want = dict(losses, total_loss=total)
    assert {k[5:] for k in r0 if k.startswith("loss/")} == set(want) | {"grad_norm"}
    for k, v in want.items():
        v = float(v)
        assert abs(float(r0[f"loss/{k}"]) - v) <= 1e-5 * max(abs(v), 1e-6), (name, k)
    # every gradient within 1e-4 of the largest |gradient|
    jg = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(grads)).items()}
    pg = {k[5:]: v for k, v in r0.items() if k.startswith("grad/")}
    assert set(jg) == set(pg)
    gmax = max(float(np.abs(v).max()) for v in jg.values())
    worst = max((max_err(pg[k], jg[k]), k) for k in jg)
    assert worst[0] <= 1e-4 * gmax, (name, worst, gmax)
    # the parameters: within 1e-6 beyond what the gradients' difference
    # carries through Adam's first step (lr * u(c * g), u(x) = x / (|x| +
    # 1e-8), c the clip factor; steep where |g| is rounding noise)
    jp = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(new_state.params)).items()}
    pp = {k[6:]: v for k, v in r0.items() if k.startswith("param/")}

    def clip(g):
        norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))
        return min(1.0, case["max_norm"] / norm) if case["max_norm"] > 0 else 1.0

    cj, cp = clip(jg), clip(pg)
    u = lambda x: x / (np.abs(x) + 1e-8)  # noqa: E731
    for k in jp:
        err = np.abs(pp[k].astype(np.float64) - jp[k])
        carried = case["lr"] * np.abs(u(cp * pg[k].astype(np.float64))
                                      - u(cj * jg[k].astype(np.float64)))
        assert (err - carried).max() <= 1e-6, (name, k, float((err - carried).max()))
    moved = [k for k in jp if not np.array_equal(pp[k], case["params_flat"][k])]
    assert len(moved) > len(jp) // 2
    if name != "PitchExtractionTask":
        return
    # the Prenet's running statistics: the global batch's, within 1e-6 of
    # max(|value|, 1)
    stats = {k: np.asarray(v)
             for k, v in flatten_params(jax.device_get(new_state.batch_stats)).items()}
    assert len(stats) >= 4 and abs(stats["mel_prenet/norm_0/var"] - 1.0).max() > 1e-2
    for k, v in stats.items():
        assert max_err(pp[k], v) <= 1e-6 * max(np.abs(v).max(), 1.0), k


def test_batch_separates_a_global_mean_from_a_mean_of_local_means(env, two_rank_steps):
    """On (b)'s batch and parameters, the FFT-Singer's mel L1: the mean of
    the two halves' own means lies more than 1e-3 (relative) from the
    global masked mean, which the ranks' shares of (b) sum to; the halves
    hold different numbers of valid tokens and frames."""
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in env["batch"].items()}
    assert len(set((batch["txt_tokens"] > 0).reshape(2, -1).sum(1).tolist())) == 2
    assert len(set((batch["mel2ph"] > 0).reshape(2, -1).sum(1).tolist())) == 2
    task = PT.AuxDecoderMIDITask(env["php"], env["vocab"], device="cpu")
    task.load_state(two_rank_steps[0]["AuxDecoderMIDITask"]["params_flat"])
    with torch.no_grad():
        out = task.forward(batch)["mel_out"]
    mels = batch["mels"]
    glob = float(L.mel_l1_loss(out, mels))
    local = [float(L.mel_l1_loss(out[2 * s:2 * s + 2], mels[2 * s:2 * s + 2])) for s in (0, 1)]
    assert abs(np.mean(local) - glob) > 1e-3 * glob, (local, glob)


# ---- (c) run's trainer on 2 ranks against 1 ------------------------------------
def _log_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("| ")]


def test_run_on_two_ranks_matches_one_rank(env, tmp_path, monkeypatch):
    """DiffSingerMIDITask, 3 steps with dropout 0.1 on the device-resident
    corpus (global B=4), accumulating 2 mini-steps an update (optax's
    MultiSteps on the summed gradients): 2 ranks against 1 process. Every
    logged train and
    validation value within 1e-5 of its value; the parameters within 1e-6,
    but the attention key projections' biases: softmax ignores a shift of
    its logits, so their gradient is 0 but for rounding, which Adam turns
    into steps of up to lr (measured 4.7e-6 after 3 steps at lr 1e-3): held
    within the sum of the 3 steps' rates. Rank 0 alone prints the log lines
    and writes config.json and the one checkpoint (step 3); a resume to step
    4 through `python -m bisinger_tpu_torch.run` on 2 ranks."""
    over = dict(env["over"], dropout=0.1, device_resident_corpus=True, max_updates=3,
                accumulate_grad_batches=2)
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(make_hparams(over), f)
    monkeypatch.chdir(tmp_path)
    args = ["--config", "cfg.json", "--device", "cpu", "--max_updates", "3"]
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [_spawn([WORKER, "fit", str(tmp_path / "two"), "--", *args, "--exp_name", "two",
                     "--dist_init", init], r, tmp_path) for r in (0, 1)]
    one = run.trainer_from_args(run.parse_args(args + ["--exp_name", "one"]))
    one.fit(max_updates=3)
    outs = _wait(procs)
    lines = _log_lines(outs[0])
    assert sum("[tr]" in ln for ln in lines) == 3 and sum("[val]" in ln for ln in lines) == 2
    assert not _log_lines(outs[1]), outs[1][-2000:]
    logs = [json.load(open(tmp_path / f"two.rank{r}.json")) for r in (0, 1)]
    assert logs[0]["val"] == logs[1]["val"]
    for part, mine in (("train", [(s, m) for s, _, m in one.train_log]), ("val", one.val_log)):
        assert [s for s, _ in logs[0][part]] == [s for s, _ in mine] and len(mine) in (2, 3)
        for (_, got), (_, want) in zip(logs[0][part], mine):
            for k, v in want.items():
                if k not in ("steps_per_s", "allreduce_ms"):
                    assert abs(got[k] - v) <= 1e-5 * max(abs(v), 1e-6), (part, k, got[k], v)
    work = tmp_path / "checkpoints"
    assert sorted(os.listdir(work / "two" / "ckpt")) == ["3"]
    assert sorted(p for p in os.listdir(work / "two") if p.startswith("config")) == [
        "config.json"]
    a = load_npz(str(work / "one" / "ckpt" / "3" / "params.npz"))
    b = load_npz(str(work / "two" / "ckpt" / "3" / "params.npz"))
    assert set(a) == set(b)
    rates = sum(one.task.opt.lr_fn(s) for s in range(3))
    for k in a:
        bound = rates if k.endswith("k_proj/bias") else 1e-6
        assert max_err(a[k], b[k]) <= bound, (k, max_err(a[k], b[k]))
    # the resume, through the CLI on 2 ranks
    init = f"file://{tmp_path / 'rendezvous_resume'}"
    outs = _wait([_spawn(["-m", "bisinger_tpu_torch.run", "--exp_name", "two", "--device", "cpu",
                          "--max_updates", "4", "--dist_init", init], r, tmp_path)
                  for r in (0, 1)])
    assert "| resumed from step 3" in outs[0] and "| step 4 [tr]" in outs[0]
    assert not _log_lines(outs[1]), outs[1][-2000:]
    assert sorted(os.listdir(work / "two" / "ckpt")) == ["3", "4"]


# ---- (d) mesh_shape, no fallback ------------------------------------------------
def test_mesh_shape_is_read_as_jax_reads_it(env):
    """data -1 is every rank, data N must be the number of ranks, model > 1
    (tensor parallelism) is not ported; the Trainer reads it."""
    assert dp.data_axis_size({"data": -1, "model": 1}, 2) == 2
    assert dp.data_axis_size({"data": 2}, 2) == 2
    assert dp.data_axis_size(None, 1) == 1
    with pytest.raises(ValueError, match="mesh_shape.data=3"):
        dp.data_axis_size({"data": 3, "model": 1}, 2)
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        dp.data_axis_size({"data": -1, "model": 2}, 1)
    task = PT.AuxDecoderMIDITask(env["php"], env["vocab"], device="cpu")
    for shape, err in (({"data": 2, "model": 1}, ValueError),
                       ({"data": 1, "model": 2}, NotImplementedError)):
        with pytest.raises(err):
            Trainer(task, dict(env["php"], mesh_shape=shape), work_dir=str(env["root"] / "m"))


def test_no_silent_fallback(monkeypatch, capsys):
    """Under torchrun's environment for 2 ranks: a group that cannot form
    (no rendezvous address) raises and leaves no group; NCCL on the CPU
    raises; --binarize and --infer refuse to run, naming the flag."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        dp.init_data_parallel("cpu")
    assert not dp.active() and dp.world_size() == 1
    with pytest.raises(ValueError, match="NCCL"):
        dp.init_data_parallel("cpu", "nccl")
    for flag in ("--binarize", "--infer"):
        assert run.main([flag, "--input", "x.json", "--device", "cpu"]) == 2
        assert f"{flag} runs in one process, not on 2 ranks" in capsys.readouterr().err
