"""Five training options of the JAX package in the port, on the CPU at tiny
widths: `remat` (each FFT block under torch.utils.checkpoint), `save_best`
(the checkpoints of lowest val_loss), `save_codes` (a copy of the package
in the work dir), `dataloader_prefetch_put: worker` (the copy to the device
on the prefetch thread) and `vocoder_weight_norm: false` (plain kernels in
the GAN step).

With dropout on, the two packages draw their masks from different
generators, so the step against JAX's pins them: every dropout of either
side draws the same mask for an input of the same shape (JAX's
`jax.random.bernoulli`, the port's `Dropout.forward`), from a numpy
generator seeded by the shape. Tolerances are tests/test_torch_training.py's
(losses 1e-5 relative, gradients 1e-4 of the largest) and
tests/test_torch_vocoder.py's for the GAN step.
"""

import copy
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bisinger_tpu.config import load_hparams
from bisinger_tpu.training.checkpoints import CheckpointManager as JCheckpointManager
from bisinger_tpu.training.tasks import AuxDecoderMIDITask as JAux
from bisinger_tpu.training.trainer import device_batch
from bisinger_tpu.training.vocoder_task import HifiGanTask as JHifiGanTask
from bisinger_tpu.training.vocoder_task import GANTrainState
from bisinger_tpu.vocoders.hifigan import flatten_params
from bisinger_tpu_torch.config import make_hparams
from bisinger_tpu_torch.data.dataset import batch_to_device
from bisinger_tpu_torch.data.prefetch import DevicePut
from bisinger_tpu_torch.models import common
from bisinger_tpu_torch.models.common import Dropout, set_dropout_generator
from bisinger_tpu_torch.training.checkpoints import CheckpointManager
from bisinger_tpu_torch.training.tasks import AuxDecoderMIDITask
from bisinger_tpu_torch.training.trainer import Trainer
from bisinger_tpu_torch.training.vocoder_task import HifiGanTask
from bisinger_tpu_torch.training import weight_norm as wn
from bisinger_tpu_torch.weights import export_flax_params

from test_torch_vocoder import GEN, _inputs, _jax_gan_step, _pinned, _trees
from torch_port_helpers import TINY, hparams, max_err, t

torch.set_num_threads(1)

STEP = dict(TINY, dropout=0.1, predictor_dropout=0.0, lr=1e-3, warmup_updates=2,
            decay_steps=2, clip_grad_norm=1.0, bucket_tokens=[16], bucket_frames=[64],
            max_words=16, save_codes=False, use_pitch_embed=False)
VOCAB = 20


def _batch(seed=0):
    r = np.random.RandomState(seed)
    b = dict(txt_tokens=r.randint(1, VOCAB, (2, 16)), mel2ph=np.sort(r.randint(1, 17, (2, 64)), 1),
             spk_ids=np.zeros(2, np.int64), pitch_midi=r.randint(50, 70, (2, 16)),
             midi_dur=r.rand(2, 16).astype(np.float32), is_slur=np.zeros((2, 16), np.int64),
             lang=np.zeros((2, 16), np.int64), speechsing=np.ones(2, np.int64),
             word_boundary=r.randint(0, 2, (2, 16)),
             mels=(r.randn(2, 64, 80) - 3).astype(np.float32))
    b["txt_tokens"][:, -2:] = 0
    b["mel2ph"][:, -4:] = 0
    b["mels"][:, -4:] = 0.0
    return b


def _mask(shape, keep):
    """The pinned dropout mask of an input of `shape`."""
    seed = zlib.crc32(repr(tuple(int(s) for s in shape)).encode())
    return np.random.RandomState(seed).rand(*shape) < keep


def _pin_masks(mp):
    """Both packages' dropouts draw `_mask` of the input's shape."""
    mp.setattr(jax.random, "bernoulli",
               lambda key, p=0.5, shape=None: jnp.asarray(_mask(shape, float(p))))

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        m = torch.as_tensor(_mask(tuple(x.shape), keep), device=x.device)
        return torch.where(m, common.div(x, keep), torch.zeros((), dtype=x.dtype))

    mp.setattr(Dropout, "forward", forward)


def _port_grads(model):
    g = copy.deepcopy(model)
    for p, q in zip(model.parameters(), g.parameters()):
        q.data = torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
    return export_flax_params(g)


# One fp32 FFT-Singer step with remat and dropout on: the port's against
# JAX's `nn.remat` blocks, masks pinned: losses 1e-5 relative, every
# gradient within 1e-4 of the largest
def test_remat_step_matches_jax_remat_with_dropout(monkeypatch):
    hp = dict(STEP, remat=True)
    jhp, php = load_hparams(overrides=hp), make_hparams(hp)
    assert jhp["remat"] and php["remat"]
    batch = _batch()
    jtask = JAux(jhp, VOCAB)
    jbatch = device_batch(batch)
    params = jax.jit(jtask.init_state)(jax.random.PRNGKey(0), jbatch).params
    ptask = AuxDecoderMIDITask(php, VOCAB, device="cpu")
    ptask.load_state({k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()})
    assert ptask.model.encoder.remat and ptask.model.decoder.remat
    _pin_masks(monkeypatch)

    def loss_fn(p):
        ret = jtask._forward(p, jbatch, jax.random.PRNGKey(1), deterministic=False)
        losses = jtask.compute_losses(ret, jbatch)
        return sum(losses.values()), losses

    (total, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    out = ptask.train_step(batch_to_device(batch, "cpu"), torch.Generator().manual_seed(1))
    assert abs(float(out["total_loss"]) - float(total)) <= 1e-5 * abs(float(total))
    for k, v in losses.items():
        assert abs(float(out[k]) - float(v)) <= 1e-5 * max(abs(float(v)), 1e-6), k
    jg = flatten_params(jax.device_get(grads))
    pg = _port_grads(ptask.model)
    gmax = max(float(np.abs(v).max()) for v in jg.values())
    worst = max((max_err(pg[k], jg[k]), k) for k in jg)
    assert worst[0] <= 1e-4 * gmax, (worst, gmax)
    # dropout ran: the same step without it has another loss
    monkeypatch.undo()
    (total0, _), _ = jax.jit(jax.value_and_grad(
        lambda p: (lambda r: (sum(jtask.compute_losses(r, jbatch).values()), 0))(
            jtask._forward(p, jbatch, jax.random.PRNGKey(1), deterministic=True)),
        has_aux=True))(params)
    assert abs(float(total0) - float(total)) > 1e-4 * abs(float(total))


def _port_step(remat, seed=7):
    task = AuxDecoderMIDITask(make_hparams(dict(STEP, remat=remat)), VOCAB, device="cpu")
    torch.manual_seed(0)
    for p in task.model.parameters():
        p.data = 0.1 * torch.randn_like(p)
    gen = torch.Generator().manual_seed(seed)
    out = task.train_step(batch_to_device(_batch(), "cpu"), gen)
    grads = [p.grad.clone() if p.grad is not None else None for p in task.model.parameters()]
    return out, grads, [p.detach().clone() for p in task.model.parameters()], gen.get_state()


# The port's step with remat on and off, its dropout drawn from the step's
# generator: the same losses, gradients, updated parameters and generator
# state after the step (the recompute rewinds the generator to the forward's
# draws, then sets it back), bit for bit
def test_remat_on_and_off_give_the_same_step():
    (o0, g0, p0, s0), (o1, g1, p1, s1) = _port_step(False), _port_step(True)
    assert set(o0) == set(o1)
    assert all(torch.equal(o0[k], o1[k]) for k in o0)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert torch.equal(s0, s1)


# Under remat the recompute in the backward pass draws the forward's masks:
# every mask each dropout module draws is recorded, in the forward pass and
# in the recompute (which runs the layers last first), and each module's
# are equal; a layer without the rewind would draw new ones
def test_remat_recompute_draws_the_forward_masks(monkeypatch):
    drawn = []
    real = Dropout.forward

    def forward(self, x):
        y = real(self, x)
        drawn.append((id(self), (y == 0).clone()))
        return y

    monkeypatch.setattr(Dropout, "forward", forward)
    blocks = common.FFTBlocks(32, 2, 3, 2, use_pos_embed=True, dropout=0.3, remat=True).train()
    gen = torch.Generator().manual_seed(5)
    set_dropout_generator(blocks, gen)
    x = torch.randn(2, 12, 32, requires_grad=True)
    out = blocks(x)
    fwd = drawn[1:]  # the position dropout runs outside the layers
    after_forward = gen.get_state()
    out.square().sum().backward()
    rec = drawn[1 + len(fwd):]
    assert len(fwd) > 2 and len(rec) == len(fwd)
    by_module = lambda part: {m: [d for i, d in part if i == m] for m, _ in part}  # noqa: E731
    f, r = by_module(fwd), by_module(rec)
    assert f.keys() == r.keys() and len(f) >= 2
    assert all(len(f[m]) == len(r[m]) and all(torch.equal(a, b) for a, b in zip(f[m], r[m]))
               for m in f)
    assert any(bool(d.any()) for _, d in rec)
    assert torch.equal(gen.get_state(), after_forward)  # the recompute leaves it as it was


# save_best: after each save of a sequence (a preemption save's 1e30
# sentinel among them, and ties), the steps the port's manager keeps are
# those JAX's orbax manager keeps; the newest save is not always kept, and
# latest_step is the highest kept. Without save_best, the newest.
@pytest.mark.parametrize("save_best", [True, False])
def test_save_best_keeps_what_jax_keeps(tmp_path, save_best):
    seq = [(1, 5.0), (2, 3.0), (3, 4.0), (4, 1e30), (5, 2.0), (6, 2.0), (7, 6.0), (8, 1e30),
           (9, 1.0), (10, 3.0)]
    jm = JCheckpointManager(str(tmp_path / "jax"), max_to_keep=2, save_best=save_best)
    pm = CheckpointManager(str(tmp_path / "port"), max_to_keep=2, save_best=save_best)
    dropped_newest = False
    for step, val in seq:
        jm.save(step, {"a": np.full(3, step, np.float32)}, metrics={"val_loss": val})
        pm.save(step, {"a": np.full(3, step, np.float32)}, {}, torch.zeros(4, dtype=torch.uint8),
                metrics={"val_loss": val})
        assert pm.steps() == list(jm._mgr.all_steps()), (step, pm.steps())
        assert pm.latest_step() == jm.latest_step()
        dropped_newest = dropped_newest or step not in pm.steps()
    assert dropped_newest == save_best
    assert pm.metrics(pm.latest_step()) == {"val_loss": dict(seq)[pm.latest_step()]}


class _Task:
    device = torch.device("cpu")


def _trainer(tmp_path, **over):
    hp = make_hparams(dict(STEP, seed=0, num_ckpt_keep=2, **over))
    return Trainer(_Task(), hp, work_dir=str(tmp_path / "work"))


# save_codes: the trainer copies the package (without its build directory
# and bytecode) into work_dir/codes/<timestamp>/bisinger_tpu_torch; off, no
# copy. Unset, it is on, as JAX's trainer reads it (`hp.get("save_codes",
# True)`).
def test_save_codes_copies_the_package(tmp_path):
    assert "save_codes" not in make_hparams({})  # read where used, as JAX reads it
    hp = make_hparams(dict(STEP, seed=0, num_ckpt_keep=2))
    hp.pop("save_codes")
    Trainer(_Task(), hp, work_dir=str(tmp_path / "default" / "work"))
    assert len(os.listdir(tmp_path / "default" / "work" / "codes")) == 1
    _trainer(tmp_path / "on", save_codes=True)
    codes = tmp_path / "on" / "work" / "codes"
    (stamp,) = os.listdir(codes)
    assert len(stamp) == 14 and stamp.isdigit()
    pkg = codes / stamp / "bisinger_tpu_torch"
    assert (pkg / "training" / "trainer.py").read_text() == open(
        os.path.join(os.path.dirname(common.__file__), "..", "training", "trainer.py")).read()
    assert (pkg / "csrc" / "diffnet_stack_bf16.cu").exists()
    found = {d for _, dirs, _ in os.walk(pkg) for d in dirs}
    assert "_build" not in found and "__pycache__" not in found
    _trainer(tmp_path / "off", save_codes=False)
    assert not (tmp_path / "off" / "work" / "codes").exists()


# dataloader_prefetch_put: the batches the trainer's iterator gives with the
# copy on the prefetch thread ("worker") equal those copied on the training
# thread ("main"), bit for bit, in order; any other value raises
def test_prefetch_put_worker_gives_the_main_batches(tmp_path):
    raw = [_batch(seed) for seed in range(4)]
    got = {}
    for put in ("main", "worker"):
        tr = _trainer(tmp_path / put, dataloader_prefetch_put=put, dataloader_prefetch=2)
        it, prefetcher = tr._train_batches(raw)
        got[put] = [next(it) for _ in raw]
        prefetcher.close()
    for a, b in zip(got["main"], got["worker"]):
        assert set(a) == set(b)
        assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    staged = DevicePut("cpu").stage(raw[0])
    assert staged[1] is None and torch.equal(staged[0]["mels"], got["main"][0]["mels"])
    tr = _trainer(tmp_path / "bad", dataloader_prefetch_put="thread")
    with pytest.raises(ValueError, match="dataloader_prefetch_put"):
        tr._train_batches(raw)


# One fp32 GAN step at vocoder_weight_norm false against JAX's (float64 as in
# tests/test_torch_vocoder.py, draws pinned): the trainable leaves are the
# plain kernels on both sides; losses within 1e-5, every gradient of both
# updates within 1e-4 of that update's largest, the export the plain tree
def test_gan_step_without_weight_norm_matches_jax():
    over = dict(GEN, vocoder_weight_norm=False)
    jhp, php = hparams(**over)
    _, _, gen, disc = _trees("full_band")
    mel, f0, wav, phase, noise = _inputs(11, b=1)
    jtask = JHifiGanTask(jhp)
    assert not jtask.weight_norm
    start = ({k: np.asarray(v) for k, v in flatten_params(jax.device_get(gen)).items()},
             {k: np.asarray(v) for k, v in flatten_params(jax.device_get(disc)).items()})
    mp = pytest.MonkeyPatch()
    try:
        _pinned(mp, phase, noise)
        with jax.enable_x64(True):
            f64 = lambda tree: jax.tree_util.tree_map(  # noqa: E731
                lambda a: jnp.asarray(a, jnp.float64), tree)
            gs = GANTrainState.create(apply_fn=None, params=f64(gen), tx=jtask.gen_tx)
            ds = GANTrainState.create(apply_fn=None, params=f64(disc), tx=jtask.disc_tx)
            batch = f64({"mels": mel, "f0": f0, "wav": wav})
            metrics, dg, gg, _, _ = _jax_gan_step(jtask, gs, ds, batch, jax.random.PRNGKey(1))
    finally:
        mp.undo()
    task = HifiGanTask(php, device="cpu")
    assert not any(k.endswith((".wn_g", ".wn_v")) for k in task.gen_params)
    task.load_flax_trees(*start)
    assert set(task.export_gen_params()) == set(start[0])
    out = task.train_step({"mels": t(mel), "f0": t(f0), "wav": t(wav)}, phase=t(phase),
                          noise=t(noise))
    for k, v in metrics.items():
        assert abs(float(out[k]) - float(v)) <= 1e-5 * abs(float(v)), k
    for jtree, module, params in ((dg, task.disc, task.disc_params),
                                  (gg, task.generator, task.gen_params)):
        jgr = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(jtree)).items()}
        pgr = wn.flax_tree(module, {k: p.grad for k, p in params.items()})
        assert set(jgr) == set(pgr)
        gmax = max(float(np.abs(v).max()) for v in jgr.values())
        worst = max((max_err(pgr[k], jgr[k]), k) for k in jgr)
        assert worst[0] <= 1e-4 * gmax, (worst, gmax)
