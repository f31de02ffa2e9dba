"""The port's acoustic training path against the JAX package, on the CPU at
tiny widths: the schedules, the losses, one train step of each task (loss,
every gradient, the parameters after the clip + AdamW update), gradient
accumulation against optax.MultiSteps, the midi->f0 curriculum, the fs2
warm start, one bf16 diffusion step, the trainer and CLI (binarize, fit,
resume, validate, infer, SIGTERM), and the kernel wrappers' refusal of
autograd.

Both sides get the same batch of a binarized synthetic corpus (10 items,
autocorr f0), the same parameters (JAX's init, with the zero-initialised
DiffNet output projection replaced by noise so that the DiffNet's
gradients are not vacuous), dropout off (rate 0, as JAX's
deterministic=True), and for the diffusion stage JAX's own draws of t and
the noise, split as `DiffSingerMIDITask._forward` and
`GaussianDiffusion.__call__` split the step's key. Tolerances are stated
at each assertion.
"""

import copy
import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bisinger_tpu.config import load_hparams
from bisinger_tpu.data.binarizer import M4SingerBinarizer as JBinarizer
from bisinger_tpu.data.dataset import DataLoader as JDataLoader
from bisinger_tpu.data.dataset import M4SingerDataset as JDataset
from bisinger_tpu.data.synthetic import make_synthetic_corpus
from bisinger_tpu.training import losses as JL
from bisinger_tpu.training.optim import accum_schedule as j_accum
from bisinger_tpu.training.optim import rsqrt_schedule as j_rsqrt
from bisinger_tpu.training.optim import step_decay_schedule as j_step
from bisinger_tpu.training.tasks import AuxDecoderMIDITask as JAux
from bisinger_tpu.training.tasks import DiffSingerMIDITask as JDiff
from bisinger_tpu.training.tasks import TrainState
from bisinger_tpu.training.trainer import device_batch
from bisinger_tpu.utils.text_encoder import build_phone_encoder
from bisinger_tpu.vocoders.hifigan import flatten_params, unflatten_params
from bisinger_tpu_torch.config import load_hparams_json, make_hparams
from bisinger_tpu_torch.data.dataset import batch_to_device
from bisinger_tpu_torch.models.common import Dropout, set_dropout_generator
from bisinger_tpu_torch.ops import diffnet_stack, mrf_stage
from bisinger_tpu_torch.training import losses as L
from bisinger_tpu_torch.training.optim import (
    accum_schedule,
    rsqrt_schedule,
    step_decay_schedule,
)
from bisinger_tpu_torch.training.tasks import AuxDecoderMIDITask, DiffSingerMIDITask
from bisinger_tpu_torch.training.trainer import load_fs2_params
from bisinger_tpu_torch.weights import export_flax_params, load_flax_params

from torch_port_helpers import TINY, max_err

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = dict(
    TINY,
    num_spk=4,
    test_prefixes=["Alto-1#song0"],
    pitch_extractor="autocorr",
    bucket_tokens=[32],
    bucket_frames=[256],
    max_tokens=4000,
    max_sentences=4,
    max_eval_sentences=4,
    max_words=32,
    dropout=0.0,
    predictor_dropout=0.0,
    lr=1e-3,
    warmup_updates=2,
    decay_steps=2,
    clip_grad_norm=1.0,
    log_interval=1,
    val_check_interval=4,
    num_sanity_val_steps=1,
    num_ckpt_keep=2,
    save_codes=False,
    use_pitch_embed=False,
)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A binarized tiny corpus, the JAX hparams and the port's (read from
    the JAX run's config dump, as the port reads a JAX work dir), two
    batches."""
    root = tmp_path_factory.mktemp("train")
    make_synthetic_corpus(str(root / "raw"), n_items=10, seed=0)
    jhp = load_hparams(overrides=dict(TRAIN, raw_data_dir=str(root / "raw"),
                                      raw_json_fn="meta.json",
                                      binary_data_dir=str(root / "binary")))
    JBinarizer(jhp).process()
    with open(root / "config.json", "w") as f:
        json.dump(jhp.to_dict(), f, default=str)
    php = load_hparams_json(str(root / "config.json"))
    vocab = build_phone_encoder(jhp["binary_data_dir"]).vocab_size
    dl = iter(JDataLoader(JDataset(jhp, "train", shuffle=True), jhp, shuffle=True,
                          endless=True))
    batches = [device_batch(next(dl)) for _ in range(2)]
    return dict(root=root, jhp=jhp, php=php, vocab=vocab, batches=batches)


def _with_noisy_out(params, seed=3):
    """JAX params with the DiffNet's zero output projection drawn at random."""
    flat = flatten_params(jax.device_get(params))
    for k in list(flat):
        if k.startswith("denoise_fn/output_projection/"):
            flat[k] = 0.05 * np.random.default_rng(seed).standard_normal(
                flat[k].shape).astype(np.float32)
    return unflatten_params(flat)


_JAX_STEPS = {}


def _jax_step(task, state, batch, rng, **flags):
    """JAX's train step with dropout off: (total, losses, grads, new state).
    Compiled once per task and flags."""
    key = (id(task), tuple(sorted(flags.items())))
    if key not in _JAX_STEPS:
        def step(state, batch, rng):
            def loss_fn(params):
                ret = task._forward(params, batch, rng, deterministic=True, **flags)
                losses = task.compute_losses(ret, batch)
                return sum(losses.values()), losses

            (total, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
            return total, losses, grads, state.apply_gradients(grads=grads)

        _JAX_STEPS[key] = (task, jax.jit(step))
    return _JAX_STEPS[key][1](state, batch, rng)


def _diff_draws(rng, batch, k_step):
    """JAX's t and noise for a diffusion train step keyed by `rng`."""
    _, rng_diff = jax.random.split(rng)
    rng_t, rng_noise = jax.random.split(rng_diff)
    b, tm = batch["mels"].shape[:2]
    t = jax.random.randint(rng_t, (b,), 0, k_step)
    noise = jax.random.normal(rng_noise, (b, tm, batch["mels"].shape[-1]))
    return torch.as_tensor(np.array(t)), torch.as_tensor(np.array(noise))


def _port_grads(model):
    """The parameters' .grad under their flax keys and layouts."""
    g = copy.deepcopy(model)
    for p, q in zip(model.parameters(), g.parameters()):
        q.data = torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
    return export_flax_params(g)


_JAX_PARAMS = {}


def _task_pair(env, jcls, pcls, hp_over=None, noisy=False, seed=0):
    """(JAX task, its TrainState, a port task at the same parameters). The
    parameters of JAX's init are drawn once per class, seed and noise."""
    jhp = env["jhp"] if not hp_over else load_hparams(overrides=dict(TRAIN, **hp_over),
                                                      base=env["jhp"])
    php = env["php"] if not hp_over else make_hparams(dict(env["php"], **hp_over))
    jtask = jcls(jhp, env["vocab"])
    key = (jcls, seed, noisy)
    if key not in _JAX_PARAMS:
        params = jax.jit(jtask.init_state)(jax.random.PRNGKey(seed), env["batches"][0]).params
        _JAX_PARAMS[key] = _with_noisy_out(params) if noisy else params
    state = TrainState.create(apply_fn=jtask.model.apply, params=_JAX_PARAMS[key], tx=jtask.tx)
    ptask = pcls(php, env["vocab"], device="cpu")
    ptask.load_state(_flat(state.params))
    return jtask, state, ptask


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}


def _check_step(jres, ptask, fresh, pout, what):
    """The port's step `pout` (on `ptask`) against JAX's `jres`; `fresh` is a
    port task at the same starting parameters, for the optimizer alone."""
    total, losses, grads, new_state = jres
    # loss: fp32 on both sides, sums in another order: 1e-5 relative
    assert abs(float(pout["total_loss"]) - float(total)) <= 1e-5 * abs(float(total)), what
    for k, v in losses.items():
        assert abs(float(pout[k]) - float(v)) <= 1e-5 * max(abs(float(v)), 1e-6), (what, k)
    jg = flatten_params(jax.device_get(grads))
    pg = _port_grads(ptask.model)
    assert set(jg) == set(pg)
    gmax = max(float(np.abs(v).max()) for v in jg.values())
    # each gradient within 1e-4 of the largest |gradient|
    worst = max((max_err(pg[k], jg[k]), k) for k in jg)
    assert worst[0] <= 1e-4 * gmax, (what, worst, gmax)
    nonzero = [k for k in jg if np.abs(jg[k]).max() > 0]
    assert any(k.startswith(("encoder/", "fs2/encoder/")) for k in nonzero)
    jp = flatten_params(jax.device_get(new_state.params))
    # the clip + AdamW update on the same gradients (JAX's, handed to the
    # port's optimizer): every parameter within 1e-6 of optax's
    g = copy.deepcopy(fresh.model)
    load_flax_params(g, jg)
    for p, q in zip(fresh.model.parameters(), g.parameters()):
        p.grad = q.data.clone()
    fresh.opt.step()
    pf = export_flax_params(fresh.model)
    worst = max((max_err(pf[k], jp[k]), k) for k in jp)
    assert worst[0] <= 1e-6, (what, worst)
    # the port's own step: at step 1, with both moments fresh, the update
    # of an element is lr * u(c * g), u(x) = x / (|x| + 1e-8), c the clip
    # factor; the optimizer being held above, what is left between the two
    # steps is the gradients' difference carried through u, which is steep
    # where |g| is near 0 (a gradient of rounding noise, as the attention key
    # biases' is: softmax ignores a shift of the logits). Each element
    # within 1e-6 of that
    pp = export_flax_params(ptask.model)
    lr, max_norm = ptask.opt.lr_fn(0), ptask.opt.max_norm

    def clip(grads):
        norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in grads.values()))
        return min(1.0, max_norm / norm)

    cj, cp = clip(jg), clip(pg)
    u = lambda x: x / (np.abs(x) + 1e-8)  # noqa: E731
    for k in jp:
        err = np.abs(pp[k].astype(np.float64) - jp[k])
        carried = lr * np.abs(u(cp * pg[k].astype(np.float64)) - u(cj * jg[k].astype(np.float64)))
        assert (err - carried).max() <= 1e-6, (what, k, float((err - carried).max()))
    return jg


def test_schedules_match_jax():
    """Steps 0..50 of both schedules, and the step-decay guard that swaps an
    inherited lr 2.0 for 0.001 but keeps one set on purpose: rtol 1e-6. The
    accumulation factor schedule over updates 0..50: equal."""
    for over in (dict(lr=1.0, warmup_updates=8, hidden_size=256),
                 dict(lr=0.5, warmup_updates=3, hidden_size=32)):
        j, p = j_rsqrt(load_hparams(overrides=over)), rsqrt_schedule(make_hparams(over))
        for s in range(51):
            np.testing.assert_allclose(p(s), float(j(s)), rtol=1e-6)
    for over, want in ((dict(decay_steps=7), 0.001), (dict(decay_steps=7, lr=2.0), 2.0),
                       (dict(decay_steps=5, lr=0.01), 0.01)):
        j, p = j_step(load_hparams(overrides=over)), step_decay_schedule(make_hparams(over))
        np.testing.assert_allclose(p(0), want, rtol=1e-6)
        for s in range(51):
            np.testing.assert_allclose(p(s), float(j(s)), rtol=1e-6)
    # the per-epoch accumulation factors, counted in optimizer updates
    for spec in ({1: 1, 3: 2, "5": 4}, {2: 3}):
        j, p = j_accum(spec, 6), accum_schedule(spec, 6)
        assert [p(u) for u in range(51)] == [int(j(u)) for u in range(51)]
    # the inherited default through a JAX dump: lr 2.0 not explicit -> 0.001
    flagship = load_hparams_json(os.path.join(REPO, "artifacts/flagship/hparams_diff.json"),
                                 {"decay_steps": 3})
    assert "lr" in flagship["_explicit_keys"]
    assert "lr" not in make_hparams()["_explicit_keys"]


def test_losses_match_jax():
    """Each loss on random inputs: within 1e-6 (absolute; the losses are of
    order 0.1 to 1, and SSIM's convolutions sum in another order)."""
    r = np.random.RandomState(0)
    hp = dict(mel_loss="l1:0.5|ssim:0.5", lambda_ph_dur=1.0, lambda_word_dur=1.0,
              lambda_sent_dur=1.0, max_words=8, dur_loss="mse")
    mel_out, target = r.randn(2, 24, 8).astype(np.float32), r.randn(2, 24, 8).astype(np.float32)
    target[:, 20:] = 0
    pl, jl = {}, {}
    L.add_mel_loss(torch.as_tensor(mel_out), torch.as_tensor(target), pl, hp)
    JL.add_mel_loss(jnp.asarray(mel_out), jnp.asarray(target), jl, hp)
    txt = np.zeros((2, 10), np.int64)
    txt[:, :8] = r.randint(1, 20, (2, 8))
    mel2ph = np.zeros((2, 24), np.int64)
    mel2ph[:, :20] = np.sort(r.randint(1, 9, (2, 20)), axis=1)
    dur = r.randn(2, 10).astype(np.float32)
    wdb = r.randint(0, 2, (2, 10))
    is_sil = r.randint(0, 2, (2, 10)).astype(np.float32)
    L.add_dur_loss_midi(torch.as_tensor(dur), torch.as_tensor(mel2ph), torch.as_tensor(txt),
                        torch.as_tensor(wdb), pl, hp)
    JL.add_dur_loss_midi(jnp.asarray(dur), jnp.asarray(mel2ph), jnp.asarray(txt),
                         jnp.asarray(wdb), jl, hp)
    ps, js = {}, {}
    L.add_dur_loss_sil(torch.as_tensor(dur), torch.as_tensor(mel2ph), torch.as_tensor(txt),
                       torch.as_tensor(is_sil), ps, hp)
    JL.add_dur_loss_sil(jnp.asarray(dur), jnp.asarray(mel2ph), jnp.asarray(txt),
                        jnp.asarray(is_sil), js, hp)
    pl.update({f"sil_{k}": v for k, v in ps.items()})
    jl.update({f"sil_{k}": v for k, v in js.items()})
    assert set(pl) == set(jl) == {"l1", "ssim", "pdur", "wdur", "sdur", "sil_pdur",
                                  "sil_wdur", "sil_sdur"}
    for k in jl:
        np.testing.assert_allclose(float(pl[k]), float(jl[k]), rtol=0, atol=1e-6, err_msg=k)
    assert L.parse_mel_loss_spec("l1|ssim:0.25") == JL.parse_mel_loss_spec("l1|ssim:0.25")
    np.testing.assert_allclose(L.ssim(torch.as_tensor(mel_out), torch.as_tensor(target)).numpy(),
                               np.asarray(JL.ssim(jnp.asarray(mel_out), jnp.asarray(target))),
                               atol=1e-6)


@pytest.mark.parametrize("task", ["fs2", "diffusion"])
def test_one_fp32_train_step_matches_jax(env, task):
    """One fp32 step on a real batch: loss 1e-5 relative; every gradient
    within 1e-4 of the largest |gradient|; the parameters after the clip +
    AdamW update within 1e-6 (see `_check_step`)."""
    pair = (JAux, AuxDecoderMIDITask) if task == "fs2" else (JDiff, DiffSingerMIDITask)
    jtask, state, ptask = _task_pair(env, *pair, noisy=task == "diffusion")
    fresh = pair[1](env["php"], env["vocab"], device="cpu")
    fresh.load_state(_flat(state.params))
    pins = {}
    batch = env["batches"][0]
    rng = jax.random.PRNGKey(11)
    jres = _jax_step(jtask, state, batch, rng)
    if task == "diffusion":
        t, noise = _diff_draws(rng, batch, env["jhp"]["K_step"])
        pins = dict(t=t, noise=noise)
    pout = ptask.train_step(batch_to_device(batch, "cpu"), **pins)
    jg = _check_step(jres, ptask, fresh, pout, task)
    if task == "diffusion":
        assert np.abs(jg["denoise_fn/res_0/dilated_conv/kernel"]).max() > 0


def test_accumulation_matches_optax_multisteps(env):
    """accumulate_grad_batches 2 over 4 steps (two batches, alternating):
    the parameters after each step within 1e-6 of JAX's under
    optax.MultiSteps, unchanged after the odd steps."""
    jtask, state, ptask = _task_pair(env, JAux, AuxDecoderMIDITask,
                                     hp_over=dict(accumulate_grad_batches=2))
    assert isinstance(jtask.tx, optax.MultiSteps) or hasattr(state.opt_state, "mini_step")
    before = export_flax_params(ptask.model)
    for i in range(4):
        batch = env["batches"][i % 2]
        state = _jax_step(jtask, state, batch, jax.random.PRNGKey(i))[3]
        ptask.train_step(batch_to_device(batch, "cpu"))
        jp = flatten_params(jax.device_get(state.params))
        pp = export_flax_params(ptask.model)
        worst = max((max_err(pp[k], jp[k]), k) for k in jp)
        assert worst[0] <= 1e-6, (i, worst)
        if i % 2 == 0:
            assert all(np.array_equal(pp[k], before[k]) for k in pp), i
        before = pp
    assert int(state.step) == 4 and ptask.opt.count == 2


def test_switch_midi2f0_flips_at_the_same_step(env):
    """drop_f0 turns on past switch_midi2f0_step in both packages."""
    jtask = JDiff(load_hparams(overrides=dict(TRAIN, switch_midi2f0_step=5),
                               base=env["jhp"]), env["vocab"])
    ptask = DiffSingerMIDITask(make_hparams(dict(env["php"], switch_midi2f0_step=5)),
                               env["vocab"], device="cpu")
    for step in (None, 0, 4, 5, 6, 7, 100):
        assert ptask.step_flags(step) == jtask.step_flags(step)
    assert [ptask.step_flags(s)["drop_f0"] for s in (5, 6)] == [False, True]
    flagship = load_hparams_json(os.path.join(REPO, "artifacts/flagship/hparams_diff.json"))
    assert flagship["switch_midi2f0_step"] == 4320


def test_warm_start_fs2_from_flat_npz(env, tmp_path):
    """The diffusion stage's conditioner takes every fs2 parameter of an
    FFT-Singer model's flat params (the JAX package's warm start) and of the
    fs2/ subtree of a diffusion model's npz; the DiffNet keeps its own. A
    missing path, or a source that matches nothing, raises."""
    jaux, astate, _ = _task_pair(env, JAux, AuxDecoderMIDITask)
    fs2_flat = _flat(astate.params)
    jdiff, dstate, ptask = _task_pair(env, JDiff, DiffSingerMIDITask, noisy=True)
    dstate = jdiff.warm_start_fs2(dstate, jax.device_get(astate.params))
    own = export_flax_params(ptask.model.denoise_fn)
    ptask.warm_start_fs2(fs2_flat)
    want = flatten_params(jax.device_get(dstate.params))
    got = export_flax_params(ptask.model)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert all(np.array_equal(export_flax_params(ptask.model.denoise_fn)[k], v)
               for k, v in own.items())
    other = DiffSingerMIDITask(env["php"], env["vocab"], device="cpu")
    np.savez(tmp_path / "diff.npz", **{f"fs2/{k}": v for k, v in fs2_flat.items()})
    other.warm_start_fs2(*load_fs2_params(str(tmp_path / "diff.npz")))
    assert all(np.array_equal(export_flax_params(other.model.fs2)[k], v)
               for k, v in fs2_flat.items())
    with pytest.raises(FileNotFoundError, match="no such file"):
        load_fs2_params(str(tmp_path / "missing.npz"))
    with pytest.raises(FileNotFoundError, match="no checkpoint dir"):
        load_fs2_params(str(tmp_path / "no_work_dir"))
    with pytest.raises(ValueError, match="no parameter"):
        other.warm_start_fs2({"unrelated/kernel": np.zeros(3)})


def _strict_jit_grad(f, *args):
    """jax.value_and_grad of f compiled without XLA's excess precision, so
    each bf16 value is rounded where its type says."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def test_one_bf16_diffusion_step_matches_jax_bf16(env):
    """compute_dtype bfloat16 on both sides (the flagship's), one diffusion
    step, the JAX side compiled without excess precision. Measured on this
    input, the port in bf16 / the port in fp32 against JAX in bf16:
    - the diffusion loss, relative: 4.6e-6 / 3.9e-5 -> bound 1.5e-5, which
      an fp32 port fails: the forward rounds where flax rounds;
    - every gradient over the largest |gradient|: 2.0e-2 / 7.0e-3 -> bound
      3e-2. This bound does not separate the two: the backward sums of a
      bf16 step are rounded to bf16 in each framework's own way (torch
      accumulates a reduction in fp32), which moves the gradients by one
      to a few bf16 steps (0.4% each) of the duration predictor's, the
      largest; an fp32 port happens to land nearer. It holds the bf16
      backward to a few bf16 steps."""
    over = dict(compute_dtype="bfloat16")
    jtask, state, ptask = _task_pair(env, JDiff, DiffSingerMIDITask, hp_over=over, noisy=True)
    p32 = DiffSingerMIDITask(make_hparams(dict(env["php"], compute_dtype="float32")),
                             env["vocab"], device="cpu")
    p32.load_state(export_flax_params(ptask.model))
    batch = env["batches"][1]
    rng = jax.random.PRNGKey(21)

    def loss_fn(params):
        ret = jtask._forward(params, batch, rng, deterministic=True)
        losses = jtask.compute_losses(ret, batch)
        return sum(losses.values()), losses

    (_, jlosses), jgrads = _strict_jit_grad(jax.value_and_grad(loss_fn, has_aux=True),
                                            state.params)
    jg = flatten_params(jax.device_get(jgrads))
    gmax = max(float(np.abs(v).max()) for v in jg.values())
    t, noise = _diff_draws(rng, batch, env["jhp"]["K_step"])
    jmel = float(jlosses["mel"])
    gaps = {}
    for name, task in (("bf16", ptask), ("fp32", p32)):
        out = task.train_step(batch_to_device(batch, "cpu"), t=t, noise=noise)
        pg = _port_grads(task.model)
        gaps[name] = (abs(float(out["mel"]) - jmel) / abs(jmel),
                      max(max_err(pg[k], jg[k]) for k in jg) / gmax)
    assert gaps["bf16"][0] <= 1.5e-5 and gaps["bf16"][1] <= 3e-2, gaps
    assert gaps["fp32"][0] > 1.5e-5, gaps


def test_dropout_is_seeded_and_keeps_its_rate():
    """The same generator state gives the same masks and the same loss; the
    kept share is 1 - rate within 1%; kept values are scaled by
    1 / (1 - rate); eval mode is the identity."""
    drop = Dropout(0.3).train()
    x = torch.ones(200_000)
    set_dropout_generator(drop, torch.Generator().manual_seed(0))
    a = drop(x)
    set_dropout_generator(drop, torch.Generator().manual_seed(0))
    b = drop(x)
    assert torch.equal(a, b)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.7) < 0.01
    torch.testing.assert_close(a[a != 0], torch.full_like(a[a != 0], 1 / 0.7))
    assert torch.equal(drop.eval()(x), x)
    hp = make_hparams(dict(TRAIN, dropout=0.1, predictor_dropout=0.5, bucket_tokens=[16],
                           bucket_frames=[64]))
    losses = []
    for _ in range(2):
        task = AuxDecoderMIDITask(hp, 20, device="cpu")
        r = np.random.RandomState(0)
        batch = dict(txt_tokens=r.randint(1, 20, (2, 16)), mel2ph=np.sort(
            r.randint(1, 17, (2, 64)), 1), spk_ids=np.zeros(2, np.int64),
            pitch_midi=r.randint(50, 70, (2, 16)), midi_dur=r.rand(2, 16),
            is_slur=np.zeros((2, 16), np.int64), lang=np.zeros((2, 16), np.int64),
            speechsing=np.ones(2, np.int64), word_boundary=r.randint(0, 2, (2, 16)),
            mels=r.randn(2, 64, 80) - 3)
        out = task.train_step(batch_to_device(batch, "cpu"), torch.Generator().manual_seed(7))
        losses.append(float(out["total_loss"]))
    assert losses[0] == losses[1]


def test_duration_predictor_runs_deterministically_in_training(env):
    """JAX's FastSpeech2 calls its duration predictor without `deterministic`
    (`bisinger_tpu/models/fs2.py:203,211`), so its dropout never runs, in
    training too; the port keeps that. With dropout 0 elsewhere and
    predictor_dropout 0.5, a train-mode forward's `dur` equals the eval
    mode's exactly in both packages, and the port's equals JAX's within
    1e-5."""
    over = dict(dropout=0.0, predictor_dropout=0.5)
    jtask, state, ptask = _task_pair(env, JAux, AuxDecoderMIDITask, hp_over=over)
    batch = env["batches"][0]
    forward = jax.jit(lambda p, r, det: jtask._forward(p, batch, r, deterministic=det)["dur"],
                      static_argnums=2)
    jdur = [np.asarray(forward(state.params, jax.random.PRNGKey(i), det))
            for i, det in ((0, False), (1, False), (0, True))]
    assert np.array_equal(jdur[0], jdur[1]) and np.array_equal(jdur[0], jdur[2])
    pb = batch_to_device(batch, "cpu")
    pdur = []
    for mode in ("train", "eval"):
        getattr(ptask.model, mode)()
        set_dropout_generator(ptask.model, torch.Generator().manual_seed(3))
        with torch.no_grad():
            pdur.append(ptask.forward(pb)["dur"].numpy())
    assert np.array_equal(pdur[0], pdur[1])
    assert max_err(pdur[0], jdur[0]) <= 1e-5


def test_kernel_wrappers_refuse_autograd(monkeypatch):
    """K1 and K2, both routes: an input that requires grad under grad mode
    raises (it would cut the graph); under no_grad the same call runs. A
    train step of the PitchExtractor task and of the GAN vocoder task (full
    band and mb4) calls neither kernel's wrapper, which the generator's eval
    mode does."""
    B, T, C, L = 1, 8, 32, 2
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(s, generator=g) for s in ((B, T, C), (L, B, T, 2 * C), (L, B, C),
                                                  (L, 3, C, 2 * C), (L, 2 * C), (L, C, 2 * C),
                                                  (L, 2 * C))]
    b16 = [a.to(torch.bfloat16) if i not in (4, 6) else a for i, a in enumerate(args)]
    for fn, a in ((diffnet_stack.residual_stack, args),
                  (diffnet_stack.residual_stack_bf16, b16)):
        a = [x.clone() for x in a]
        a[3].requires_grad_(True)
        with pytest.raises(RuntimeError, match="requires grad"):
            fn(*a, [1, 2])
        with torch.no_grad():
            assert fn(*a, [1, 2]).shape == (B, T, C)
    rk, rd, F = [3], [[1, 3]], 8
    n_w = 2 * F * F * 3 * 2
    x, w, b = torch.randn(1, 16, F), torch.randn(n_w), torch.zeros(4, F)
    for fn, wd in ((mrf_stage.mrf_stage, torch.float32), (mrf_stage.mrf_stage_bf16,
                                                           torch.bfloat16)):
        xx = x.clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="requires grad"):
            fn(xx, w.to(wd), b, rk, rd)
        with torch.no_grad():
            assert fn(xx, w.to(wd), b, rk, rd).shape == x.shape

    from bisinger_tpu_torch.models import diffnet, hifigan
    from bisinger_tpu_torch.training.tasks import PitchExtractionTask
    from bisinger_tpu_torch.training.vocoder_task import HifiGanTask

    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper was called")

    for mod, names in ((hifigan, ("mrf_stage", "mrf_stage_bf16")),
                       (diffnet, ("residual_stack", "residual_stack_bf16"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    r = np.random.RandomState(0)
    pe = PitchExtractionTask(make_hparams(dict(TRAIN, compute_dtype="bfloat16")), device="cpu")
    mel2ph = np.ones((1, 16), np.int64)
    out = pe.train_step(batch_to_device(dict(
        mels=r.randn(1, 16, 80).astype(np.float32) - 3, mel2ph=mel2ph,
        f0=np.full((1, 16), 7.5, np.float32), uv=np.zeros((1, 16), np.float32)), "cpu"))
    assert np.isfinite(float(out["total_loss"]))
    for over in ({}, dict(vocoder_multiband=4, upsample_rates=[8, 4],
                          upsample_kernel_sizes=[16, 8])):
        voc = HifiGanTask(make_hparams(dict(upsample_initial_channel=16, **over)), device="cpu")
        b = {"mels": torch.randn(1, 8, 80), "f0": torch.full((1, 8), 220.0),
             "wav": 0.1 * torch.randn(1, 8 * 128)}
        assert np.isfinite(float(voc.train_step(b, torch.Generator().manual_seed(0))["gen_loss"]))
        with pytest.raises(AssertionError, match="kernel wrapper"), torch.no_grad():
            voc.generator.eval()(b["mels"], b["f0"], generator=torch.Generator())


def _cli(tmp_path, monkeypatch, *argv):
    from bisinger_tpu_torch import run

    monkeypatch.chdir(tmp_path)
    return run.main(list(argv))


def test_cli_binarize_fit_resume_validate_infer(env, tmp_path, monkeypatch, capsys):
    """--binarize, a 5-step fit of the diffusion stage (latest checkpoint 5),
    a resume to 7, --validate, and --infer from the work dir writing a wav,
    all on the CPU."""
    cfg = dict(env["php"], raw_data_dir=str(env["root"] / "raw"),
               binary_data_dir=str(tmp_path / "binary"), val_check_interval=100,
               task_cls="usr.diffsinger_task.DiffSingerMIDITask", pndm_speedup=20)
    cfg["_explicit_keys"] = sorted(set(cfg["_explicit_keys"]) | {"binary_data_dir"})
    with open(tmp_path / "exp.json", "w") as f:
        json.dump(cfg, f)
    base = ["--config", str(tmp_path / "exp.json"), "--device", "cpu"]
    assert _cli(tmp_path, monkeypatch, *base, "--binarize") == 0
    assert sorted(os.listdir(tmp_path / "binary"))[:2] == ["phone_set.json", "spk_map.json"]
    assert _cli(tmp_path, monkeypatch, *base, "--exp_name", "d", "--max_updates", "5") == 0
    ckpt = tmp_path / "checkpoints" / "d" / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["5"]
    assert _cli(tmp_path, monkeypatch, *base, "--exp_name", "d", "--max_updates", "7") == 0
    out = capsys.readouterr().out
    assert "| resumed from step 5" in out and "| step 7 [tr]" in out
    assert "| step 1 [tr]" in out and "| step 6 [tr]" in out
    assert sorted(os.listdir(ckpt)) == ["5", "7"]
    assert _cli(tmp_path, monkeypatch, *base, "--exp_name", "d", "--validate") == 0
    out = capsys.readouterr().out
    assert "| validating checkpoint at step 7" in out and "| validate: total_loss=" in out
    score = [dict(item_name="demo", text="SP wo ai ni SP", notes="rest | C4 | E4 | G4 | rest",
                  notes_duration="0.1 | 0.2 | 0.2 | 0.3 | 0.1", spk_name="Alto-1")]
    with open(tmp_path / "scores.json", "w") as f:
        json.dump(score, f)
    assert _cli(tmp_path, monkeypatch, "--infer", "--exp_name", "d", "--input", "scores.json",
                "--out", "out", "--device", "cpu") == 0
    from scipy.io import wavfile

    sr, wav = wavfile.read(tmp_path / "out" / "demo.wav")
    assert sr == 24000 and len(wav) > 0 and len(wav) % 128 == 0


def test_sigterm_during_fit_leaves_a_checkpoint(env, tmp_path):
    """A SIGTERM while fit runs: the step it lands in finishes, a checkpoint
    of that step is written, and fit returns before max_updates."""
    from bisinger_tpu_torch.training.trainer import Trainer

    hp = make_hparams(dict(env["php"], val_check_interval=1000, num_sanity_val_steps=0))
    task = AuxDecoderMIDITask(hp, env["vocab"], device="cpu")
    trainer = Trainer(task, hp, str(tmp_path / "w"))
    real_step = task.train_step

    def step_and_signal(*a, **kw):
        out = real_step(*a, **kw)
        if trainer.global_step == 1:  # the second step: send SIGTERM to ourselves
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    task.train_step = step_and_signal
    assert threading.current_thread() is threading.main_thread()
    trainer.fit(max_updates=50)
    assert trainer.global_step == 2
    assert trainer.ckpt.latest_step() == 2
