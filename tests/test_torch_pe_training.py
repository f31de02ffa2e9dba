"""The port's PitchExtractor training against the JAX package, on the CPU:
the Prenet's train-mode BatchNorm (flax's batch statistics, in fp32 from a
bf16 input too), the f0 loss, one train step of `PitchExtractionTask`
(loss, every gradient, the parameters after clip + AdamW, the BatchNorm
statistics), and the CLI: binarize, train, resume, validate, the exported
pe_params.npz / pe_batch_stats.npz loaded by the serving path.

The PE is the flagship's (hidden 256, fixed in the model) in fp32 on both
sides. Its pitch predictor's dropout (rate 0.5, flax's `deterministic=False`
in a train step) draws the same numpy masks on both sides: a flax method
interceptor on the JAX side, the port's Dropout modules' forward on the
port side. Tolerances are stated at each assertion.
"""

import copy
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bisinger_tpu.training import losses as JL
from bisinger_tpu.training.tasks import PitchExtractionTask as JPETask
from bisinger_tpu.vocoders.hifigan import flatten_params
from bisinger_tpu_torch.models import common
from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
from bisinger_tpu_torch.training import losses as L
from bisinger_tpu_torch.training.tasks import PitchExtractionTask, task_class
from bisinger_tpu_torch.weights import export_flax_params, load_flax_params

from torch_port_helpers import hparams, max_err, t

B, T = 2, 32


# ---- BatchNorm in training, the f0 loss -----------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_batch_norm_matches_flax(dtype):
    """flax's nn.BatchNorm(momentum=0.9, epsilon=1e-5) in training against
    `common.batch_norm(..., use_running_average=False)` on [B, T, C] with
    padding frames (which count in the statistics): the output and the
    updated running mean and variance within 1e-6 of the largest. From a
    bf16 input (the PE's convs run in compute_dtype) both take the
    statistics in fp32."""
    r = np.random.default_rng(0)
    x = (r.standard_normal((B, T, 16)) * 2 + 0.5).astype(np.float32)
    x[:, -5:] = 0.0
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x, jdt)
    scale = (1 + 0.1 * r.standard_normal(16)).astype(np.float32)
    bias = (0.1 * r.standard_normal(16)).astype(np.float32)
    mean0 = (0.1 * r.standard_normal(16)).astype(np.float32)
    var0 = r.uniform(0.5, 2.0, 16).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    ref, upd = bn.apply(variables, xj, mutable=["batch_stats"])
    port = torch.nn.BatchNorm1d(16, eps=1e-5)
    with torch.no_grad():
        port.weight.copy_(t(scale))
        port.bias.copy_(t(bias))
        port.running_mean.copy_(t(mean0))
        port.running_var.copy_(t(var0))
    xt = t(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = common.batch_norm(port, xt, use_running_average=False)
    assert got.dtype == torch.float32
    rel = lambda a, b: max_err(a, b) / float(np.abs(np.asarray(b, np.float32)).max())  # noqa
    assert rel(got.detach().numpy(), np.asarray(ref, np.float32)) <= 1e-6
    assert rel(port.running_mean.numpy(), upd["batch_stats"]["mean"]) <= 1e-6
    assert rel(port.running_var.numpy(), upd["batch_stats"]["var"]) <= 1e-6
    # the biased variance (torch's own BatchNorm1d would store the unbiased)
    batch_var = x.reshape(-1, 16).astype(np.float64).var(0)
    if dtype == "float32":
        np.testing.assert_allclose(port.running_var.numpy(), 0.9 * var0 + 0.1 * batch_var,
                                   rtol=1e-5)


@pytest.mark.parametrize("pitch_loss,use_uv", [("l1", True), ("l2", True), ("l1", False)])
def test_f0_loss_matches_jax(pitch_loss, use_uv):
    """add_f0_loss (uv BCE on the non-padding frames, f0 error on the voiced
    ones) and the BCE itself: within 1e-6."""
    r = np.random.default_rng(1)
    pred = r.standard_normal((B, T, 2)).astype(np.float32) * 3
    f0 = (7 + r.standard_normal((B, T))).astype(np.float32)
    uv = (r.uniform(size=(B, T)) < 0.3).astype(np.float32)
    nonpad = np.ones((B, T), np.float32)
    nonpad[:, -6:] = 0
    hp = dict(use_uv=use_uv, pitch_loss=pitch_loss, lambda_uv=1.0, lambda_f0=0.7)
    jl, pl = {}, {}
    JL.add_f0_loss(jnp.asarray(pred), jnp.asarray(f0), jnp.asarray(uv), jnp.asarray(nonpad), jl,
                   hp)
    L.add_f0_loss(t(pred), t(f0), t(uv), t(nonpad), pl, hp)
    assert set(jl) == set(pl) == ({"uv", "f0"} if use_uv else {"f0"})
    for k in jl:
        assert abs(float(pl[k]) - float(jl[k])) <= 1e-6, k
    np.testing.assert_allclose(
        L.binary_cross_entropy_with_logits(t(pred[..., 1]), t(uv)).numpy(),
        np.asarray(JL.binary_cross_entropy_with_logits(jnp.asarray(pred[..., 1]),
                                                       jnp.asarray(uv))), atol=1e-6)


# ---- one train step ----------------------------------------------------------
def _batch(seed=0):
    r = np.random.default_rng(seed)
    mels = (r.standard_normal((B, T, 80)) * 0.5 - 3).astype(np.float32)
    mel2ph = np.ones((B, T), np.int64)
    mel2ph[0, -7:] = 0
    mels[mel2ph == 0] = 0.0
    f0 = (7.5 + 0.5 * r.standard_normal((B, T))).astype(np.float32)
    uv = (r.uniform(size=(B, T)) < 0.25).astype(np.float32)
    f0[mel2ph == 0] = 0.0
    return dict(mels=mels, mel2ph=mel2ph, f0=f0, uv=uv)


def _masks(n, shape, seed):
    r = np.random.default_rng(seed)
    return [r.uniform(size=shape) < 0.5 for _ in range(n)]


def _jax_step(jtask, state, batch, masks):
    """PitchExtractionTask.train_step (`tasks.py:354-372`) with the dropout
    masks in call order: (total, losses, grads, new state)."""
    queue = list(masks)

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout):
            keep = 1.0 - context.module.rate
            return jnp.where(jnp.asarray(queue.pop(0)), args[0] / keep, 0.0)
        return next_fun(*args, **kwargs)

    def step(state, batch):
        def loss_fn(params):
            ret, mutated = jtask.model.apply(
                {"params": params, "batch_stats": state.batch_stats}, batch["mels"],
                deterministic=False, mutable=["batch_stats"])
            losses = jtask.compute_losses(ret, batch)
            return sum(losses.values()), (losses, mutated["batch_stats"])

        with nn.intercept_methods(interceptor):
            (total, (losses, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params)
        return total, losses, grads, state.apply_gradients(grads=grads, batch_stats=stats)

    out = jax.jit(step)(state, batch)
    assert not queue
    return out


def _pin_port_dropout(model, masks):
    layers = [getattr(model.pitch_predictor, f"conv_{i}").dropout for i in range(5)]
    for d, m in zip(layers, masks):
        d.forward = lambda x, m=torch.as_tensor(m), d=d: torch.where(
            m, common.div(x, 1.0 - d.rate), torch.zeros((), dtype=x.dtype))


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_params(jax.device_get(tree)).items()}


def _port_grads(model):
    g = copy.deepcopy(model)
    for p, q in zip(model.parameters(), g.parameters()):
        q.data = torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
    return {k: v for k, v in export_flax_params(g).items()
            if k.rsplit("/", 1)[-1] not in ("mean", "var")}


def test_one_pe_step_matches_jax():
    """One fp32 PitchExtractionTask step from JAX's init, dropout masks
    pinned: the loss and each term 1e-5 relative; every gradient within
    1e-4 of the largest |gradient|; the Prenet's running statistics after
    the step within 4e-6 of max(|value|, 1) (they moved from JAX's init:
    mean 0, var 1; each is an fp32 mean of E[x^2] - E[x]^2 over a conv
    output that the two packages sum in another order: measured 1.3e-6 on
    a variance near 1.2); clip
    + AdamW alone on JAX's gradients within 1e-6 of optax's parameters, the
    port's own step within 1e-6 beyond what the gradients' difference moves
    through Adam's first step (as tests/test_torch_training.py)."""
    over = dict(lr=1.0, warmup_updates=4, clip_grad_norm=1.0, pitch_type="frame",
                use_uv=True, pitch_loss="l1")
    jhp, php = hparams(**over)
    batch = _batch()
    jtask = JPETask(jhp)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jax.jit(jtask.init_state)(jax.random.PRNGKey(0), jbatch)
    params = {**_flat(state.params), **_flat(state.batch_stats)}
    masks = _masks(5, (B, T, 256), 3)
    total, losses, grads, new_state = _jax_step(jtask, state, jbatch, masks)

    ptask = PitchExtractionTask(php, device="cpu")
    ptask.load_state(params)
    _pin_port_dropout(ptask.model, masks)
    out = ptask.train_step({k: t(v) for k, v in batch.items()})
    assert abs(float(out["total_loss"]) - float(total)) <= 1e-5 * abs(float(total))
    for k, v in losses.items():
        assert abs(float(out[k]) - float(v)) <= 1e-5 * abs(float(v)), k
    jg, pg = _flat(grads), _port_grads(ptask.model)
    assert set(jg) == set(pg)
    gmax = max(float(np.abs(v).max()) for v in jg.values())
    worst = max((max_err(pg[k], jg[k]), k) for k in jg)
    assert worst[0] <= 1e-4 * gmax, (worst, gmax)
    assert all(np.abs(jg[k]).max() > 0 for k in jg if k.startswith("mel_prenet/conv_"))
    stats = _flat(new_state.batch_stats)
    got = export_flax_params(ptask.model)
    assert abs(stats["mel_prenet/norm_0/var"] - 1.0).max() > 1e-2
    for k in stats:
        assert max_err(got[k], stats[k]) <= 4e-6 * max(np.abs(stats[k]).max(), 1.0), k
    # clip + AdamW alone on JAX's gradients
    fresh = PitchExtractionTask(php, device="cpu")
    fresh.load_state(params)
    g = copy.deepcopy(fresh.model)
    load_flax_params(g, {**jg, **_flat(state.batch_stats)})
    for p, q in zip(fresh.model.parameters(), g.parameters()):
        p.grad = q.data.clone()
    fresh.opt.step()
    jp, pf = _flat(new_state.params), export_flax_params(fresh.model)
    worst = max((max_err(pf[k], jp[k]), k) for k in jp)
    assert worst[0] <= 1e-6, worst
    lr, max_norm = ptask.opt.lr_fn(0), ptask.opt.max_norm
    clip = lambda gr: min(1.0, max_norm / np.sqrt(sum(  # noqa: E731
        float((v.astype(np.float64) ** 2).sum()) for v in gr.values())))
    cj, cp = clip(jg), clip(pg)
    u = lambda x: x / (np.abs(x) + 1e-8)  # noqa: E731
    for k in jp:
        err = np.abs(got[k].astype(np.float64) - jp[k])
        carried = lr * np.abs(u(cp * pg[k].astype(np.float64)) - u(cj * jg[k].astype(np.float64)))
        assert (err - carried).max() <= 1e-6, (k, float((err - carried).max()))


def test_pe_dropout_runs_only_in_training():
    """The predictor's dropout (0.5) and the batch statistics run in a train
    step only: two train-mode forwards from different generators differ and
    move the running statistics; eval mode is deterministic and moves
    nothing; the per-epoch accumulation rebuilds the optimizer."""
    _, php = hparams(accumulate_grad_batches={"1": 2})
    task = PitchExtractionTask(php, device="cpu")
    mels = t(_batch()["mels"])
    before = task.model.mel_prenet.norm_0.running_mean.clone()
    task.model.train()
    outs = []
    for seed in (0, 1):
        common.set_dropout_generator(task.model, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            outs.append(task.model(mels, deterministic=False)["pitch_pred"])
    assert not torch.equal(outs[0], outs[1])
    moved = task.model.mel_prenet.norm_0.running_mean.clone()
    assert not torch.equal(before, moved)
    evals = [task.infer_step(mels)["pitch_pred"] for _ in range(2)]
    assert torch.equal(evals[0], evals[1])
    assert torch.equal(task.model.mel_prenet.norm_0.running_mean, moved)
    assert task.opt.every_k is None
    task.configure_accumulation(10)
    assert task.opt.every_k is not None and task.opt.every_k(0) == 2


# ---- the CLI -----------------------------------------------------------------
def test_pe_cli_binarize_train_resume_validate(tmp_path, monkeypatch, capsys):
    """--binarize a 10-item synthetic corpus; train the PE 3 steps under the
    reference's task name (no vocabulary needed), resume to 5 (the batch
    statistics restored with the parameters), --validate; the work dir's
    pe_params.npz and pe_batch_stats.npz load through `_pe_and_vocoder`
    and hold the checkpoint's statistics; `task_cls` takes the JAX
    package's name too."""
    from bisinger_tpu_torch import run
    from bisinger_tpu_torch.config import make_hparams
    from bisinger_tpu_torch.data.synthetic import make_synthetic_corpus
    from bisinger_tpu_torch.inference.pipeline import _pe_and_vocoder
    from bisinger_tpu_torch.training.checkpoints import CheckpointManager
    from bisinger_tpu_torch.weights import load_npz

    assert task_class("bisinger_tpu.training.tasks.PitchExtractionTask") is \
        PitchExtractionTask
    make_synthetic_corpus(str(tmp_path / "raw"), n_items=10, seed=0)
    cfg = make_hparams(dict(
        raw_data_dir=str(tmp_path / "raw"), raw_json_fn="meta.json",
        binary_data_dir=str(tmp_path / "binary"), test_prefixes=["Alto-1#song0"],
        pitch_extractor="autocorr", num_spk=4, bucket_tokens=[32], bucket_frames=[256],
        max_tokens=4000, max_sentences=4, max_eval_sentences=4, lr=1.0, warmup_updates=2,
        log_interval=1, val_check_interval=100, num_sanity_val_steps=1, num_ckpt_keep=2,
        compute_dtype="float32", task_cls="tasks.tts.pe.PitchExtractionTask"))
    with open(tmp_path / "pe.json", "w") as f:
        json.dump(cfg, f)
    monkeypatch.chdir(tmp_path)
    base = ["--config", "pe.json", "--device", "cpu"]
    assert run.main(base + ["--binarize"]) == 0
    assert run.main(base + ["--exp_name", "pe", "--max_updates", "3"]) == 0
    work = tmp_path / "checkpoints" / "pe"
    ckpt = CheckpointManager(str(work / "ckpt"))
    saved3 = ckpt.restore()["params"]
    assert saved3["mel_prenet/norm_0/var"].shape == (256,)
    assert abs(saved3["mel_prenet/norm_0/var"] - 1.0).max() > 1e-3  # moved in training
    assert run.main(base + ["--exp_name", "pe", "--max_updates", "5"]) == 0
    out = capsys.readouterr().out
    assert "| resumed from step 3" in out and "| step 5 [tr]" in out and "f0=" in out
    assert run.main(base + ["--exp_name", "pe", "--validate"]) == 0
    out = capsys.readouterr().out
    assert "| validating checkpoint at step 5" in out and "| validate: total_loss=" in out
    stats = load_npz(str(work / "pe_batch_stats.npz"))
    saved5 = ckpt.restore()["params"]
    assert set(stats) == {f"mel_prenet/norm_{i}/{s}" for i in range(3) for s in ("mean", "var")}
    assert all(np.array_equal(stats[k], saved5[k]) for k in stats)
    assert not np.array_equal(saved5["mel_prenet/norm_0/mean"], saved3["mel_prenet/norm_0/mean"])
    # the serving loader: the PE files, with a generator beside them
    _, php = hparams(upsample_initial_channel=16)
    (work / "vocoder").mkdir()
    np.savez(work / "vocoder" / "generator_000000001.npz",
             **export_flax_params(HifiGanGenerator(php)))
    pe, _ = _pe_and_vocoder(str(work), dict(php, compute_dtype="float32"))
    got = export_flax_params(pe)
    assert all(np.array_equal(got[k], v) for k, v in saved5.items())
