"""The port's GAN vocoder path against the JAX package, on the CPU: PQMF,
the multiband generator (tiny, and the trained flagship mb4 weights), the
discriminators, the GAN losses and STFT losses, weight norm, one full GAN
step (full band, mb4 and the plain generator without f0), the bf16
training generator; the generator glob
by step number, the inference wrapper, the decisions (the MSD keeps weight
norm on every scale; one NSF draw a step; no kernel in a train step) and
`tools/train_vocoder`.

The generator settings are those of tests/test_vocoder_training.py:17-23
(hop 64, upsample rates [4, 4, 2, 2], kernels [8, 8, 4, 4], 16 channels;
mb4: rates [4, 4], kernels [8, 8], 4 subbands), fp32 on both sides unless
stated. The NSF phase and noise are numpy draws handed to both sides
(`jax.random.uniform` and `normal` patched on the JAX side). Each JAX GAN
step is made once, in a module-scoped fixture. Tolerances are stated at
each assertion.
"""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bisinger_tpu.models.hifigan as jh
from bisinger_tpu.models.pwg import PQMF as JPQMF
from bisinger_tpu.ops.stft import log_mel_spectrogram as j_log_mel
from bisinger_tpu.training import weight_norm as jwn
from bisinger_tpu.training.vocoder_task import GANTrainState
from bisinger_tpu.training.vocoder_task import HifiGanTask as JHifiGanTask
from bisinger_tpu.training.vocoder_task import mel_l1 as j_mel_l1
from bisinger_tpu.training.vocoder_task import multi_resolution_stft_loss as j_mrstft
from bisinger_tpu.vocoders.hifigan import flatten_params
from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, _pe_and_vocoder
from bisinger_tpu_torch.models import hifigan as ph
from bisinger_tpu_torch.models.pqmf import PQMF
from bisinger_tpu_torch.ops.stft import log_mel_spectrogram
from bisinger_tpu_torch.tools.step_parity import gan_to_float64
from bisinger_tpu_torch.training import weight_norm as wn
from bisinger_tpu_torch.training.vocoder_task import (
    Discriminators,
    HifiGanTask,
    mel_l1,
    multi_resolution_stft_loss,
)
from bisinger_tpu_torch.vocoders.hifigan import HifiGAN, latest_generator
from bisinger_tpu_torch.weights import export_flax_params, load_flax_params, load_npz

from torch_port_helpers import hparams, max_err, t, to_port

GEN = dict(use_pitch_embed=True, hop_size=64, upsample_rates=[4, 4, 2, 2],
           upsample_kernel_sizes=[8, 8, 4, 4], upsample_initial_channel=16)
MB4 = dict(GEN, upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8], vocoder_multiband=4)
PLAIN = dict(GEN, use_nsf=False)  # the TTS configs' HiFi-GAN: no harmonic source
VARIANTS = {"full_band": GEN, "mb4": MB4, "plain": PLAIN}
B, T = 2, 16  # 16 frames: 1024 samples at hop 64


def _rel(a, b):
    return max_err(a, b) / max(float(np.abs(np.asarray(b)).max()), 1e-30)


def _pinned(mp, phase, noise):
    mp.setattr(jax.random, "uniform",
               lambda key, shape=(), dtype=jnp.float32, **kw: jnp.asarray(phase, dtype))
    mp.setattr(jax.random, "normal",
               lambda key, shape=(), dtype=jnp.float32, **kw: jnp.asarray(noise, dtype))


def _inputs(seed, frames=T, hop=64, b=B):
    r = np.random.default_rng(seed)
    mel = r.standard_normal((b, frames, 80)).astype(np.float32)
    f0 = r.uniform(150.0, 450.0, (b, frames)).astype(np.float32)
    f0[:, frames // 3: frames // 3 + 3] = 0.0  # an unvoiced stretch
    wav = (0.1 * r.standard_normal((b, frames * hop))).astype(np.float32)
    phase = r.uniform(size=(b, 9)).astype(np.float32)
    noise = r.standard_normal((b, frames * hop, 9)).astype(np.float32)
    return mel, f0, wav, phase, noise


def _draw(shapes, seed, small=()):
    """A seeded draw for every leaf of a flax tree of shapes: kernels N(0,
    0.03^2) under a top module whose name starts with one in `small` (three
    times flax's conv_init of the HiFi-GAN reference), else at unit gain
    (normal / sqrt(fan-in), as lecun-normal); LayerNorm scales near 1,
    biases small. Drawn with numpy: a flax init of the discriminators takes
    tens of seconds on the CPU."""
    r = np.random.default_rng(seed)

    def leaf(path, sd):
        names = [getattr(p, "key", "") for p in path]
        if names[-1] == "kernel":
            if small and names[0].startswith(small):
                return (0.03 * r.standard_normal(sd.shape)).astype(np.float32)
            return (r.standard_normal(sd.shape) * np.prod(sd.shape[:-1]) ** -0.5).astype(
                np.float32)
        if names[-1] == "scale":
            return (1.0 + 0.1 * r.standard_normal(sd.shape)).astype(np.float32)
        return (0.05 * r.standard_normal(sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _trees(variant):
    """(JAX hparams, port hparams, generator params, {"mpd", "msd"} params)
    of the full-band, mb4 or plain settings, plain kernels, seeded draws; the
    plain generator's tree is flax's built without an f0."""
    jhp, php = hparams(**VARIANTS[variant])
    mel, f0, wav, _, _ = _inputs(11)
    key = jax.random.PRNGKey(0)
    f0 = f0 if php["use_nsf"] else None
    gen, mpd, msd = jax.eval_shape(lambda: (
        jh.HifiGanGenerator(hp=jhp).init({"params": key, "nsf": key}, mel, f0)["params"],
        jh.MultiPeriodDiscriminator().init(key, wav, wav)["params"],
        jh.MultiScaleDiscriminator().init(key, wav, wav)["params"]))
    return (jhp, php, _draw(gen, 1, small=("res_", "up_", "conv_post")),
            {"mpd": _draw(mpd, 2), "msd": _draw(msd, 3)})


# ---- PQMF, the multiband generator --------------------------------------
def test_pqmf_matches_jax():
    """Analysis and synthesis of a tone and noise: 1e-6 absolute."""
    n = np.arange(4096)
    x = (0.5 * np.sin(2 * np.pi * 220 * n / 24000)
         + 0.05 * np.random.default_rng(0).standard_normal(4096)).astype(np.float32)[None]
    jp, pp = JPQMF(4), PQMF(4)
    np.testing.assert_array_equal(pp.h_synthesis.numpy(), np.asarray(jp.h_synthesis))
    sub = pp.analysis(t(x))
    jsub = jp.analysis(jnp.asarray(x))
    assert sub.shape == jsub.shape == (1, 1024, 4)
    assert max_err(sub.numpy(), jsub) <= 1e-6
    assert max_err(pp.synthesis(sub).numpy(), jp.synthesis(jsub)) <= 1e-6


def test_multiband_generator_matches_jax(tmp_path, monkeypatch):
    """4 subbands at hop 64 (rates [4, 4]): the subbands and the waveform
    after PQMF synthesis within 2e-3 (the suite's waveform bound), eval mode
    (K2's plain version) and train mode (the ResBlock1 layers) alike."""
    jhp, php, params, _ = _trees("mb4")
    mel, f0, _, phase, noise = _inputs(0)
    with monkeypatch.context() as mp:
        _pinned(mp, phase, noise)
        ref = np.asarray(jax.jit(lambda p: jh.HifiGanGenerator(hp=jhp).apply(
            {"params": p}, mel, f0, rngs={"nsf": jax.random.PRNGKey(2)}))(params))
    ref_wav = np.asarray(JPQMF(4).synthesis(jnp.asarray(ref)))
    gen = to_port(ph.HifiGanGenerator(php), params, tmp_path)
    assert gen.conv_post.out_channels == 4 and gen.get_submodule("noise_conv_0").stride == (16,)
    for mode in ("eval", "train"):
        getattr(gen, mode)()
        with torch.no_grad():
            sub = gen(t(mel), t(f0), phase=t(phase), noise=t(noise))
        assert sub.shape == ref.shape == (B, T * 16, 4)
        assert np.abs(ref).max() > 1e-2
        assert max_err(sub.numpy(), ref) <= 2e-3, mode
        assert max_err(PQMF(4).synthesis(sub).numpy(), ref_wav) <= 2e-3, mode


def test_trained_mb4_weights_match_jax(monkeypatch):
    """The trained flagship `vocoder_mb4` generator (512 channels, fp32) on 16
    frames through PQMF, as `_pe_and_vocoder` loads it for
    `vocoder_multiband: 4`: waveform within 2e-3 of JAX's."""
    from bisinger_tpu.config import load_hparams
    from bisinger_tpu_torch.config import load_hparams_json

    over = dict(vocoder_multiband=4, upsample_rates=[8, 4], upsample_kernel_sizes=[16, 8],
                compute_dtype="float32")
    php = load_hparams_json(os.path.join(FLAGSHIP_DIR, "hparams_diff.json"), over)
    _, voc = _pe_and_vocoder(FLAGSHIP_DIR, php)
    path = latest_generator(os.path.join(FLAGSHIP_DIR, "vocoder_mb4"), recursive=True)
    flat = load_npz(path)
    jhp = load_hparams(overrides=dict(over, upsample_initial_channel=512))
    from bisinger_tpu.vocoders.hifigan import unflatten_params

    params = unflatten_params(flat)
    r = np.random.default_rng(7)
    frames = 16
    mel = (r.standard_normal((1, frames, 80)) * 0.5 - 4).astype(np.float32)
    f0 = np.full((1, frames), 262.0, np.float32)
    phase = r.uniform(size=(1, 9)).astype(np.float32)
    noise = r.standard_normal((1, frames * 128, 9)).astype(np.float32)
    with monkeypatch.context() as mp:
        _pinned(mp, phase, noise)
        ref = JPQMF(4).synthesis(jax.jit(lambda p, m, f: jh.HifiGanGenerator(hp=jhp).apply(
            {"params": p}, m, f, rngs={"nsf": jax.random.PRNGKey(0)}))(params, mel, f0))
    with torch.no_grad():
        got = PQMF(4).synthesis(voc.eval()(t(mel), t(f0), phase=t(phase), noise=t(noise)))
    assert got.shape == (1, frames * 128)
    assert np.abs(np.asarray(ref)).max() > 1e-3
    assert max_err(got.numpy(), ref) <= 2e-3


# ---- discriminators and losses -------------------------------------------
@pytest.fixture(scope="module")
def discs():
    """The MPD and MSD parameters of `_trees` and the port's modules loaded
    with them."""
    d = _trees("full_band")[3]
    mpd, msd = ph.MultiPeriodDiscriminator(), ph.MultiScaleDiscriminator()
    load_flax_params(mpd, _flat(d["mpd"]))
    load_flax_params(msd, _flat(d["msd"]))
    return d["mpd"], d["msd"], mpd.eval(), msd.eval()


def _layout(f):
    """A port feature map [B, C, H, W] or [B, C, T] in flax's [B, H, W, C] /
    [B, T, C] layout."""
    return np.moveaxis(f.detach().numpy(), 1, -1)


@pytest.mark.parametrize("n", [1024, 1001])
def test_discriminators_match_jax(discs, n):
    """MPD and MSD on real and generated inputs of an even and an odd
    length (reflect padding to the period, flax's uneven SAME padding and
    pooling): every output and feature map within 1e-5 of the largest."""
    jmpd, jmsd, mpd, msd = discs
    r = np.random.default_rng(n)
    y, y_hat = (0.3 * r.standard_normal((2, B, n))).astype(np.float32)
    for jmod, params, port in ((jh.MultiPeriodDiscriminator(), jmpd, mpd),
                               (jh.MultiScaleDiscriminator(), jmsd, msd)):
        ref = jax.jit(lambda p, a, b, m=jmod: m.apply({"params": p}, a, b))(params, y, y_hat)
        with torch.no_grad():
            got = port(t(y), t(y_hat))
        for outs_j, outs_p in ((ref[0], got[0]), (ref[1], got[1])):
            for oj, op in zip(outs_j, outs_p):
                assert op.shape == oj.shape and _rel(op.numpy(), oj) <= 1e-5
        for fj_all, fp_all in ((ref[2], got[2]), (ref[3], got[3])):
            for fj, fp in zip(fj_all, fp_all):
                for a, b in zip(fj, fp):
                    assert _layout(b).shape == a.shape and _rel(_layout(b), a) <= 1e-5


def test_gan_and_stft_losses_match_jax(discs):
    """feature_loss, discriminator_loss, generator_loss on the MPD's outputs,
    mel_l1 (hop 64) and the multi-resolution STFT loss: 1e-5 relative."""
    jmpd, _, mpd, _ = discs
    r = np.random.default_rng(3)
    y, y_hat = (0.3 * r.standard_normal((2, B, 2048))).astype(np.float32)
    jr, jg, jfr, jfg = jax.jit(lambda p: jh.MultiPeriodDiscriminator().apply(
        {"params": p}, y, y_hat))(jmpd)
    with torch.no_grad():
        pr, pg, pfr, pfg = mpd(t(y), t(y_hat))
    pairs = [(ph.feature_loss(pfr, pfg), jh.feature_loss(jfr, jfg)),
             *zip(ph.discriminator_loss(pr, pg), jh.discriminator_loss(jr, jg)),
             (ph.generator_loss(pg), jh.generator_loss(jg))]
    jhp, php = hparams(**GEN)
    pairs.append((mel_l1(t(y_hat), t(y), php), j_mel_l1(jnp.asarray(y_hat), jnp.asarray(y), jhp)))
    pairs += list(zip(multi_resolution_stft_loss(t(y_hat), t(y)),
                      j_mrstft(jnp.asarray(y_hat), jnp.asarray(y))))
    pairs.append((log_mel_spectrogram(t(y)).abs().mean(), jnp.abs(j_log_mel(jnp.asarray(y))).mean()))
    for got, ref in pairs:
        assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref)), (float(got), float(ref))


# ---- weight norm ----------------------------------------------------------
def test_weight_norm_decompose_compose_match_jax(tmp_path):
    """decompose and compose of a generator (up_* grouped per input channel,
    noise_conv / m_source / norm left plain) and of both discriminators:
    the same leaves as JAX's, each within 1e-6 of the largest (the g's are
    fp32 sums of up to 5120 squares taken in another order than XLA's, and
    lie near 1, where one fp32 step is 1.2e-7: measured up to 3.3e-7);
    compose inverts decompose to 1e-7; the export is the plain tree."""
    _, php, plain_gen, plain_disc = _trees("full_band")
    decompose = jax.jit(jwn.decompose)
    gen = to_port(ph.HifiGanGenerator(php), plain_gen, tmp_path)
    port = wn.flax_tree(gen, wn.decompose(gen))
    ref = _flat(decompose(plain_gen))
    assert set(port) == set(ref)
    assert ref["up_0/kernel/wn_g"].shape == (1, 16, 1)  # per input channel
    assert "noise_conv_0/kernel" in ref and "m_source/merge/kernel" in ref  # plain
    for k in ref:
        assert _rel(port[k], ref[k]) <= 1e-6, k
    composed = wn.compose(wn.decompose(gen))
    for name, p in gen.named_parameters():
        assert max_err(composed[name].detach().numpy(), p.detach().numpy()) <= 1e-7
    exported = wn.export(gen, wn.decompose(gen))
    jplain = _flat(jax.jit(jwn.compose)(decompose(plain_gen)))
    assert set(exported) == set(jplain)
    assert all(max_err(exported[k], jplain[k]) <= 1e-7 for k in jplain)
    disc = Discriminators()
    load_flax_params(disc, _flat(plain_disc))
    port = wn.flax_tree(disc, wn.decompose(disc))
    ref = _flat(decompose(plain_disc))
    assert set(port) == set(ref)
    for k in ref:
        assert _rel(port[k], ref[k]) <= 1e-6, k


def test_msd_keeps_weight_norm_on_every_scale_as_jax():
    """The MSD spectral-norm decision: the reference puts spectral norm on
    scale 0, the JAX package weight norm on every MSD scale
    (`bisinger_tpu/training/vocoder_task.py:116`); the port follows JAX, so
    every MSD kernel, scale 0 included, trains as a (g, v) pair, as in JAX's
    decomposed tree, and no spectral-norm state exists."""
    _, php = hparams(**GEN)
    task = HifiGanTask(php, device="cpu")
    msd_kernels = [n for n, _ in task.disc.named_parameters()
                   if n.startswith("msd.") and n.endswith(".weight")]
    assert len(msd_kernels) == 3 * 8
    for n in msd_kernels:
        assert n + ".wn_g" in task.disc_params and n + ".wn_v" in task.disc_params
    jkeys = flatten_params(jax.eval_shape(jwn.decompose, _trees("full_band")[3]["msd"]))
    assert sum(k.endswith("/wn_g") for k in jkeys) == 3 * 8
    assert not any("spectral" in k or "sigma" in k or k.endswith("_u")
                   for k in list(jkeys) + list(task.disc_params))


# ---- one GAN step -----------------------------------------------------------
def _disc_loss(dparams, wav, fake):
    """The D update's loss (`vocoder_task.py:158-168`) on decomposed params."""
    mpd_r, mpd_g, _, _ = jh.MultiPeriodDiscriminator().apply(
        {"params": jwn.compose(dparams["mpd"])}, wav, fake)
    msd_r, msd_g, _, _ = jh.MultiScaleDiscriminator().apply(
        {"params": jwn.compose(dparams["msd"])}, wav, fake)
    r1, g1 = jh.discriminator_loss(mpd_r, mpd_g)
    r2, g2 = jh.discriminator_loss(msd_r, msd_g)
    return r1 + g1 + r2 + g2, {"disc_real": r1 + r2, "disc_fake": g1 + g2}


def _adv_loss(dparams, wav, fake):
    """The G update's adversarial and feature-matching terms
    (`vocoder_task.py:174-182`)."""
    _, mpd_g, fmr, fmg = jh.MultiPeriodDiscriminator().apply(
        {"params": jwn.compose(dparams["mpd"])}, wav, fake)
    _, msd_g, fsr, fsg = jh.MultiScaleDiscriminator().apply(
        {"params": jwn.compose(dparams["msd"])}, wav, fake)
    adv = jh.generator_loss(mpd_g) + jh.generator_loss(msd_g)
    fm = jh.feature_loss(fmr, fmg) + jh.feature_loss(fsr, fsg)
    return adv + fm, {"gen_adv": adv, "gen_fm": fm}


# compiled once for both variants (the discriminators are the same): the
# D update's gradient in the discriminators, the G update's in the waveform;
# the optimizer's update compiled too (eager, a leaf at a time, it takes
# seconds per tree)
_D_GRAD = jax.jit(jax.value_and_grad(_disc_loss, has_aux=True))
_ADV_GRAD = jax.jit(jax.value_and_grad(_adv_loss, argnums=2, has_aux=True))
_APPLY = jax.jit(lambda state, grads: state.apply_gradients(grads=grads))


def _jax_gan_step(jtask, gen_state, disc_state, batch, rng):
    """`HifiGanTask.train_step` of the JAX package (`vocoder_task.py:145-203`)
    with the generator's gradient taken by the chain rule through the
    waveform (`jax.vjp`), so that the discriminators' part compiles once for
    both variants; returns each update's losses and gradients beside the new
    states."""
    mel, f0, wav = batch["mels"], batch["f0"], batch["wav"]
    rng_g, _ = jax.random.split(rng)
    generate = jax.jit(lambda p: jtask._generate(p, mel, f0, rng_g))
    (d_loss, d_aux), d_grads = _D_GRAD(disc_state.params, wav, generate(gen_state.params))
    disc_state = _APPLY(disc_state, d_grads)
    fake, pullback = jax.vjp(generate, gen_state.params)
    (adv_fm, g_aux), d_fake = _ADV_GRAD(disc_state.params, wav, fake)
    mel_loss, d_mel = jax.value_and_grad(
        lambda w: j_mel_l1(w, wav, jtask.hp) * jtask.lambda_mel)(fake)
    (g_grads,) = pullback(d_fake + d_mel)
    gen_state = _APPLY(gen_state, g_grads)
    metrics = {"disc_loss": d_loss, "gen_loss": adv_fm + mel_loss, **d_aux, **g_aux,
               "gen_mel": mel_loss}
    return metrics, d_grads, g_grads, disc_state, gen_state


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_params(jax.device_get(tree)).items()}


@pytest.fixture(scope="module", params=list(VARIANTS))
def gan_step(request):
    """One JAX GAN step (full band, mb4 or plain) with its draws pinned, in
    float64
    (`jax.enable_x64`): in fp32, XLA's CPU gradients of the MSD's grouped
    convs read up to 1.3e-4 of the largest away from an fp64 run of the same
    step, the port's fp32 ones 3e-7, so an fp32 JAX step is no reference at
    the 1e-4 bound. Returns the hparams, inputs, start trees (fp32),
    metrics, gradients and new trees."""
    jhp, php, gen, disc = _trees(request.param)
    mel, f0, wav, phase, noise = _inputs(11, b=1)
    jtask = JHifiGanTask(jhp)
    decompose = jax.jit(jwn.decompose)
    gen, disc = decompose(gen), {k: decompose(v) for k, v in disc.items()}
    start = (_flat(gen), _flat(disc))
    mp = pytest.MonkeyPatch()
    try:
        _pinned(mp, phase, noise)
        with jax.enable_x64(True):
            f64 = lambda tree: jax.tree_util.tree_map(  # noqa: E731
                lambda a: jnp.asarray(a, jnp.float64), tree)
            if jtask.pqmf is not None:  # its filters are fp32 constants
                jtask.pqmf.h_synthesis = f64(jtask.pqmf.h_synthesis)
            gs = jax.jit(lambda p: GANTrainState.create(apply_fn=None, params=p,
                                                        tx=jtask.gen_tx))(f64(gen))
            ds = jax.jit(lambda p: GANTrainState.create(apply_fn=None, params=p,
                                                        tx=jtask.disc_tx))(f64(disc))
            # the plain generator gets f0=None (decision (a), ROADMAP Queue 3):
            # JAX's task computes the port's step when handed none
            batch = f64({"mels": mel, "f0": f0 if php["use_nsf"] else None, "wav": wav})
            metrics, dg, gg, ds2, gs2 = _jax_gan_step(jtask, gs, ds, batch,
                                                      jax.random.PRNGKey(1))
    finally:
        mp.undo()
    return dict(name=request.param, php=php, inputs=(mel, f0, wav, phase, noise), start=start,
                metrics={k: float(v) for k, v in metrics.items()}, grads=(_flat(dg), _flat(gg)),
                new=(_flat(gs2.params), _flat(ds2.params)))


def _port_task(g, start):
    task = HifiGanTask(g["php"], device="cpu")
    task.load_flax_trees(*start)
    return task


def _grads(module, params):
    return wn.flax_tree(module, {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                                 for k, p in params.items()})


def test_one_gan_step_matches_jax(gan_step):
    """One fp32 GAN step, full band, mb4 and plain (no f0, decision (a) of
    ROADMAP Queue 3): D loss, G loss and every aux
    metric within 1e-5 of its own value; every gradient of both updates
    within 1e-4 of that update's largest |gradient|; AdamW alone on JAX's
    gradients within 1e-6 of optax's parameters; the port's own step within
    1e-6 beyond what the two gradients' difference moves through Adam's
    first step (u(x) = x / (|x| + 1e-8) is steep where |g| is near 0)."""
    g = gan_step
    mel, f0, wav, phase, noise = g["inputs"]
    task = _port_task(g, g["start"])
    fresh = copy.deepcopy(task)
    batch = {"mels": t(mel), "f0": t(f0), "wav": t(wav)}
    out = task.train_step(batch, phase=t(phase), noise=t(noise))
    assert set(out) == set(g["metrics"])
    for k, v in g["metrics"].items():
        assert abs(float(out[k]) - v) <= 1e-5 * abs(v), (g["name"], k, float(out[k]), v)
    jd, jg = g["grads"]
    pd, pg = _grads(task.disc, task.disc_params), _grads(task.generator, task.gen_params)
    for jgr, pgr in ((jd, pd), (jg, pg)):
        assert set(jgr) == set(pgr)
        gmax = max(float(np.abs(v).max()) for v in jgr.values())
        worst = max((max_err(pgr[k], jgr[k]), k) for k in jgr)
        assert worst[0] <= 1e-4 * gmax, (g["name"], worst, gmax)
        assert sum(np.abs(v).max() > 0 for v in jgr.values()) > 0.9 * len(jgr)
    # the optimizers alone, on JAX's gradients
    for module, params, opt, jgr in ((fresh.disc, fresh.disc_params, fresh.disc_opt, jd),
                                     (fresh.generator, fresh.gen_params, fresh.gen_opt, jg)):
        holder = {k: torch.zeros_like(p) for k, p in params.items()}
        wn.load_flax_tree(module, holder, jgr)
        for k, p in params.items():
            p.grad = holder[k]
        opt.step()
    jgen_new, jdisc_new = g["new"]
    for module, params, ref in ((fresh.generator, fresh.gen_params, jgen_new),
                                (fresh.disc, fresh.disc_params, jdisc_new)):
        got = wn.flax_tree(module, params)
        worst = max((max_err(got[k], ref[k]), k) for k in ref)
        assert worst[0] <= 1e-6, (g["name"], worst)
    lr = task.gen_opt.lr_fn(0)
    u = lambda x: x / (np.abs(x) + 1e-8)  # noqa: E731
    for module, params, ref, jgr, pgr in ((task.generator, task.gen_params, jgen_new, jg, pg),
                                          (task.disc, task.disc_params, jdisc_new, jd, pd)):
        got = wn.flax_tree(module, params)
        for k in ref:
            err = np.abs(got[k].astype(np.float64) - ref[k])
            carried = lr * np.abs(u(pgr[k].astype(np.float64)) - u(jgr[k].astype(np.float64)))
            assert (err - carried).max() <= 1e-6, (g["name"], k, float((err - carried).max()))


@pytest.mark.parametrize("gan_step", ["full_band", "mb4"], indirect=True)
def test_float64_gan_step_matches_jax_float64(gan_step):
    """The port's GAN step cast to float64 (`tools/step_parity`'s reference
    of a card-vs-CPU step) against JAX's float64 step from the same trees
    and draws: every metric within 2e-6 of its own value, every gradient of
    both updates within 2e-6 of its update's largest (measured: the D
    update 5.5e-10, the G update 5.8e-7 and gen_adv 4.3e-7, against the
    1e-4 and 1e-5 that an fp32 step is held to)."""
    g = gan_step
    mel, f0, wav, phase, noise = g["inputs"]
    task = _port_task(g, g["start"])
    gan_to_float64(task)
    d = lambda x: torch.as_tensor(np.asarray(x, np.float64))  # noqa: E731
    out = task.train_step({"mels": d(mel), "f0": d(f0), "wav": d(wav)}, phase=d(phase),
                          noise=d(noise))
    for k, v in g["metrics"].items():
        assert abs(float(out[k]) - v) <= 2e-6 * abs(v), (g["name"], k, float(out[k]), v)
    for jgr, module, params in ((g["grads"][0], task.disc, task.disc_params),
                                (g["grads"][1], task.generator, task.gen_params)):
        pgr = _grads(module, params)
        gmax = max(float(np.abs(v).max()) for v in jgr.values())
        worst = max((max_err(pgr[k], jgr[k]), k) for k in jgr)
        assert worst[0] <= 2e-6 * gmax, (g["name"], worst, gmax)


def test_d_and_g_fakes_share_one_nsf_draw():
    """Both generator passes of a step get the same phase and noise, drawn
    once from the step's generator (`vocoder_task.py:153`)."""
    _, php = hparams(**GEN)
    task = HifiGanTask(php, device="cpu")
    seen = []
    real = task.generate

    def generate(params, mel, f0, phase, noise):
        seen.append((phase, noise))
        return real(params, mel, f0, phase, noise)

    task.generate = generate
    mel, f0, wav, _, _ = _inputs(11)
    task.train_step({"mels": t(mel), "f0": t(f0), "wav": t(wav)},
                    torch.Generator().manual_seed(0))
    assert len(seen) == 2
    assert seen[0][0] is seen[1][0] and seen[0][1] is seen[1][1]
    assert seen[0][1].shape == (B, T * 64, 9)


def test_bf16_training_generator_matches_jax_bf16(tmp_path, monkeypatch):
    """compute_dtype bfloat16 on both sides: the generator's train-mode
    layer path (the path a GAN step differentiates) against flax's
    ResBlock1 generator compiled without XLA's excess precision. Both sides
    get the port's harmonic source (fp32 in both packages, held against
    JAX's by tests/test_torch_hifigan.py::test_sine_gen_matches): the
    packages' phase sums (the port's in fp64, JAX's in fp32) leave the
    sines a little apart, far inside that test's 1e-4, enough to move a
    value of the source across a bf16 rounding boundary of the noise convs'
    input, which moves the waveform by a bf16 step. Measured on the
    waveform, port in bf16 / port in fp32: max 5.6e-9 / 4.4e-4, mean
    1.7e-9 / 1.2e-5 -> max 1e-5, mean 1e-6: the layer path rounds where
    flax rounds, which an fp32 generator does not."""
    from test_torch_dtype import _strict_jit

    jhp, php = hparams(**dict(GEN, compute_dtype="bfloat16"))
    _, php32 = hparams(**GEN)
    mel, f0, _, phase, noise = _inputs(5)
    jgen = jh.HifiGanGenerator(hp=jhp)
    params = _trees("full_band")[2]
    src, uv = ph.sine_gen(t(np.repeat(f0, 64, axis=1)[:, :, None]), php["audio_sample_rate"],
                          phase=t(phase), noise=t(noise))
    with monkeypatch.context() as mp:
        mp.setattr(jh, "sine_gen", lambda *a, **kw: (jnp.asarray(src.numpy()),
                                                     jnp.asarray(uv.numpy()), None))
        ref = np.asarray(_strict_jit(lambda p: jgen.apply(
            {"params": p}, mel, f0, rngs={"nsf": jax.random.PRNGKey(2)}), params))
    gaps = {}
    for name, hp_ in (("bf16", php), ("fp32", php32)):
        gen = to_port(ph.HifiGanGenerator(hp_), params, tmp_path, name=f"{name}.npz").train()
        with torch.no_grad():
            got = gen(t(mel), t(f0), phase=t(phase), noise=t(noise)).numpy()
        gaps[name] = (max_err(got, ref), float(np.abs(got - ref).mean()))
    assert np.abs(ref).max() > 1e-2
    assert gaps["bf16"][0] <= 1e-5 and gaps["bf16"][1] <= 1e-6, gaps
    assert gaps["fp32"][0] > 1e-5 and gaps["fp32"][1] > 1e-6, gaps


# ---- the generator glob, the wrapper, the CLI ------------------------------
def _generators(tmp_path, sub=""):
    """A stale 8-digit step 4000 and a newer 9-digit step 30000 of a tiny
    generator (plain kernels, flax names); returns (hp, newer params)."""
    _, php = hparams(**GEN)
    gen = ph.HifiGanGenerator(php)
    flat = export_flax_params(gen)
    d = tmp_path / sub if sub else tmp_path
    d.mkdir(parents=True, exist_ok=True)
    np.savez(d / "generator_00004000.npz", **flat)
    newer = {k: v + 1.0 for k, v in flat.items()}
    np.savez(d / "generator_000030000.npz", **newer)
    return php, newer


def test_wrapper_loads_the_highest_step_and_never_a_random_generator(tmp_path):
    """The wrapper takes generator_000030000 over generator_00004000 (a string
    sort takes the stale one), vocodes with it, and raises without a file."""
    php, newer = _generators(tmp_path / "voc")
    hp = dict(php, vocoder_ckpt=str(tmp_path / "voc"))
    voc = HifiGAN(hp, device="cpu")
    assert voc.path.endswith("generator_000030000.npz")
    got = export_flax_params(voc.model)
    assert all(np.array_equal(got[k], newer[k]) for k in newer)
    mel, f0, _, _, _ = _inputs(1)
    wav = voc.spec2wav(mel[0], f0[0])
    assert wav.shape == (T * 64,) and np.isfinite(wav).all()
    saved = voc.save_params(30001)
    assert latest_generator(hp["vocoder_ckpt"]) == saved
    with pytest.raises(FileNotFoundError, match="no generator"):
        HifiGAN(dict(php, vocoder_ckpt=str(tmp_path / "empty")), device="cpu")


def test_pe_and_vocoder_loads_the_highest_step(tmp_path):
    """`_pe_and_vocoder` (the serving path's loader) takes the highest step of
    vocoder/**/generator_*.npz, and vocoder_mb4/** for a 4-band vocoder."""
    import shutil

    for fn in ("pe_params.npz", "pe_batch_stats.npz"):
        shutil.copy(os.path.join(FLAGSHIP_DIR, fn), tmp_path / fn)
    php, newer = _generators(tmp_path, "vocoder/vocoder")
    _, voc = _pe_and_vocoder(str(tmp_path), php)
    got = export_flax_params(voc)
    assert all(np.array_equal(got[k], newer[k]) for k in newer)
    with pytest.raises(FileNotFoundError, match="vocoder_mb4"):
        _pe_and_vocoder(str(tmp_path), dict(php, **MB4))


def test_train_vocoder_cli_and_round_trip(tmp_path, monkeypatch, capsys):
    """`python -m bisinger_tpu_torch.tools.train_vocoder --device cpu` at 16
    channels for 3 steps (B=2, 8 frames, its default bf16): the summary JSON
    with finite losses, generator_000000003.npz, which the wrapper loads;
    the train steps call no kernel wrapper, the round trip's vocoding does
    (eval mode, K2's wrapper)."""
    from bisinger_tpu_torch.tools import train_vocoder
    from bisinger_tpu_torch.training.vocoder_task import HifiGanTask as Task

    calls, in_steps = [], []
    for name in ("mrf_stage", "mrf_stage_bf16"):
        wrapper = getattr(ph, name)
        monkeypatch.setattr(ph, name, lambda *a, w=wrapper: calls.append(1) or w(*a))
    step = Task.train_step

    def counted(self, *a, **kw):
        before = len(calls)
        out = step(self, *a, **kw)
        in_steps.append(len(calls) - before)
        return out

    monkeypatch.setattr(Task, "train_step", counted)
    for k, v in dict(TV_STEPS=3, TV_BATCH=2, TV_FRAMES=8, TV_CHANNELS=16,
                     TV_OUT=tmp_path / "tv").items():
        monkeypatch.setenv(k, str(v))
    rc = train_vocoder.main(["--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == (0 if summary["ok"] else 1)
    assert in_steps == [0, 0, 0] and len(calls) > 0
    assert summary["steps"] == 3 and np.isfinite(summary["gen_mel_last"])
    assert np.isfinite(summary["disc_loss_last"]) and isinstance(summary["ok"], bool)
    path = latest_generator(str(tmp_path / "tv" / "vocoder"))
    assert path.endswith("generator_000000003.npz")
    _, php = hparams(upsample_initial_channel=16)
    HifiGAN(dict(php, vocoder_ckpt=str(tmp_path / "tv" / "vocoder")), device="cpu")
