"""The rest of the vocoder family against the JAX package, on the CPU at tiny
widths, fp32 on both sides: the Parallel WaveGAN generator and its two
discriminators, the HiFi-GAN with ResBlock2, MelGAN's generator and
multi-scale discriminator, the cyclic-noise source, the host utilities
(denoise, MFCC), RAdam, the cascade served through a PWG, and the
decisions on the reference side's faults (ROADMAP Queue 3).

Tolerances: each module's output within 1e-5 of its largest |value|
(relative max), gradients within 1e-5 of the largest |gradient|; denoise
and MFCC within 1e-6; RAdam's parameters within 1e-6 relative after 10
steps; the cascade at the parity suite's bounds (mel <= 1e-3, waveform <=
2e-3 absolute, tests/test_reference_parity.py:694, :780). Parameters are
seeded numpy draws on both sides; random draws (PWG's z, the cyclic
source's normals) are made once and handed to both.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bisinger_tpu.models.hifigan as jhifigan
import bisinger_tpu.models.melgan as jmelgan
import bisinger_tpu.models.pwg as jpwg
from bisinger_tpu.data.text.frontend import BilingualFrontend as JBilingualFrontend
from bisinger_tpu.inference.pipeline import SVSInfer
from bisinger_tpu.models.diffusion import GaussianDiffusion as JGaussianDiffusion
from bisinger_tpu.models.pe import PitchExtractor as JPitchExtractor
from bisinger_tpu.training.optim import radam as jradam
from bisinger_tpu.training.tasks import DiffSingerMIDITask, PitchExtractionTask
from bisinger_tpu.utils.text_encoder import TokenTextEncoder as JTokenTextEncoder
from bisinger_tpu.vocoders import vocoder_utils as jutils
from bisinger_tpu.vocoders.pwg import PWG as JPWG
from bisinger_tpu_torch.inference.pipeline import SVSInferTorch
from bisinger_tpu_torch.models import hifigan as ph
from bisinger_tpu_torch.models import melgan as pmelgan
from bisinger_tpu_torch.models import pwg as ppwg
from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
from bisinger_tpu_torch.models.pe import PitchExtractor
from bisinger_tpu_torch.training.optim import RAdam
from bisinger_tpu_torch.utils.text_encoder import TokenTextEncoder
from bisinger_tpu_torch.vocoders import vocoder_utils as putils
from bisinger_tpu_torch.vocoders.base_vocoder import get_vocoder_cls
from bisinger_tpu_torch.vocoders.hifigan import HifiGAN
from bisinger_tpu_torch.vocoders.pwg import PWG

from torch_port_helpers import VOCAB, hparams, max_err, noisy, t, to_port

KEY = jax.random.PRNGKey(0)
# a tiny PWG: 4 blocks in 2 dilation cycles, hop 8
PWG_TINY = dict(pwg_layers=4, pwg_stacks=2, pwg_residual_channels=8, pwg_gate_channels=16,
                pwg_skip_channels=8, pwg_aux_channels=80, aux_context_window=2)
PWG_FIELDS = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16, skip_channels=8,
                  aux_channels=80, aux_context_window=2)


def _rel(got, ref):
    return max_err(got, ref) / max(float(np.abs(np.asarray(ref)).max()), 1e-30)


def _draw(shapes, seed, small=()):
    """A seeded numpy draw for every leaf of a flax tree of shapes: kernels at
    unit gain (normal / sqrt(fan-in)), or N(0, 0.03^2) under a top module
    whose name starts with one in `small`; biases N(0, 0.05^2), LayerNorm
    scales near 1."""
    r = np.random.default_rng(seed)

    def leaf(path, sd):
        names = [getattr(p, "key", "") for p in path]
        if names[-1] == "scale":
            return (1.0 + 0.1 * r.standard_normal(sd.shape)).astype(np.float32)
        if names[-1] == "bias":
            return (0.05 * r.standard_normal(sd.shape)).astype(np.float32)
        if small and names[0].startswith(small):
            return (0.03 * r.standard_normal(sd.shape)).astype(np.float32)
        return (r.standard_normal(sd.shape) * np.prod(sd.shape[:-1]) ** -0.5).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _params(module, seed, *args, small=(), **kw):
    return _draw(jax.eval_shape(lambda: module.init(KEY, *args, **kw)["params"]), seed, small)


# ---- Parallel WaveGAN --------------------------------------------------------
@pytest.mark.parametrize("scales,aw", [([4, 2], 2), ([3, 3], 0)])
def test_pwg_generator_matches_jax(tmp_path, scales, aw):
    """The generator (edge-padded VALID conv_in, the shared (2s+1)-tap
    upsample kernels, gated blocks) on one z and mel; the port reads the
    widths from the pwg_* keys, JAX from its fields."""
    hop = int(np.prod(scales))
    jhp, php = hparams(hop_size=hop, pwg_upsample_scales=scales,
                       **dict(PWG_TINY, aux_context_window=aw))
    r = np.random.default_rng(1)
    mel = r.standard_normal((2, 11, 80)).astype(np.float32)
    z = r.standard_normal((2, 11 * hop)).astype(np.float32)
    jm = jpwg.ParallelWaveGANGenerator(hp=jhp, **dict(PWG_FIELDS, aux_context_window=aw))
    params = _params(jm, 2, z, mel)
    ref = np.asarray(jm.apply({"params": params}, z, mel))
    port = to_port(ppwg.ParallelWaveGANGenerator(php), params, tmp_path)
    with torch.no_grad():
        got = port(t(z), t(mel)).numpy()
    assert got.shape == ref.shape == (2, 11 * hop) and np.abs(ref).max() > 1e-2
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("n", [300, 301])
def test_pwg_discriminators_match_jax(tmp_path, n):
    """Both PWG discriminators (the plain one's dilation i, 1 for the
    first) on real-looking noise."""
    wav = (0.3 * np.random.default_rng(n).standard_normal((2, n))).astype(np.float32)
    for jm, pm, seed in (
            (jpwg.ParallelWaveGANDiscriminator(layers=5, conv_channels=8),
             ppwg.ParallelWaveGANDiscriminator(layers=5, conv_channels=8), 3),
            (jpwg.ResidualParallelWaveGANDiscriminator(layers=4, stacks=2, residual_channels=8,
                                                       gate_channels=16, skip_channels=8),
             ppwg.ResidualParallelWaveGANDiscriminator(layers=4, stacks=2, residual_channels=8,
                                                       gate_channels=16, skip_channels=8), 4)):
        params = _params(jm, seed, wav)
        ref = np.asarray(jm.apply({"params": params}, wav))
        with torch.no_grad():
            got = to_port(pm, params, tmp_path).forward(t(wav)).numpy()
        assert got.shape == ref.shape == (2, n)
        assert _rel(got, ref) <= 1e-5, type(pm).__name__
    assert [m.dilation[0] for n_, m in pm.named_modules() if n_.endswith(".conv")] == [1, 2, 1, 2]


def _source_draws(rng, shape, ir_len):
    """The normal draws of JAX's `source_module_cyc_noise(rng)`, by its key
    splits."""
    rng_cyc, rng_noi = jax.random.split(rng)
    rng_pulse, rng_ir = jax.random.split(rng_cyc)
    rng_sine, rng_pn = jax.random.split(rng_pulse)
    n = lambda k, s: np.asarray(jax.random.normal(k, s, jnp.float32))  # noqa: E731
    return dict(sine=n(rng_sine, shape), pulse=n(rng_pn, shape), ir=n(rng_ir, (ir_len,)),
                noise=n(rng_noi, shape))


def test_cyclic_noise_source_matches_jax():
    """pulse_gen, cyclic_noise_gen and source_module_cyc_noise on an f0 with
    unvoiced stretches (sample rate 24 kHz, 480 samples), JAX's draws handed
    to the port: every output within 1e-5 of its largest value."""
    sr, n = 24000, 480
    f0 = np.concatenate([np.zeros(40), np.full(200, 220.0), np.zeros(60),
                         np.linspace(180.0, 320.0, 180)])[None, :, None]
    f0 = np.concatenate([f0, f0[:, ::-1]]).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    ir_len = int(np.ceil(4.6 * sr / 80.0))
    draws = _source_draws(rng, f0.shape, ir_len)
    rng_cyc = jax.random.split(rng)[0]
    rng_pulse = jax.random.split(rng_cyc)[0]
    ref_pulse = jax.jit(lambda f, k: jpwg.pulse_gen(f, k, sr, pulse_amp=1.0))(f0, rng_pulse)
    got_pulse = ppwg.pulse_gen(t(f0), sr, pulse_amp=1.0, draws=draws)
    ref_cyc = jax.jit(lambda f, k: jpwg.cyclic_noise_gen(f, 0.87, k, sr))(f0, rng_cyc)
    got_cyc = ppwg.cyclic_noise_gen(t(f0), 0.87, sr, draws=draws)
    ref_src = jax.jit(lambda f, k: jpwg.source_module_cyc_noise(f, 0.87, k, sr))(f0, rng)
    got_src = ppwg.source_module_cyc_noise(t(f0), 0.87, sr, draws=draws)
    for name, got, ref in (("pulse", got_pulse, ref_pulse), ("cyclic", got_cyc, ref_cyc),
                           ("source", got_src, ref_src)):
        for i, (g, r_) in enumerate(zip(got, ref)):
            r_ = np.asarray(r_)
            assert g.shape == r_.shape and np.abs(r_).max() > 0, (name, i)
            assert _rel(g.numpy(), r_) <= 1e-5, (name, i, _rel(g.numpy(), r_))
    assert float(got_pulse[0].abs().max()) > 0.5  # pulses sit in the voiced stretches


# ---- HiFi-GAN with ResBlock2 -------------------------------------------------
RB2 = dict(resblock="2", use_nsf=False, hop_size=64, upsample_rates=[4, 4, 2, 2],
           upsample_kernel_sizes=[8, 8, 4, 4], upsample_initial_channel=16,
           resblock_kernel_sizes=[3, 5], resblock_dilation_sizes=[[1, 2], [2, 6]])


def test_resblock2_generator_matches_jax(tmp_path, monkeypatch):
    """The plain HiFi-GAN with ResBlock2 stages: the eval-mode waveform, and
    in train mode (the GAN task's pass) the gradient of sum(wav^2) with
    respect to every parameter; K2's wrappers are not called, as JAX runs
    no Pallas kernel for ResBlock2."""
    jhp, php = hparams(**RB2)
    mel = np.random.default_rng(5).standard_normal((2, 12, 80)).astype(np.float32)
    jm = jhifigan.HifiGanGenerator(hp=jhp)
    params = _params(jm, 6, mel, small=("res_", "up_", "conv_post"))
    ref = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, mel))(params))
    port = to_port(ph.HifiGanGenerator(php), params, tmp_path)
    assert isinstance(port.res_0_1, ph.ResBlock2) and not port.resblock1
    for name in ("mrf_stage", "mrf_stage_bf16"):
        monkeypatch.setattr(ph, name, lambda *a, **k: pytest.fail("K2 called"))
    with torch.no_grad():
        got = port(t(mel)).numpy()
    assert got.shape == ref.shape == (2, 12 * 64) and np.abs(ref).max() > 1e-2
    assert _rel(got, ref) <= 1e-5
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, mel) ** 2)))(params)
    port.train()
    (port(t(mel)) ** 2).sum().backward()
    from bisinger_tpu_torch.weights import export_flax_params

    pgrads = export_flax_params(port, {k: p.grad for k, p in port.named_parameters()})
    jflat = {"/".join(getattr(k, "key", "") for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(pgrads) == set(jflat)
    gmax = max(float(np.abs(v).max()) for v in jflat.values())
    worst = max((max_err(pgrads[k], jflat[k]), k) for k in jflat)
    assert worst[0] <= 1e-5 * gmax, worst


def test_resblock2_trains_in_the_gan_task():
    """HifiGanTask builds the ResBlock2 generator (weight norm on its convs)
    and takes a step with finite losses that moves the res_ kernels."""
    from bisinger_tpu_torch.training.vocoder_task import HifiGanTask

    _, php = hparams(**RB2)
    task = HifiGanTask(php, device="cpu")
    assert "res_0_0.conv_1.weight.wn_v" in task.gen_params
    before = task.gen_params["res_0_0.conv_1.weight.wn_v"].detach().clone()
    r = np.random.default_rng(7)
    batch = {"mels": t(r.standard_normal((1, 8, 80)).astype(np.float32)), "f0": None,
             "wav": t((0.1 * r.standard_normal((1, 8 * 64))).astype(np.float32))}
    out = task.train_step(batch, generator=torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in out.values())
    assert not torch.equal(before, task.gen_params["res_0_0.conv_1.weight.wn_v"])


# ---- MelGAN ------------------------------------------------------------------
@pytest.mark.parametrize("frames", [7, 8])
def test_melgan_generator_matches_jax(tmp_path, frames):
    """conv_pre and conv_post reflect-padded, flax's SAME transposed conv
    (k = 2s, stride s; the odd scale 3 pads unevenly), the residual stacks;
    odd and even lengths."""
    over = dict(melgan_upsample_scales=[3, 2], melgan_channels=16)
    jhp, php = hparams(**over)
    mel = np.random.default_rng(frames).standard_normal((2, frames, 80)).astype(np.float32)
    jm = jmelgan.MelGanGenerator(hp=jhp)
    params = _params(jm, 8, mel)
    ref = np.asarray(jm.apply({"params": params}, mel))
    with torch.no_grad():
        got = to_port(pmelgan.MelGanGenerator(php), params, tmp_path).forward(t(mel)).numpy()
    assert got.shape == ref.shape == (2, frames * 6) and np.abs(ref).max() > 1e-2
    assert _rel(got, ref) <= 1e-5


@pytest.fixture(scope="module")
def msd_params():
    wav = np.zeros((1, 512), np.float32)
    return _params(jmelgan.MelGanMultiScaleDiscriminator(), 9, wav)


@pytest.mark.parametrize("n", [1000, 1001])
def test_melgan_msd_matches_jax(tmp_path, msd_params, n):
    """Three scales of strided grouped convs (k41, stride 4, flax's uneven
    SAME padding) and the SAME average pool between them: every logit and
    feature map, odd and even lengths."""
    wav = (0.3 * np.random.default_rng(n).standard_normal((2, n))).astype(np.float32)
    ref = jmelgan.MelGanMultiScaleDiscriminator().apply({"params": msd_params}, wav)
    port = to_port(pmelgan.MelGanMultiScaleDiscriminator(), msd_params, tmp_path)
    with torch.no_grad():
        got = port(t(wav))
    assert len(got) == len(ref) == 3
    for (g_out, g_feats), (r_out, r_feats) in zip(got, ref):
        assert _rel(g_out.numpy(), np.asarray(r_out)) <= 1e-5
        assert len(g_feats) == len(r_feats) == 6
        for gf, rf in zip(g_feats, r_feats):
            rf = np.asarray(rf).transpose(0, 2, 1)  # flax [B, T, C], the port [B, C, T]
            assert gf.shape == rf.shape
            assert _rel(gf.numpy(), rf) <= 1e-5


# ---- host utilities, RAdam -----------------------------------------------------
def test_denoise_and_mfcc_match_jax():
    """The port's copies on a tone in noise: denoise (v = 0.002, 0.05, the
    flagship's STFT sizes) and wav2mfcc within 1e-6."""
    _, php = hparams()
    n = np.arange(47 * 128)  # whole frames: denoise keeps hop * (len // hop) samples
    r = np.random.default_rng(0)
    wav = (0.3 * np.sin(2 * np.pi * 220 * n / 24000) + 0.01 * r.standard_normal(len(n)))
    wav = wav.astype(np.float32)
    for v in (0.002, 0.05):
        ref = jutils.denoise(wav, v=v, hp=php)
        got = putils.denoise(wav, v=v, hp=php)
        assert got.dtype == ref.dtype and got.shape == ref.shape == wav.shape
        assert max_err(got, ref) <= 1e-6
        assert max_err(got, wav) > 1e-4  # it changed the waveform
    ref, got = jutils.wav2mfcc(wav, php), putils.wav2mfcc(wav, php)
    assert got.shape == ref.shape and got.shape[1] == 39
    assert max_err(got, ref) <= 1e-6 * max(1.0, float(np.abs(ref).max()))
    assert np.array_equal(PWG.wav2mfcc(wav, php), got)


@pytest.mark.parametrize("lr,wd", [(1e-2, 0.0), ("schedule", 1e-2)])
def test_radam_matches_jax(lr, wd):
    """10 steps on the same gradients: the first four with rho_t <= 4 (the
    bias-corrected momentum alone), then the rectified ones; a constant rate,
    and a schedule with weight decay. Parameters within 1e-6 relative."""
    r = np.random.default_rng(1)
    p0 = {"a": r.standard_normal((4, 3)).astype(np.float32),
          "b": r.standard_normal((5,)).astype(np.float32)}
    grads = [{k: r.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(10)]
    sched = (lambda count: 1e-2 / (1.0 + 0.1 * count)) if lr == "schedule" else lr
    tx = jradam(sched, weight_decay=wd)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    pp = {k: torch.nn.Parameter(t(v)) for k, v in p0.items()}
    opt = RAdam(pp, sched, weight_decay=wd)
    regimes = []
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in pp.items():
            p.grad = t(g[k])
        regimes.append(opt.scalars(opt.count + 1)[0])
        opt.step()
    assert regimes == [False] * 4 + [True] * 6
    for k in p0:
        assert _rel(pp[k].detach().numpy(), np.asarray(jp[k])) <= 1e-6, k


# ---- the cascade through a PWG ---------------------------------------------------
PHONES = ["AY", "AE", "N", "T", "S", "B", "IY", "UW", "AH", "F", "L", "JH", "AA", "NG", "Y",
          "<AP>", "<SP>"]
SCORES = [dict(item_name="pinyin", text="ai", notes="C4 D4", notes_duration="0.05 0.03"),
          dict(item_name="english", text="oh la", notes="C4 | D4",
               notes_duration="0.06 | 0.05")]


def test_cascade_with_a_pwg_matches_jax(tmp_path):
    """The tiny score -> wav path with a PWG vocoder (hop 128, scales
    4·4·4·2): JAX's staged pieces (`SVSInfer.forward_model`: durations from
    the predictor, PE f0; then `PWG._forward` with z) against the port's
    synthesize and infer_batch with the start noise and z pinned."""
    over = dict(bucket_tokens=[8], bucket_frames=[24], vocoder="bisinger_tpu.vocoders.pwg.PWG",
                **PWG_TINY)
    jhp, php = hparams(**over)
    items = [JBilingualFrontend(JTokenTextEncoder(PHONES, replace_oov=","))(sc) for sc in SCORES]
    batch = SVSInfer.items_to_batch(types.SimpleNamespace(hp=jhp), items)
    b, t_mel = batch["mels"].shape[:2]
    jm = JGaussianDiffusion(hp=jhp, vocab_size=VOCAB)
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        mel2ph=np.ones((b, t_mel), np.int64), txt_tokens=batch["txt_tokens"],
        spk_embed=batch["spk_ids"],
        **{k: batch[k] for k in ("pitch_midi", "midi_dur", "is_slur", "lang", "speechsing")},
        method=JGaussianDiffusion.init_path))()["params"]
    params = noisy(dict(params), ("denoise_fn", "output_projection", "kernel"), 3, 0.2)
    params["fs2"] = dict(params["fs2"])
    lin = params["fs2"]["dur_predictor"]["linear"]
    lin["bias"] = np.asarray(lin["bias"]) + 1.2  # ~2-3 frames a token
    pe_vars = jax.jit(lambda: JPitchExtractor(hp=jhp).init(
        jax.random.PRNGKey(4), jnp.zeros((b, t_mel, 80))))()
    jvoc = JPWG(jhp, params={})
    jvoc.model = jpwg.ParallelWaveGANGenerator(hp=jhp, **PWG_FIELDS)
    z = np.random.default_rng(2).standard_normal((b, t_mel * 128)).astype(np.float32)
    jvoc.params = _params(jvoc.model, 5, z, np.zeros((b, t_mel, 80), np.float32))
    staged = types.SimpleNamespace(params=params, task=DiffSingerMIDITask(jhp, VOCAB),
                                   pe_task=PitchExtractionTask(jhp), pe_params=pe_vars)
    rng = jax.random.PRNGKey(9)
    out = SVSInfer.forward_model(staged, batch, rng)
    wav_ref = np.asarray(jvoc._forward(jvoc.params, z, out["mel_out"]))
    assert np.abs(wav_ref).max() > 1e-3

    svs = SVSInferTorch(
        php, to_port(GaussianDiffusion(php, VOCAB), params, tmp_path, "diff.npz"),
        to_port(PitchExtractor(php), pe_vars["params"], tmp_path, "pe.npz",
                extra=pe_vars["batch_stats"]),
        to_port(ppwg.ParallelWaveGANGenerator(php), jvoc.params, tmp_path, "voc.npz"),
        device="cpu", encoder=TokenTextEncoder(PHONES, replace_oov=","))
    assert isinstance(svs.voc, PWG)
    start = t(np.asarray(jax.random.normal(jax.random.split(rng)[0], (b, t_mel, 80))))
    got = svs.synthesize(svs.items_to_batch(svs.score_items(SCORES)), start_noise=start,
                         pwg_z=t(z))
    np.testing.assert_array_equal(got["mel2ph"].numpy(), out["mel2ph"])
    assert max_err(got["mel"].numpy(), out["mel_out"]) <= 1e-3
    assert max_err(got["wav"].numpy(), wav_ref) <= 2e-3
    wavs = svs.infer_batch(SCORES, start_noise=start, pwg_z=t(z))
    filled = (out["mel2ph"] > 0).sum(axis=1)
    for i, wav in enumerate(wavs):
        ref_i = wav_ref[i][: max(int(filled[i]), 1) * 128]
        assert wav.shape == ref_i.shape and max_err(wav, ref_i) <= 2e-3


def _work_dir(tmp_path, hp):
    """A DiffSingerMIDITask work dir (config.json, one checkpoint) and its
    binarizer's phone set, at the tiny widths of `hp`."""
    import json

    from bisinger_tpu_torch.training.checkpoints import CheckpointManager
    from bisinger_tpu_torch.training.tasks import DiffSingerMIDITask as PortMIDITask

    binary, work = tmp_path / "binary", tmp_path / "work"
    binary.mkdir()
    (work / "ckpt").mkdir(parents=True)
    with open(binary / "phone_set.json", "w") as f:
        json.dump(PHONES, f)
    with open(binary / "spk_map.json", "w") as f:
        json.dump({"a": 0}, f)
    hp = dict(hp, binary_data_dir=str(binary),
              task_cls="usr.diffsinger_task.DiffSingerMIDITask")
    with open(work / "config.json", "w") as f:
        json.dump(hp, f)
    state = PortMIDITask(hp, VOCAB, device="cpu").state()
    CheckpointManager(str(work / "ckpt")).save(1, state["params"], state["opt_state"],
                                               torch.Generator().get_state())
    return str(work)


def test_work_dir_served_with_the_assets_dirs_multiband_vocoder(tmp_path):
    """Repair: `from_work_dir` built the PQMF from the acoustic run's config,
    so an assets dir's mb4 generator (its own config: `vocoder_multiband`
    4) came out as 4 subbands at a quarter of the rate, not a waveform. The
    wrapper now builds the PQMF from the vocoder's config."""
    import json

    from bisinger_tpu_torch.weights import export_flax_params

    _, hp = hparams(pe_enable=False)
    _, vhp = hparams(upsample_rates=[8, 4], upsample_kernel_sizes=[16, 8],
                     vocoder_multiband=4, upsample_initial_channel=16)
    assets = tmp_path / "assets"
    (assets / "vocoder_mb4").mkdir(parents=True)
    with open(assets / "hparams_diff.json", "w") as f:
        json.dump(vhp, f)
    np.savez(assets / "vocoder_mb4" / "generator_000000001.npz",
             **export_flax_params(ph.HifiGanGenerator(vhp)))
    svs = SVSInferTorch.from_work_dir(_work_dir(tmp_path, hp), str(assets), device="cpu")
    assert svs.vocoder.multiband == 4 and svs.voc.pqmf is not None
    out = svs.synthesize(svs.items_to_batch(svs.score_items(SCORES[:1])))
    assert out["wav"].shape == (1, out["mel"].shape[1] * 128)


# ---- decisions on the reference side's faults (ROADMAP Queue 3) ------------------
def test_decision_pwg_scales_must_multiply_to_hop():
    """Fault 1: JAX's PWG reads only pwg_upsample_scales (default 4·4·4·2 =
    128), so configs/tts/pwg.yaml at its inherited hop of 256 fails on a
    shape mismatch inside the generator. The port raises a ValueError that
    names both numbers, and builds at a hop-128 override."""
    from bisinger_tpu.config import load_hparams as jload
    from bisinger_tpu_torch.config import load_hparams

    jhp = jload("configs/tts/pwg.yaml", dict(PWG_TINY))
    assert jhp["hop_size"] == 256
    jm = jpwg.ParallelWaveGANGenerator(hp=jhp, **PWG_FIELDS)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda: jm.init(KEY, jnp.zeros((1, 4 * 256)), jnp.zeros((1, 4, 80))))
    php = load_hparams("configs/tts/pwg.yaml", dict(PWG_TINY))
    with pytest.raises(ValueError, match=r"multiply to 128, hop_size is 256"):
        ppwg.ParallelWaveGANGenerator(php)
    assert ppwg.ParallelWaveGANGenerator(dict(php, hop_size=128)).hop == 128


def test_decision_pwg_reads_its_width_keys():
    """Fault 2: JAX's generator ignores pwg.yaml's pwg_* width keys and
    aux_context_window and takes its fields' defaults, which equal the
    YAML's values; the port reads the keys (with those defaults), so at the
    YAML's values both have the same parameters, and a changed key changes
    the port's model only."""
    from bisinger_tpu.config import load_hparams as jload
    from bisinger_tpu_torch.config import load_hparams

    jhp = jload("configs/tts/pwg.yaml", dict(hop_size=128))
    php = load_hparams("configs/tts/pwg.yaml", dict(hop_size=128))
    shapes = jax.eval_shape(lambda: jpwg.ParallelWaveGANGenerator(hp=jhp).init(
        KEY, jnp.zeros((1, 256)), jnp.zeros((1, 2, 80)))["params"])
    jcount = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    port = ppwg.ParallelWaveGANGenerator(php)
    assert sum(p.numel() for p in port.parameters()) == jcount
    assert port.layers == 30 and port.block_29.conv.dilation[0] == 2 ** 9
    jhp6 = jload("configs/tts/pwg.yaml", dict(hop_size=128, pwg_layers=6))
    assert len([k for k in jax.eval_shape(lambda: jpwg.ParallelWaveGANGenerator(hp=jhp6).init(
        KEY, jnp.zeros((1, 256)), jnp.zeros((1, 2, 80)))["params"]) if "block" in k]) == 30
    assert ppwg.ParallelWaveGANGenerator(dict(php, pwg_layers=6)).layers == 6


def test_decision_pwg_is_served_in_batches(tmp_path):
    """Fault 3: JAX's fused serving path calls `voc._forward(params, mel,
    f0, rng)` (use_nsf) or `voc._forward_no_f0` on any vocoder with a
    `_forward`; a PWG's is `_forward(params, z, mel)` and it has no
    `_forward_no_f0`, so `infer_once` and `infer_batch` cannot serve one.
    The port hands a PWG the mel and z in `synthesize` (test above) and in
    the wrappers' batched call."""
    jhp, php = hparams(hop_size=8, pwg_upsample_scales=[4, 2], **PWG_TINY)
    jvoc = JPWG(jhp, params={})
    jvoc.model = jpwg.ParallelWaveGANGenerator(hp=jhp, **PWG_FIELDS)
    mel = np.random.default_rng(3).standard_normal((2, 6, 80)).astype(np.float32)
    jvoc.params = _params(jvoc.model, 5, np.zeros((2, 48), np.float32), mel)
    assert not hasattr(jvoc, "_forward_no_f0")
    with pytest.raises(TypeError):
        jvoc._forward(jvoc.params, mel, np.full((2, 6), 200.0, np.float32), KEY)
    port = to_port(ppwg.ParallelWaveGANGenerator(php), jvoc.params, tmp_path)
    voc = PWG(php, device="cpu", model=port)
    wavs = voc.spec2wav_batch(mel, np.full((2, 6), 200.0, np.float32))
    assert wavs.shape == (2, 48) and np.isfinite(wavs).all()
    z = torch.randn((2, 48), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert np.array_equal(wavs, port(z, t(mel)).numpy())  # z from the seeded generator
    assert np.array_equal(voc.spec2wav(mel[0])[None], voc.spec2wav_batch(mel[:1]))


def test_decision_run_infer_builds_the_named_vocoder(tmp_path, monkeypatch):
    """Fault 4: JAX's `run --infer` builds `HifiGAN(hp)` whatever `vocoder`
    names (`bisinger_tpu/run.py:123-126`): here with configs/tts/pwg.yaml's
    PWG. The port's registry resolves dotted names by their last part, and
    `run --infer` serves through the class named (the PWG's cascade above)."""
    import bisinger_tpu.inference.pipeline as jpipe
    import bisinger_tpu.run as jrun
    import bisinger_tpu.vocoders.hifigan as jvh

    built = []

    class Stop(Exception):
        pass

    monkeypatch.setattr(jvh, "HifiGAN", lambda hp: built.append(hp["vocoder"]))

    def stop(*a, **k):
        raise Stop()

    monkeypatch.setattr(jpipe.SVSInfer, "from_work_dir", stop)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(Stop):
        jrun.main(["--config", f"{jrun.__file__.rsplit('/bisinger_tpu/', 1)[0]}/configs/tts/"
                   "pwg.yaml", "--exp_name", "x", "--infer", "--input", "s.json",
                   "--hparams", "vocoder_ckpt=voc"])
    assert built == ["bisinger_tpu.vocoders.pwg.PWG"]
    assert get_vocoder_cls({"vocoder": "bisinger_tpu.vocoders.pwg.PWG"}) is PWG
    assert get_vocoder_cls("vocoders.hifigan.HifiGAN") is HifiGAN
    assert get_vocoder_cls({"vocoder": "pwg"}) is PWG
    with pytest.raises(ValueError, match="MelGAN"):
        get_vocoder_cls("bisinger_tpu.vocoders.melgan.MelGAN")


def test_use_denoise_is_applied_after_the_batch(tmp_path):
    """`use_denoise` with `denoise_v`: the wrapper's batch is each
    waveform denoised on the host as JAX's `spec2wav_batch` does (its
    generator on the same weights, same draws), and no longer refused."""
    from bisinger_tpu.vocoders.hifigan import HifiGAN as JHifiGAN

    over = dict(RB2, resblock="1", resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1]],
                use_denoise=True, denoise_v=0.01, hop_size=64, fft_size=256, win_size=256)
    jhp, php = hparams(**over)
    mel = np.random.default_rng(8).standard_normal((2, 12, 80)).astype(np.float32)
    jv = JHifiGAN.__new__(JHifiGAN)
    jv.hp, jv.model, jv.pqmf = jhp, jhifigan.HifiGanGenerator(hp=jhp), None
    jv.params = _params(jv.model, 6, mel, small=("res_", "up_", "conv_post"))
    ref = jv.spec2wav_batch(mel)
    voc = HifiGAN(php, device="cpu", model=to_port(ph.HifiGanGenerator(php), jv.params,
                                                    tmp_path))
    got = voc.spec2wav_batch(mel)
    assert got.shape == ref.shape == (2, 12 * 64)
    assert max_err(got, ref) <= 1e-5
    plain = HifiGAN(dict(php, use_denoise=False), device="cpu", model=voc.model)
    assert max_err(plain.spec2wav_batch(mel), got) > 1e-3
    assert np.array_equal(voc.spec2wav(mel[1]), got[1])
