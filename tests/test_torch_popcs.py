"""The pitch-conditioned DiffSinger family of the port (DiffSinger's PopCS
systems) against the JAX package, on the CPU at the tiny widths of
torch_port_helpers, fp32: the plain FastSpeech2's forward (frame pitch
with uv, given and predicted; phone-level pitch; the energy embedding),
the pitch and energy losses, the offline and the plain diffusion models'
inference, PLMS at PopCS's schedule (T=100, K=51, pndm_speedup 1) with its
denoiser calls counted on both sides, and a non-MIDI work dir served from
a phoneme-level score to a waveform with f0 from the model's own pitch
predictor.

Tolerances: the forward outputs within 1e-5 of max(1, the output's largest
|value|) (both sides fp32, sums in another order); the losses 1e-6
absolute; the inference and serving bounds of
tests/test_reference_parity.py: mel 1e-3 (:694), f0 1 Hz (:719), waveform
2e-3 (:780). The random legs are pinned as that file pins them: the
diffusion start is the JAX rng's draw (`split(rng)[0]`), DDPM's step noise
the JAX rng's draw at each step, the NSF phase and noise numpy draws
handed to both sides.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bisinger_tpu.data.text.frontend import BilingualFrontend as JBilingualFrontend
from bisinger_tpu.inference.pipeline import SVSInfer
from bisinger_tpu.models.diffusion import GaussianDiffusion as JGaussianDiffusion
from bisinger_tpu.models.diffusion import OfflineGaussianDiffusion as JOfflineDiffusion
from bisinger_tpu.models.diffusion import PlainGaussianDiffusion as JPlainDiffusion
from bisinger_tpu.models.fs2 import FastSpeech2 as JFastSpeech2
from bisinger_tpu.models.hifigan import HifiGanGenerator as JHifiGanGenerator
from bisinger_tpu.training import losses as JL
from bisinger_tpu.training.tasks import DiffSingerMIDITask as JDiff
from bisinger_tpu.training.trainer import device_batch
from bisinger_tpu.utils.text_encoder import TokenTextEncoder as JTokenTextEncoder
from bisinger_tpu.vocoders.hifigan import flatten_params, unflatten_params
from bisinger_tpu_torch.inference.pipeline import SVSInferTorch
from bisinger_tpu_torch.models.diffusion import (
    GaussianDiffusion,
    OfflineGaussianDiffusion,
    PlainGaussianDiffusion,
)
from bisinger_tpu_torch.models.fs2 import FastSpeech2
from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
from bisinger_tpu_torch.training import losses as L
from bisinger_tpu_torch.training.checkpoints import CheckpointManager
from bisinger_tpu_torch.training.tasks import DiffSingerMIDITask, flax_init_
from bisinger_tpu_torch.training.vocoder_task import flax_init_ as voc_init_
from bisinger_tpu_torch.weights import export_flax_params

from torch_port_helpers import VOCAB, hparams, max_err, midi_batch, noisy, t, to_port

B, NT, T, M = 2, 8, 24, 80
POPCS = dict(use_midi=False, use_pitch_embed=True, pitch_type="frame", use_uv=True,
             use_energy_embed=False)


def _inputs(seed=0, ph=False):
    """Tokens, a frame map and speakers (midi_batch), log2 f0 around 160-390
    Hz with about a third of the frames unvoiced, and energies in [0, 4)."""
    batch = midi_batch(b=B, n_tokens=NT, n_frames=T, seed=seed)
    r = np.random.default_rng(seed + 100)
    n = NT if ph else T
    f0 = r.uniform(7.3, 8.6, (B, n)).astype(np.float32)
    uv = (r.random((B, n)) < 0.3).astype(np.float32)
    energy = r.uniform(0.0, 4.0, (B, T)).astype(np.float32)
    return batch, f0, uv, energy


def _bias(params, path, add):
    """A head's bias moved by `add`: f0 near 220 Hz, voiced, energies near
    the middle of their 256 bins, where a fresh head would sit at 0."""
    node = params
    for key in path:
        node[key] = dict(node[key])
        node = node[key]
    node["bias"] = np.asarray(node["bias"]) + np.asarray(add, np.float32)


CASES = {
    "frame, f0 and uv given": (dict(), True, False),
    "frame, f0 and uv predicted, energy predicted": (dict(use_energy_embed=True), False, False),
    "frame, f0, uv and energy given": (dict(use_energy_embed=True), True, True),
    "ph, f0 given": (dict(pitch_type="ph"), True, False),
    "ph, f0 predicted": (dict(pitch_type="ph"), False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_fs2_forward_matches_flax(tmp_path, case):
    over, give_f0, give_energy = CASES[case]
    jhp, hp = hparams(**dict(POPCS, **over))
    ph = hp["pitch_type"] == "ph"
    batch, f0, uv, energy = _inputs(seed=len(case), ph=ph)
    jm = JFastSpeech2(hp=jhp, vocab_size=VOCAB)
    kw = dict(txt_tokens=batch["txt_tokens"], mel2ph=batch["mel2ph"],
              spk_embed=batch["spk_ids"], f0=f0 if give_f0 else None,
              uv=None if ph or not give_f0 else uv,
              energy=energy if give_energy else None)
    # flax's initialisers, drawn on the port's side (a JAX init costs a compile)
    m = flax_init_(FastSpeech2(hp, VOCAB), 3)
    params = dict(unflatten_params(export_flax_params(m)))
    _bias(params, ("pitch_predictor", "linear"), [7.8] if ph else [7.8, -0.5])
    if hp["use_energy_embed"]:
        _bias(params, ("energy_predictor", "linear"), [2.0])
    ref = jax.jit(lambda: jm.apply({"params": params}, **kw))()
    m = to_port(m, params, tmp_path)
    with torch.no_grad():
        # ref_mels, as a training call passes them, runs the duration predictor
        got = m(t(batch["txt_tokens"]), mel2ph=t(batch["mel2ph"]), spk_id=t(batch["spk_ids"]),
                ref_mels=torch.zeros(B, T, M),
                **{k: None if kw[k] is None else t(kw[k]) for k in ("f0", "uv", "energy")})
    keys = {"decoder_inp", "mel_out", "dur", "pitch_pred", "f0_denorm"} | (
        {"energy_pred"} if hp["use_energy_embed"] else set())
    assert keys <= set(got) and keys <= set(ref)
    np.testing.assert_array_equal(got["mel2ph"].numpy(), np.asarray(ref["mel2ph"]))
    for k in keys:
        want = np.asarray(ref[k])
        assert max_err(got[k].numpy(), want) <= 1e-5 * max(1.0, np.abs(want).max()), k
    f0_hz = np.asarray(ref["f0_denorm"])
    # the case reaches the pitch embedding: voiced frames at 100-500 Hz
    assert ((f0_hz > 100) & (f0_hz < 500)).mean() > 0.3


def test_pitch_and_energy_losses_match_jax():
    """Frame pitch (f0 on the voiced frames, uv's BCE), phone-level pitch,
    the CWT head's losses (the spectrogram's l1 or l2, uv's BCE, the log-f0
    mean and std) and the energy MSE on random inputs: within 1e-6; an
    unknown cwt_loss raises, as in JAX."""
    r = np.random.default_rng(0)
    txt = np.zeros((2, 10), np.int64)
    txt[:, :8] = r.integers(1, 20, (2, 8))
    mel2ph = np.zeros((2, 24), np.int64)
    mel2ph[:, :20] = np.sort(r.integers(1, 9, (2, 20)), axis=1)
    uv = (r.random((2, 24)) < 0.3).astype(np.float32)
    energy = r.uniform(0, 4, (2, 24)).astype(np.float32)
    energy[:, 20:] = 0
    cases = [
        (dict(pitch_type="frame", use_uv=True, pitch_loss="l1"), (2, 24, 2), (2, 24)),
        (dict(pitch_type="frame", use_uv=False, pitch_loss="l2"), (2, 24, 2), (2, 24)),
        (dict(pitch_type="ph", use_uv=False, pitch_loss="l1"), (2, 10, 1), (2, 10)),
    ]
    for over, pred_shape, f0_shape in cases:
        hp = dict(over, lambda_f0=1.0, lambda_uv=0.5, lambda_energy=0.1)
        ret = dict(pitch_pred=r.standard_normal(pred_shape).astype(np.float32),
                   energy_pred=r.uniform(0, 4, (2, 24)).astype(np.float32))
        sample = dict(txt_tokens=txt, mel2ph=mel2ph, uv=uv,
                      f0=r.standard_normal(f0_shape).astype(np.float32), energy=energy)
        pl, jl = {}, {}
        L.add_pitch_loss({k: t(v) for k, v in ret.items()}, {k: t(v) for k, v in sample.items()},
                         pl, hp)
        JL.add_pitch_loss({k: jnp.asarray(v) for k, v in ret.items()},
                          {k: jnp.asarray(v) for k, v in sample.items()}, jl, hp)
        L.add_energy_loss(t(ret["energy_pred"]), t(energy), pl, hp)
        JL.add_energy_loss(jnp.asarray(ret["energy_pred"]), jnp.asarray(energy), jl, hp)
        assert set(pl) == set(jl) == ({"f0", "e"} | ({"uv"} if over["use_uv"] else set()))
        for k in jl:
            np.testing.assert_allclose(float(pl[k]), float(jl[k]), rtol=0, atol=1e-6,
                                       err_msg=f"{over} {k}")
    # the CWT head's losses (the TTS configs'), l1 and l2, with and without uv
    for over in (dict(cwt_loss="l1", use_uv=True), dict(cwt_loss="l2", use_uv=False)):
        hp = dict(over, pitch_type="cwt", lambda_f0=1.0, lambda_uv=0.5)
        ret = dict(cwt=r.standard_normal((2, 24, 11 if over["use_uv"] else 10)).astype(
            np.float32), f0_mean=r.normal(5.4, 0.2, 2).astype(np.float32),
            f0_std=r.uniform(0.1, 0.3, 2).astype(np.float32))
        sample = dict(mel2ph=mel2ph, uv=uv, cwt_spec=r.standard_normal((2, 24, 10)).astype(
            np.float32), f0_mean=r.normal(5.4, 0.2, 2).astype(np.float32),
            f0_std=r.uniform(0.1, 0.3, 2).astype(np.float32))
        pl, jl = {}, {}
        L.add_pitch_loss({k: t(v) for k, v in ret.items()}, {k: t(v) for k, v in sample.items()},
                         pl, hp)
        JL.add_pitch_loss({k: jnp.asarray(v) for k, v in ret.items()},
                          {k: jnp.asarray(v) for k, v in sample.items()}, jl, hp)
        assert set(pl) == set(jl) == ({"C", "f0_mean", "f0_std"}
                                      | ({"uv"} if over["use_uv"] else set()))
        for k in jl:
            np.testing.assert_allclose(float(pl[k]), float(jl[k]), rtol=0, atol=1e-6,
                                       err_msg=f"{over} {k}")
    with pytest.raises(NotImplementedError, match="cwt_loss"):
        L.add_pitch_loss(ret, sample, {}, dict(hp, cwt_loss="ssim"))


def _counted(model):
    calls = []
    real = model.denoise_fn.forward
    model.denoise_fn.forward = lambda *a, **k: calls.append(1) or real(*a, **k)
    return calls


def _ddpm_draws(rng_loop, k, shape):
    draws, key = [], rng_loop
    for _ in range(k):
        key, step_key = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(step_key, shape)))
    return t(np.stack(draws))


@pytest.mark.parametrize("fast", [False, True])
def test_offline_diffusion_inference_matches_jax(tmp_path, fast):
    """From a recorded fs2 mel and the given frame map, the offline model's
    K-step DDPM loop (or PLMS, with offline_fast_sampler) against flax's;
    the conditioner has no decoder on either side."""
    jhp, hp = hparams(**POPCS, K_step=10, offline_fast_sampler=fast, gaussian_start=False)
    batch, f0, uv, _ = _inputs(seed=7)
    mels = np.random.default_rng(8).normal(-4, 1, (B, T, M)).astype(np.float32)
    fs2_mels = mels + np.random.default_rng(9).normal(0, 0.3, (B, T, M)).astype(np.float32)
    jm = JOfflineDiffusion(hp=jhp, vocab_size=VOCAB)
    kw = dict(txt_tokens=batch["txt_tokens"], mel2ph=batch["mel2ph"],
              spk_embed=batch["spk_ids"])
    model = flax_init_(OfflineGaussianDiffusion(hp, VOCAB), 0)
    params = noisy(dict(unflatten_params(export_flax_params(model))),
                   ("denoise_fn", "output_projection", "kernel"), 3, 0.2)
    assert not any(k.startswith(("fs2/decoder/", "fs2/mel_out/")) for k in flatten_params(params))
    rng = jax.random.PRNGKey(5)
    ref = np.asarray(jax.jit(lambda: jm.apply({"params": params}, ref_mels=(mels, fs2_mels),
                                              infer=True, rng=rng, rngs={"diffusion": rng},
                                              **kw))()["mel_out"])
    rng_start, rng_loop = jax.random.split(rng)
    pins = dict(start_noise=t(np.asarray(jax.random.normal(rng_start, (B, T, M)))))
    if not fast:
        pins["step_noise"] = _ddpm_draws(rng_loop, hp["K_step"], (B, T, M))
    model = to_port(model, params, tmp_path)
    calls = _counted(model)
    with torch.no_grad():
        got = model(t(batch["txt_tokens"]), mel2ph=t(batch["mel2ph"]), fs2_mels=t(fs2_mels),
                    spk_id=t(batch["spk_ids"]), **pins)["mel_out"].numpy()
    assert len(calls) == (10 // 5 + 1 if fast else 10)
    assert np.abs(ref - fs2_mels).max() > 1e-2
    assert max_err(got, ref) <= 1e-3


def test_plain_diffusion_inference_matches_jax(tmp_path):
    """PlainGaussianDiffusion diffuses over every step (K_step is timesteps,
    whatever the config's K_step): from a gaussian start, PLMS over T=40 at
    pndm_speedup 5, from tokens through predicted durations."""
    jhp, hp = hparams(**POPCS, K_step=7, gaussian_start=True)
    batch, _, _, _ = _inputs(seed=11)
    jm = JPlainDiffusion(hp=jhp, vocab_size=VOCAB)
    kw = dict(txt_tokens=batch["txt_tokens"], spk_embed=batch["spk_ids"])
    model = flax_init_(PlainGaussianDiffusion(hp, VOCAB), 0)
    params = noisy(dict(unflatten_params(export_flax_params(model))),
                   ("denoise_fn", "output_projection", "kernel"), 3, 0.2)
    params["fs2"] = dict(params["fs2"])
    _bias(params["fs2"], ("dur_predictor", "linear"), [1.2])
    _bias(params["fs2"], ("pitch_predictor", "linear"), [7.8, -0.5])
    rng = jax.random.PRNGKey(6)
    ret = jax.jit(lambda: jm.apply({"params": params}, mel2ph=None, infer=True, rng=rng,
                                   max_frames=T, rngs={"diffusion": rng}, **kw))()
    model = to_port(model, params, tmp_path)
    assert model.K_step == 40
    calls = _counted(model)
    start = np.asarray(jax.random.normal(jax.random.split(rng)[0], (B, T, M)))
    with torch.no_grad():
        got = model(t(batch["txt_tokens"]), spk_id=t(batch["spk_ids"]), max_frames=T,
                    start_noise=t(start))
    assert len(calls) == 40 // 5 + 1
    np.testing.assert_array_equal(got["mel2ph"].numpy(), np.asarray(ret["mel2ph"]))
    assert (np.asarray(ret["mel2ph"]) > 0).sum() > B * 4
    assert max_err(got["mel_out"].numpy(), np.asarray(ret["mel_out"])) <= 1e-3
    assert max_err(got["f0_denorm"].numpy(), np.asarray(ret["fs2"]["f0_denorm"])
                   if "fs2" in ret else np.asarray(ret["f0_denorm"])) <= 1.0


def test_popcs_plms_schedule_counts_and_matches_jax(tmp_path):
    """PopCS's sampler (linear betas to 0.06 over T=100, shallow start at
    K=51, PLMS at pndm_speedup 1, which JAX's dispatch takes as PLMS): the
    port calls its denoiser K/speedup + 1 = 52 times, as JAX's loop does
    (counted on the JAX side with a host callback in the denoiser, inside
    the scan), and the mel agrees."""
    jhp, hp = hparams(**POPCS, timesteps=100, K_step=51, max_beta=0.06, schedule_type="linear",
                      gaussian_start=False, pndm_speedup=1)
    batch, _, _, _ = _inputs(seed=13)
    jm = JGaussianDiffusion(hp=jhp, vocab_size=VOCAB)
    kw = dict(txt_tokens=batch["txt_tokens"], mel2ph=batch["mel2ph"],
              spk_embed=batch["spk_ids"])
    model = flax_init_(GaussianDiffusion(hp, VOCAB), 0)
    params = noisy(dict(unflatten_params(export_flax_params(model))),
                   ("denoise_fn", "output_projection", "kernel"), 3, 0.2)
    rng = jax.random.PRNGKey(7)
    jax_calls = []

    def counted_apply():
        def run(m, **kw):
            real = type(m.denoise_fn).__call__

            def dn(self, *a, **k):
                jax.debug.callback(lambda: jax_calls.append(1))
                return real(self, *a, **k)

            type(m.denoise_fn).__call__ = dn
            try:
                return m(**kw)
            finally:
                type(m.denoise_fn).__call__ = real

        return jm.apply({"params": params}, infer=True, rng=rng, rngs={"diffusion": rng},
                        method=run, **kw)

    ret = jax.jit(counted_apply)()
    mel_ref = np.asarray(ret["mel_out"])
    jax.effects_barrier()
    model = to_port(model, params, tmp_path)
    calls = _counted(model)
    start = np.asarray(jax.random.normal(jax.random.split(rng)[0], (B, T, M)))
    with torch.no_grad():
        got = model(t(batch["txt_tokens"]), mel2ph=t(batch["mel2ph"]),
                    spk_id=t(batch["spk_ids"]), start_noise=t(start))
    assert len(calls) == len(jax_calls) == 51 // 1 + 1 == 52
    assert max_err(got["mel_out"].numpy(), mel_ref) <= 1e-3


# the synthetic PopCS corpus's phone set (data/synthetic.py, fmt "popcs")
PHONES = ["<SP>", "a", "ang", "ao", "h", "i", "in", "l", "m", "sh", "x"]
SCORE = dict(item_name="popcs", input_type="phoneme", ph_seq="<SP> sh ang x in h ao m a <SP>",
             note_seq="rest C4 C4 D4 D4 E4 E4 G4 G4 rest",
             note_dur_seq="0.05 0.1 0.1 0.1 0.1 0.1 0.1 0.15 0.15 0.05",
             is_slur_seq=" ".join(["0"] * 10), lang_seq=" ".join(["1"] * 10))


def test_non_midi_work_dir_serves_a_score_as_jax(tmp_path):
    """A DiffSingerMIDITask work dir with use_midi off (the plain FastSpeech2
    with frame pitch and uv) served by `SVSInferTorch.from_work_dir` with
    pe_enable off: the phoneme-level score through the front end, the batch
    JAX's items_to_batch builds, durations predicted, PLMS from the shallow
    start, f0 from the model's pitch predictor (JAX's `f0_denorm` when no PE
    is enabled, `inference/pipeline.py:253-259`), then the vocoder from the
    assets dir. Against JAX's front end, items_to_batch and infer_step."""
    jhp, hp = hparams(**POPCS, gaussian_start=False, pe_enable=False, num_spk=1,
                      bucket_tokens=[16], bucket_frames=[64], bucket_batch_sizes=[1, 2])
    binary = tmp_path / "binary"
    binary.mkdir()
    with open(binary / "phone_set.json", "w") as f:
        json.dump(PHONES, f)
    with open(binary / "spk_map.json", "w") as f:
        json.dump({"pop-cs": 0}, f)
    jhp = jhp.replace(binary_data_dir=str(binary))
    hp = dict(hp, binary_data_dir=str(binary), task_cls="usr.diffsinger_task.DiffSingerTask")
    vocab = len(PHONES) + 3  # the encoder's reserved ids first

    items = [JBilingualFrontend(JTokenTextEncoder(PHONES, replace_oov=","))(SCORE, {})]
    batch = SVSInfer.items_to_batch(types.SimpleNamespace(hp=jhp), items)
    b, t_mel = batch["mels"].shape[:2]
    jtask = JDiff(jhp, vocab)
    # both models' parameters as flax initialises them, drawn on the port's
    # side (JAX's inits cost a compile each)
    task = DiffSingerMIDITask(hp, vocab, device="cpu")
    params = dict(unflatten_params(export_flax_params(task.model)))
    params = noisy(params, ("denoise_fn", "output_projection", "kernel"), 3, 0.2)
    params["fs2"] = dict(params["fs2"])
    _bias(params["fs2"], ("dur_predictor", "linear"), [1.2])
    _bias(params["fs2"], ("pitch_predictor", "linear"), [7.8, -1.0])
    rng = jax.random.PRNGKey(9)
    ret = jtask.infer_step(params, device_batch(batch), rng)
    mel_ref, mel2ph_ref = np.asarray(ret["mel_out"]), np.asarray(ret["mel2ph"])
    f0_ref = np.asarray(ret["f0_denorm"])
    jvoc = JHifiGanGenerator(hp=jhp)
    voc_params = unflatten_params(export_flax_params(voc_init_(
        HifiGanGenerator(hp), 5, small=("res_", "up_", "conv_post"))))
    r = np.random.default_rng(10)
    phase = r.uniform(size=(b, 9)).astype(np.float32)
    noise = r.standard_normal((b, t_mel * 128, 9)).astype(np.float32)

    def vocode(mel, f0):  # the NSF draws pinned while the function is traced
        saved = jax.random.uniform, jax.random.normal
        jax.random.uniform = lambda key, shape=(), dtype=jnp.float32, **kw: jnp.asarray(
            phase, dtype)
        jax.random.normal = lambda key, shape=(), dtype=jnp.float32, **kw: jnp.asarray(
            noise, dtype)
        try:
            return jvoc.apply({"params": voc_params}, mel, f0, rngs={"nsf": jax.random.PRNGKey(7)})
        finally:
            jax.random.uniform, jax.random.normal = saved

    wav_ref = np.asarray(jax.jit(vocode)(mel_ref, f0_ref))

    # the port's work dir (config.json, ckpt/1/params.npz) and assets dir
    # (hparams_diff.json, vocoder/generator_*.npz)
    work, assets = tmp_path / "work", tmp_path / "assets"
    task.load_state({k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()})
    (work / "ckpt").mkdir(parents=True)
    with open(work / "config.json", "w") as f:
        json.dump(hp, f)
    state = task.state()
    CheckpointManager(str(work / "ckpt")).save(1, state["params"], state["opt_state"],
                                               torch.Generator().get_state())
    (assets / "vocoder").mkdir(parents=True)
    with open(assets / "hparams_diff.json", "w") as f:
        json.dump(hp, f)
    np.savez(assets / "vocoder" / "generator_000001.npz",
             **{k: np.asarray(v) for k, v in flatten_params(jax.device_get(voc_params)).items()})
    svs = SVSInferTorch.from_work_dir(str(work), str(assets), device="cpu")
    assert svs.pe is None and svs.spk_map == {"pop-cs": 0}

    pins = dict(start_noise=t(np.asarray(jax.random.normal(jax.random.split(rng)[0],
                                                           (b, t_mel, M)))),
                nsf_phase=t(phase), nsf_noise=t(noise))
    port_batch = svs.items_to_batch(svs.score_items([SCORE]))
    out = svs.synthesize(port_batch, **pins)
    np.testing.assert_array_equal(out["mel2ph"].numpy(), mel2ph_ref)
    filled = int((mel2ph_ref[0] > 0).sum())
    assert 8 <= filled < t_mel
    assert max_err(out["mel"].numpy(), mel_ref) <= 1e-3
    assert max_err(out["f0"].numpy(), f0_ref) <= 1.0
    assert (f0_ref[0, :filled] > 100).mean() > 0.25  # voiced frames: the NSF source sings
    wav = svs.infer_batch([SCORE], **pins)[0]
    ref_wav = wav_ref[0][: filled * 128]
    assert wav.shape == ref_wav.shape and np.abs(ref_wav).max() > 1e-3
    assert max_err(wav, ref_wav) <= 2e-3
    offline = dict(hp, task_cls="usr.diffsinger_task.DiffSingerOfflineTask")
    with open(work / "config.json", "w") as f:
        json.dump(offline, f)
    with pytest.raises(NotImplementedError, match="DiffSingerOfflineTask"):
        SVSInferTorch.from_work_dir(str(work), str(assets), device="cpu")
