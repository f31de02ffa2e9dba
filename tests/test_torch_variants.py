"""The model and data variants of the port against the JAX package, on the
CPU at the tiny widths of torch_port_helpers, fp32: the CRF and mixture
duration heads (Viterbi, the CRF's log-likelihood, the mixture's
expectation and NLL), ESPnet's relative positions, the LEFT-padded and
relu/swish FFNs and predictor convs, split speaker ids, speaker vectors,
the PitchExtractor with LEFT convs and standard-normalised f0, the FFT
denoiser; one train step of each variant task; a variant cascade served
against JAX's path; the binarizer's speaker vectors, silence trimming and
loudness normalisation and the dataset's energy convention; and the
decisions recorded in ROADMAP Queue 3 (the FFT denoiser's decoder without
dropout in training, the energy VAD, the offline work dir, a score's
speaker vector).

Parameters are drawn flax-style on the port's side (`flax_init_`) and
handed to JAX, whose traced init checks the names and shapes. Tolerances:
Viterbi paths equal; the CRF and mixture functions 1e-5 relative; module
forwards within 1e-5 of max(1, the output's largest |value|); train steps
as tests/test_torch_training.py (`_check_step`: every loss 1e-5 of its
value, every gradient 1e-4 of the largest, the parameters 1e-6); the
served cascade within tests/test_reference_parity.py's bounds (mel 1e-3,
f0 1 Hz, waveform 2e-3), its start noise and NSF draws pinned.
"""

import copy
import importlib.util
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from bisinger_tpu.config import load_hparams as j_load_hparams
from bisinger_tpu.data.binarizer import M4SingerBinarizer as JBinarizer
from bisinger_tpu.data.binarizer import TextGridBinarizer as JTextGridBinarizer
from bisinger_tpu.data.dataset import DataLoader as JDataLoader
from bisinger_tpu.data.dataset import M4SingerDataset as JDataset
from bisinger_tpu.data.records import RecordReader as JReader
from bisinger_tpu.data.text.frontend import BilingualFrontend as JBilingualFrontend
from bisinger_tpu.inference.pipeline import SVSInfer
from bisinger_tpu.models import predictors as JP
from bisinger_tpu.models.diffnet import FFTDenoiser as JFFTDenoiser
from bisinger_tpu.models.fs2 import FastSpeech2 as JFastSpeech2
from bisinger_tpu.models.fs2 import FastSpeech2MIDI as JFastSpeech2MIDI
from bisinger_tpu.models.hifigan import HifiGanGenerator as JHifiGanGenerator
from bisinger_tpu.models.pe import PitchExtractor as JPitchExtractor
from bisinger_tpu.training import tasks as JT
from bisinger_tpu.training.trainer import device_batch
from bisinger_tpu.utils import audio as jaudio
from bisinger_tpu.utils.text_encoder import TokenTextEncoder as JTokenTextEncoder
from bisinger_tpu.vocoders.hifigan import unflatten_params
from bisinger_tpu_torch.config import make_hparams
from bisinger_tpu_torch.data.binarizer import M4SingerBinarizer, TextGridBinarizer
from bisinger_tpu_torch.data.dataset import DataLoader, M4SingerDataset, batch_to_device
from bisinger_tpu_torch.data.device_corpus import DeviceResidentFeeder
from bisinger_tpu_torch.data.records import RecordReader
from bisinger_tpu_torch.data.synthetic import make_synthetic_corpus
from bisinger_tpu_torch.inference.pipeline import SVSInferTorch
from bisinger_tpu_torch.models import predictors as P
from bisinger_tpu_torch.models.common import set_dropout_generator
from bisinger_tpu_torch.models.diffnet import FFTDenoiser
from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
from bisinger_tpu_torch.models.fs2 import FastSpeech2, FastSpeech2MIDI
from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
from bisinger_tpu_torch.models.pe import PitchExtractor
from bisinger_tpu_torch.training import tasks as PT
from bisinger_tpu_torch.training.tasks import flax_init_
from bisinger_tpu_torch.training.vocoder_task import flax_init_ as voc_init_
from bisinger_tpu_torch.utils import audio
from bisinger_tpu_torch.weights import export_flax_params, load_flax_params

import test_torch_pe_training as pe_steps
from test_torch_training import _check_step, _diff_draws, _flat, _jax_step
from torch_port_helpers import (
    TINY,
    VOCAB,
    hparams,
    max_err,
    midi_batch,
    noisy,
    t,
    to_port,
    write_textgrid_corpus,
)

B, NT, T, M = 2, 8, 32, 80


def _close(got, ref, what=""):
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert max_err(got, ref) <= 1e-5 * max(1.0, float(np.abs(ref).max())), what


def _rel(got, ref, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.abs(got - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1e-6), what


def _bias(params, path, add):
    node = params
    for key in path:
        node[key] = dict(node[key])
        node = node[key]
    node["bias"] = np.asarray(node["bias"]) + np.asarray(add, np.float32)


def _spk_vectors(b=B, seed=4):
    v = np.random.default_rng(seed).standard_normal((b, 256)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


# ---- the CRF and mixture heads -------------------------------------------------
def _crf_inputs(seed=0, b=3, n=9, s=32):
    r = np.random.default_rng(seed)
    em = (2.0 * r.standard_normal((b, n, s))).astype(np.float32)
    tr = (0.5 * r.standard_normal((s, s))).astype(np.float32)
    mask = np.ones((b, n), np.float32)
    mask[1, 6:] = 0.0
    mask[2, 3:] = 0.0
    return em, tr, mask


@pytest.mark.parametrize("padded", [False, True])
def test_crf_viterbi_equals_jax_exactly(padded):
    """The integer state path equals JAX's, without and with trailing
    padding; with padding the valid steps decode as the row alone does
    (`tests/test_duration_heads.py:113`), whatever the padding holds."""
    em, tr, mask = _crf_inputs(seed=int(padded))
    m = mask if padded else None
    ref = np.asarray(JP.crf_viterbi(jnp.asarray(em), jnp.asarray(tr),
                                    None if m is None else jnp.asarray(m)))
    got = P.crf_viterbi(t(em), t(tr), None if m is None else t(m)).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    if padded:
        junk = em.copy()
        junk[mask == 0] = 50.0 * np.random.default_rng(9).standard_normal(
            int((mask == 0).sum() * 32)).reshape(-1, 32)
        again = P.crf_viterbi(t(junk), t(tr), t(mask)).numpy()
        for row in range(em.shape[0]):
            n = int(mask[row].sum())
            alone = P.crf_viterbi(t(em[row:row + 1, :n]), t(tr)).numpy()[0]
            np.testing.assert_array_equal(again[row, :n], alone)
            np.testing.assert_array_equal(got[row, :n], alone)


def test_crf_log_likelihood_and_mixture_match_jax():
    """crf_log_likelihood (with trailing padding), mog_expected_log_dur and
    mog_dur_nll (masked and not) within 1e-5 relative."""
    em, tr, mask = _crf_inputs(seed=2)
    tags = np.random.default_rng(3).integers(0, 32, mask.shape)
    _rel(P.crf_log_likelihood(t(em), t(tr), t(tags), t(mask)).numpy(),
         JP.crf_log_likelihood(jnp.asarray(em), jnp.asarray(tr), jnp.asarray(tags),
                               jnp.asarray(mask)), "crf ll")
    r = np.random.default_rng(4)
    xs = r.standard_normal((3, 9, 15)).astype(np.float32)
    dur = r.integers(0, 40, (3, 9)).astype(np.float32)
    _rel(P.mog_expected_log_dur(t(xs)).numpy(), JP.mog_expected_log_dur(jnp.asarray(xs)))
    for m in (None, mask):
        _rel(float(P.mog_dur_nll(t(xs), t(dur), mask=None if m is None else t(m))),
             float(JP.mog_dur_nll(jnp.asarray(xs), jnp.asarray(dur),
                                  mask=None if m is None else jnp.asarray(m))), "mog nll")


# ---- module forwards -----------------------------------------------------------
FS2_CASES = {
    # name: (hp overrides, MIDI model, durations predicted)
    "rel_pos": (dict(rel_pos=True), True, False),
    "rel_pos, plain FastSpeech2": (dict(rel_pos=True, use_midi=False), False, False),
    "LEFT relu FFNs and predictor convs": (dict(ffn_padding="LEFT", ffn_act="relu"), True,
                                           False),
    "swish FFNs": (dict(ffn_act="swish"), True, False),
    "split speaker ids": (dict(use_split_spk_id=True, use_pitch_embed=True,
                               use_energy_embed=True), True, False),
    "speaker vectors": (dict(use_spk_id=False, use_spk_embed=True, use_pitch_embed=True),
                        False, False),
    "mixture head, durations predicted": (dict(dur_loss="mog"), True, True),
    "CRF head, durations predicted": (dict(dur_loss="crf", use_midi=False), False, True),
}


@pytest.mark.parametrize("case", list(FS2_CASES))
def test_fs2_variant_forward_matches_flax(tmp_path, case):
    """The conditioner's outputs (decoder input, mel, the duration head, and
    the pitch and energy heads where on) within 1e-5; predicted durations'
    frame maps equal. With `rel_pos` JAX scales the embedded tokens by
    sqrt(H) twice (`encode`, then `_add_positions`), the plain FastSpeech2
    too (the reference's plain encoder has no relative positions); the port
    does the same."""
    over, midi, predict = FS2_CASES[case]
    jhp, hp = hparams(**over)
    batch = midi_batch(b=B, n_tokens=NT, n_frames=T, seed=len(case))
    jcls, pcls = (JFastSpeech2MIDI, FastSpeech2MIDI) if midi else (JFastSpeech2, FastSpeech2)
    r = np.random.default_rng(5)
    f0 = r.uniform(7.3, 8.6, (B, T)).astype(np.float32)
    uv = (r.random((B, T)) < 0.3).astype(np.float32)
    spk = _spk_vectors()
    kw = dict(txt_tokens=batch["txt_tokens"], mel2ph=None if predict else batch["mel2ph"],
              spk_embed=spk if hp["use_spk_embed"] else batch["spk_ids"])
    if hp["use_split_spk_id"]:
        kw.update(spk_embed_dur_id=(batch["spk_ids"] + 1) % 4,
                  spk_embed_f0_id=(batch["spk_ids"] + 2) % 4)
    if hp["use_pitch_embed"]:
        kw.update(f0=f0, uv=uv)
    if midi:
        kw.update({k: batch[k] for k in ("pitch_midi", "midi_dur", "is_slur", "lang",
                                         "speechsing")})
    m = flax_init_(pcls(hp, VOCAB), 3)
    params = dict(unflatten_params(export_flax_params(m)))
    if predict:  # durations of a few frames a token
        _bias(params, ("dur_predictor", "linear"),
              [1.2] * 5 + [1.5] * 5 + [0.0] * 5 if hp["dur_loss"] == "mog"
              else -0.5 * np.abs(np.arange(32) - 4.0))
    jm = jcls(hp=jhp, vocab_size=VOCAB)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), **kw))["params"]
    assert {k: v.shape for k, v in flatten_dict(shapes, sep="/").items()} == {
        k: v.shape for k, v in flatten_dict(params, sep="/").items()}
    ref = jax.jit(lambda: jm.apply({"params": params}, max_frames=T, **kw))()
    m = to_port(m, params, tmp_path)
    pkw = dict(spk_id=t(batch["spk_ids"]), max_frames=T,
               **{k: t(v) for k, v in kw.items() if k not in ("spk_embed", "spk_embed_dur_id",
                                                              "spk_embed_f0_id") and v is not None})
    if hp["use_spk_embed"]:
        pkw["spk_embed"] = t(spk)
    if hp["use_split_spk_id"]:
        pkw.update(spk_dur_id=t(kw["spk_embed_dur_id"]), spk_f0_id=t(kw["spk_embed_f0_id"]))
    with torch.no_grad():
        got = m(**pkw, ref_mels=None if predict else torch.zeros(B, T, M))
    for k in ("decoder_inp", "mel_out", "dur", "pitch_pred", "f0_denorm", "energy_pred"):
        if k in ref:
            assert k in got, k
            _close(got[k].numpy(), ref[k], k)
    np.testing.assert_array_equal(got["mel2ph"].numpy(), np.asarray(ref["mel2ph"]))
    if predict:
        filled = (np.asarray(ref["mel2ph"]) > 0).sum(1)
        assert (filled > NT).all() and (filled < T).any(), filled
    if hp["dur_loss"] == "crf":
        assert got["dur"].shape == (B, NT, 32) and "crf_transitions" in got
        np.testing.assert_array_equal(got["crf_transitions"].detach().numpy(),
                                      np.asarray(ref["crf_transitions"]))


PE_CASES = {
    "LEFT convs, standard f0": dict(ffn_padding="LEFT", pitch_norm="standard"),
    "SAME convs, log f0, no ConvStacks": dict(conv_layers=0),
}


@pytest.mark.parametrize("case", list(PE_CASES))
def test_pe_variant_forward_matches_flax(tmp_path, case):
    """The PitchExtractor's head and f0 within 1e-5 (the Prenet's running
    statistics drawn away from 1/0): the pitch predictor's LEFT convs; f0
    denormalised as JAX's PE calls `denorm_f0` (standard: f0 * 1 + 0, no
    f0_mean or f0_std passed); `conv_layers` 0, which the checkpoint
    importer (`compat/torch_params.py`) reaches, drops the ConvStacks."""
    over = dict(PE_CASES[case])
    conv_layers = over.pop("conv_layers", 2)
    jhp, hp = hparams(**over)
    r = np.random.default_rng(1)
    mel = (r.standard_normal((B, T, M)) * 0.5 - 3).astype(np.float32)
    mel[1, -6:] = 0.0
    m = flax_init_(PitchExtractor(hp, conv_layers=conv_layers), 2)
    flat = export_flax_params(m)
    for k in flat:
        if k.endswith("/mean"):
            flat[k] = 0.1 * r.standard_normal(flat[k].shape).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = r.uniform(0.5, 2.0, flat[k].shape).astype(np.float32)
    stats = {k: v for k, v in flat.items() if k.endswith(("/mean", "/var"))}
    params = unflatten_params({k: v for k, v in flat.items() if k not in stats})
    _bias(params, ("pitch_predictor", "linear"), [0.3, -0.4])
    jm = JPitchExtractor(hp=jhp, conv_layers=conv_layers)
    ref = jax.jit(lambda: jm.apply({"params": params,
                                    "batch_stats": unflatten_params(stats)}, mel))()
    m = to_port(m, params, tmp_path, extra=unflatten_params(stats))
    assert hasattr(m, "mel_encoder") == (conv_layers > 0)
    with torch.no_grad():
        got = m(t(mel))
    for k in ("pitch_pred", "f0_denorm_pred"):
        _close(got[k].numpy(), ref[k], k)
    assert (np.asarray(ref["f0_denorm_pred"])[1, -6:] == 0).all()


@pytest.mark.parametrize("act", ["gelu", "swish"])
def test_fft_denoiser_matches_flax(tmp_path, act):
    """The FFT denoiser (`diffnet.py:202-262`) on [B, T, 80] with its
    conditioner projections precomputed as the samplers pass them
    ([1, B, T, H]) and from `cond` as training passes it, within 1e-5."""
    jhp, hp = hparams(diff_decoder_type="fft", ffn_act=act)
    r = np.random.default_rng(6)
    spec = r.standard_normal((B, T, M)).astype(np.float32)
    cond = r.standard_normal((B, T, hp["hidden_size"])).astype(np.float32)
    steps = np.array([3, 17], np.int64)
    m = flax_init_(FFTDenoiser(hp), 4)
    params = unflatten_params(export_flax_params(m))
    jm = JFFTDenoiser(hp=jhp)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), spec, steps, cond=cond))
    assert {k: v.shape for k, v in flatten_dict(shapes["params"], sep="/").items()} == {
        k: v.shape for k, v in flatten_dict(params, sep="/").items()}
    ref = jax.jit(lambda: jm.apply({"params": params}, spec, steps, cond=cond))()
    proj = jax.jit(lambda: jm.apply({"params": params}, cond,
                                    method=JFFTDenoiser.cond_projections))()
    m = to_port(m, params, tmp_path)
    with torch.no_grad():
        cp = m.cond_projections(t(cond))
        _close(cp.numpy(), proj, "cond_projections")
        _close(m(t(spec), t(steps), cp, m.stack_weights()).numpy(), ref, "sampling path")
        _close(m(t(spec), t(steps), cond=t(cond)).numpy(), ref, "training path")


def test_decision_fft_denoiser_decoder_runs_without_dropout_in_training(tmp_path):
    """ROADMAP Queue 3: JAX's FFT denoiser runs its decoder with
    `deterministic=True` always (`diffnet.py:259`), so `dropout` never
    drops there, in training either. The port matches: with dropout 0.5 the
    denoiser in train mode gives its eval-mode output, while the
    conditioner's own FFT blocks do drop in train mode."""
    _, hp = hparams(diff_decoder_type="fft", dropout=0.5)
    model = flax_init_(GaussianDiffusion(hp, VOCAB), 1)
    r = np.random.default_rng(7)
    spec, cond = t(r.standard_normal((B, T, M)).astype(np.float32)), t(
        r.standard_normal((B, T, hp["hidden_size"])).astype(np.float32))
    steps = t(np.array([1, 9]))
    gen = torch.Generator().manual_seed(0)
    set_dropout_generator(model, gen)
    with torch.no_grad():
        model.eval()
        ref = model.denoise_fn(spec, steps, cond=cond)
        model.train()
        got = model.denoise_fn(spec, steps, cond=cond)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        x = t(r.standard_normal((B, T, hp["hidden_size"])).astype(np.float32))
        assert not torch.equal(model.fs2.encoder(x), x) and (
            (model.fs2.encoder(x) - model.fs2.encoder(x)).abs().max() > 0)


# ---- one train step of each variant task -----------------------------------------
STEP = dict(TINY, dropout=0.0, predictor_dropout=0.0, lr=1e-3, warmup_updates=2,
            decay_steps=2, clip_grad_norm=1.0, max_words=16, num_spk=4)


def _train_batch(speech, seed=0):
    """A training batch: midi_batch's tokens and frame map (speech: the
    MIDI inputs dropped, silence flags on the first and last token, the
    durations under the CRF's 31 frames), log-mels zero on the padding
    frames, word boundaries, speaker vectors."""
    b = midi_batch(b=B, n_tokens=NT, n_frames=T, seed=seed)
    r = np.random.default_rng(seed + 1)
    mels = (r.standard_normal((B, T, M)) * 0.5 - 3).astype(np.float32)
    mels[b["mel2ph"] == 0] = 0.0
    b.update(mels=mels, spk_embed=_spk_vectors(seed=seed + 2),
             word_boundary=(r.random((B, NT)) < 0.4).astype(np.int64) * (b["txt_tokens"] > 0))
    if speech:
        for k in ("pitch_midi", "midi_dur", "is_slur", "lang", "speechsing", "word_boundary"):
            b.pop(k)
        sil = np.zeros((B, NT), np.int64)
        sil[:, 0] = 1
        b["ph_is_sil"] = sil
    return b


TASK_CASES = {
    "CRF head and speaker vectors, speech": (
        dict(use_midi=False, dur_loss="crf", use_spk_id=False, use_spk_embed=True),
        JT.AuxDecoderMIDITask, PT.AuxDecoderMIDITask),
    "mixture head, split speaker ids, rel_pos, MIDI": (
        dict(dur_loss="mog", use_split_spk_id=True, rel_pos=True, ffn_act="swish"),
        JT.AuxDecoderMIDITask, PT.AuxDecoderMIDITask),
    "FFT denoiser diffusion, LEFT relu": (
        dict(diff_decoder_type="fft", ffn_padding="LEFT", ffn_act="relu"),
        JT.DiffSingerMIDITask, PT.DiffSingerMIDITask),
}


@pytest.mark.parametrize("case", list(TASK_CASES))
def test_one_fp32_variant_train_step_matches_jax(case):
    """One train step of each variant task from the same parameters and
    batch (the diffusion task with JAX's draws of t and the noise): the
    suite's bounds (`_check_step`); the duration head's gradients non-zero."""
    over, jcls, pcls = TASK_CASES[case]
    speech = not over.get("use_midi", True)
    jhp, php = j_load_hparams(overrides=dict(STEP, **over)), make_hparams(dict(STEP, **over))
    batch = _train_batch(speech, seed=len(case))
    jtask = jcls(jhp, VOCAB)
    ptask, fresh = (pcls(php, VOCAB, device="cpu") for _ in range(2))
    params = unflatten_params(export_flax_params(ptask.model))
    jb = device_batch(batch)
    shapes = jax.eval_shape(jtask.init_state, jax.random.PRNGKey(0), jb).params
    assert {k: v.shape for k, v in flatten_dict(shapes, sep="/").items()} == {
        k: v.shape for k, v in flatten_dict(params, sep="/").items()}
    state = JT.TrainState.create(apply_fn=jtask.model.apply, params=params, tx=jtask.tx)
    fresh.load_state(_flat(params))
    rng = jax.random.PRNGKey(11)
    jres = _jax_step(jtask, state, jb, rng)
    pins = {}
    if jcls is JT.DiffSingerMIDITask:
        t_, noise = _diff_draws(rng, jb, jhp["K_step"])
        pins = dict(t=t_, noise=noise)
    pout = ptask.train_step(batch_to_device(batch, "cpu"), **pins)
    assert set(jres[1]) == set(pout) - {"total_loss", "grad_norm"}
    assert {"pdur", "sdur"} <= set(pout) and ("wdur" in pout) == (not speech)
    jg = _check_step(jres, ptask, fresh, pout, case)
    prefix = "fs2/" if jcls is JT.DiffSingerMIDITask else ""
    assert np.abs(jg[f"{prefix}dur_predictor/linear/kernel"]).max() > 0
    if php["dur_loss"] == "crf":
        assert np.abs(jg["dur_predictor/crf_transitions"]).max() > 0
    if php["use_spk_embed"]:
        assert np.abs(jg["spk_embed_proj/kernel"]).max() > 0
    if php["use_split_spk_id"]:
        assert np.abs(jg["spk_embed_dur/embed/embedding"]).max() > 0


def test_one_pe_step_with_left_convs_and_standard_f0_matches_jax():
    """The PitchExtractor task with LEFT convs and `pitch_norm: standard`
    (f0 targets standardised), its dropout masks pinned: the bounds of
    tests/test_torch_pe_training.py's step (loss 1e-5 relative, gradients
    1e-4 of the largest, the running statistics 4e-6, the update 1e-6)."""
    over = dict(lr=1.0, warmup_updates=4, clip_grad_norm=1.0, pitch_type="frame", use_uv=True,
                pitch_loss="l1", ffn_padding="LEFT", pitch_norm="standard", f0_mean=200.0,
                f0_std=50.0)
    jhp, php = hparams(**over)
    batch = pe_steps._batch(0)
    batch["f0"] = np.where(batch["mel2ph"] > 0, (batch["f0"] - 7.5) * 2.0, 0.0).astype(
        np.float32)
    jtask = JT.PitchExtractionTask(jhp)
    ptask, fresh = (PT.PitchExtractionTask(php, device="cpu") for _ in range(2))
    flat = export_flax_params(ptask.model)
    stats = {k: v for k, v in flat.items() if k.endswith(("/mean", "/var"))}
    params = unflatten_params({k: v for k, v in flat.items() if k not in stats})
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(jtask.init_state, jax.random.PRNGKey(0), jbatch).params
    assert {k: v.shape for k, v in flatten_dict(shapes, sep="/").items()} == {
        k: v.shape for k, v in flatten_dict(params, sep="/").items()}
    state = JT.PETrainState.create(apply_fn=jtask.model.apply, params=params,
                                   batch_stats=unflatten_params(stats), tx=jtask.tx)
    masks = pe_steps._masks(5, (B, T, 256), 4)
    total, losses, grads, new_state = pe_steps._jax_step(jtask, state, jbatch, masks)
    pe_steps._pin_port_dropout(ptask.model, masks)
    out = ptask.train_step({k: t(v) for k, v in batch.items()})
    assert abs(float(out["total_loss"]) - float(total)) <= 1e-5 * abs(float(total))
    for k, v in losses.items():
        assert abs(float(out[k]) - float(v)) <= 1e-5 * abs(float(v)), k
    jg, pg = pe_steps._flat(grads), pe_steps._port_grads(ptask.model)
    gmax = max(float(np.abs(v).max()) for v in jg.values())
    worst = max((max_err(pg[k], jg[k]), k) for k in jg)
    assert worst[0] <= 1e-4 * gmax, (worst, gmax)
    got = export_flax_params(ptask.model)
    new_stats = pe_steps._flat(new_state.batch_stats)
    for k in new_stats:
        assert max_err(got[k], new_stats[k]) <= 4e-6 * max(np.abs(new_stats[k]).max(), 1.0), k
    fresh.load_state(flat)
    g = copy.deepcopy(fresh.model)
    load_flax_params(g, {**jg, **stats})
    for p, q in zip(fresh.model.parameters(), g.parameters()):
        p.grad = q.data.clone()
    fresh.opt.step()
    jp, pf = pe_steps._flat(new_state.params), export_flax_params(fresh.model)
    assert max(max_err(pf[k], jp[k]) for k in jp) <= 1e-6


def test_crf_on_a_midi_task_raises_as_jax():
    """JAX refuses `dur_loss: crf` on a MIDI task (`tasks.py:78-88`); the port
    raises the same ValueError, and builds the CRF head on a speech task."""
    over = dict(STEP, dur_loss="crf")
    with pytest.raises(ValueError, match="speech-only") as jerr:
        JT.AuxDecoderMIDITask(j_load_hparams(overrides=over), VOCAB)
    for cls in (PT.AuxDecoderMIDITask, PT.DiffSingerMIDITask):
        with pytest.raises(ValueError) as perr:
            cls(make_hparams(over), VOCAB, device="cpu")
        assert str(perr.value) == str(jerr.value)
    task = PT.AuxDecoderMIDITask(make_hparams(dict(over, use_midi=False)), VOCAB, device="cpu")
    assert task.model.dur_predictor.crf_transitions.shape == (32, 32)


# ---- a variant cascade served against JAX's path ----------------------------------
SERVE_CASES = {
    "speaker vectors, mixture head, rel_pos, the DiffNet": dict(
        use_spk_id=False, use_spk_embed=True, dur_loss="mog", rel_pos=True, ffn_act="swish"),
    "the FFT denoiser, split speaker ids, LEFT PE": dict(
        diff_decoder_type="fft", use_split_spk_id=True, ffn_padding="LEFT"),
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_variant_cascade_served_against_jax(tmp_path, case):
    """Items (the vector case: each with its `spk_embed`, a padding row of
    zeros) through JAX's items_to_batch and infer_step, its PE and NSF
    HiFi-GAN, against `SVSInferTorch.synthesize` on the port's
    items_to_batch: the batch equal, durations predicted, PLMS from a
    Gaussian start (pinned), the NSF draws pinned. mel 1e-3, f0 1 Hz,
    waveform 2e-3 (tests/test_reference_parity.py:694,719,780)."""
    jhp, hp = hparams(**SERVE_CASES[case], gaussian_start=True, bucket_tokens=[16],
                      bucket_frames=[64], bucket_batch_sizes=[1, 2, 4])
    vecs = _spk_vectors(3, seed=8)
    items = []
    for i in range(3):
        b = midi_batch(b=1, n_tokens=6 + i, n_frames=8, seed=20 + i)
        n = 6 + i - 2
        item = dict(ph_token=b["txt_tokens"][0, :n], pitch_midi=b["pitch_midi"][0, :n],
                    midi_dur=b["midi_dur"][0, :n], is_slur=b["is_slur"][0, :n],
                    lang=b["lang"][0, :n], spk_id=i % 4, speechsing=1,
                    total_sec=0.25)
        if hp["use_spk_embed"] and i < 2:
            item["spk_embed"] = vecs[i]
        items.append(item)
    jbatch = SVSInfer.items_to_batch(types.SimpleNamespace(hp=jhp), items)
    model = flax_init_(GaussianDiffusion(hp, VOCAB), 2)
    params = dict(unflatten_params(export_flax_params(model)))
    if hp["diff_decoder_type"] == "wavenet":
        params = noisy(params, ("denoise_fn", "output_projection", "kernel"), 3, 0.2)
    params["fs2"] = dict(params["fs2"])
    _bias(params["fs2"], ("dur_predictor", "linear"),
          [1.0] * 5 + [1.4] * 5 + [0.0] * 5 if hp["dur_loss"] == "mog" else [1.4])
    pe = flax_init_(PitchExtractor(hp), 6)
    pe_flat = export_flax_params(pe)
    pe_stats = {k: v for k, v in pe_flat.items() if k.endswith(("/mean", "/var"))}
    pe_params = unflatten_params({k: v for k, v in pe_flat.items() if k not in pe_stats})
    _bias(pe_params, ("pitch_predictor", "linear"), [7.8, -1.0])
    voc_params = unflatten_params(export_flax_params(voc_init_(
        HifiGanGenerator(hp), 5, small=("res_", "up_", "conv_post"))))

    jtask = JT.DiffSingerMIDITask(jhp, VOCAB)
    rng = jax.random.PRNGKey(12)
    ret = jtask.infer_step(params, device_batch(jbatch), rng)
    mel_ref, mel2ph_ref = np.asarray(ret["mel_out"]), np.asarray(ret["mel2ph"])
    b, t_mel = mel_ref.shape[:2]
    f0_ref = np.asarray(JT.PitchExtractionTask(jhp).infer_step(
        {"params": pe_params, "batch_stats": unflatten_params(pe_stats)}, mel_ref)[
        "f0_denorm_pred"])
    r = np.random.default_rng(13)
    phase = r.uniform(size=(b, 9)).astype(np.float32)
    noise = r.standard_normal((b, t_mel * 128, 9)).astype(np.float32)
    jvoc = JHifiGanGenerator(hp=jhp)

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

    model = to_port(model, params, tmp_path)
    pe = to_port(pe, pe_params, tmp_path, "pe.npz", extra=unflatten_params(pe_stats))
    voc = to_port(HifiGanGenerator(hp), voc_params, tmp_path, "voc.npz")
    svs = SVSInferTorch(hp, model, pe, voc, device="cpu")
    pbatch = svs.items_to_batch(items)
    for k, v in jbatch.items():
        if k in pbatch:
            np.testing.assert_array_equal(pbatch[k], v, err_msg=k)
    assert ("spk_embed" in pbatch) == hp["use_spk_embed"]
    if hp["use_spk_embed"]:
        assert not pbatch["spk_embed"][2:].any() and pbatch["spk_embed"][:2].any()
    pins = dict(start_noise=t(np.asarray(jax.random.normal(jax.random.split(rng)[0],
                                                           (b, t_mel, M)))),
                nsf_phase=t(phase), nsf_noise=t(noise))
    out = svs.synthesize(pbatch, **pins)
    np.testing.assert_array_equal(out["mel2ph"].numpy(), mel2ph_ref)
    filled = (mel2ph_ref > 0).sum(1)
    assert (filled[:3] > 3).all() and filled.max() > 8, filled
    assert max_err(out["mel"].numpy(), mel_ref) <= 1e-3
    assert max_err(out["f0"].numpy(), f0_ref) <= 1.0
    assert np.abs(wav_ref).max() > 1e-3
    assert max_err(out["wav"].numpy(), wav_ref) <= 2e-3


def test_decision_a_scores_speaker_vector_rides_into_its_item():
    """ROADMAP Queue 3: JAX's front end builds an item without the score's
    `spk_embed` (`data/text/frontend.py:314-327`), so JAX serves a score to a
    vector-conditioned model with zeros, though its items_to_batch reads the
    key from an item. The port's `score_items` carries the score's vector
    into the item (the server and `run --infer` pass the score through);
    a score without one is served with zeros, as in JAX."""
    phones = ["<SP>", "a", "i", "n", "sh", "x"]
    score = dict(item_name="v", input_type="phoneme", ph_seq="<SP> sh a x i n <SP>",
                 note_seq="rest C4 C4 D4 D4 E4 rest",
                 note_dur_seq="0.05 0.1 0.1 0.1 0.1 0.2 0.05",
                 is_slur_seq="0 0 0 0 0 0 0", lang_seq="1 1 1 1 1 1 1",
                 spk_embed=_spk_vectors(1)[0].tolist())
    item = JBilingualFrontend(JTokenTextEncoder(phones, replace_oov=","))(score, {})
    assert "spk_embed" not in item
    _, hp = hparams(use_spk_id=False, use_spk_embed=True, bucket_tokens=[16],
                    bucket_frames=[64])
    svs = types.SimpleNamespace(hp=hp, spk_map={}, frontend=JBilingualFrontend(
        JTokenTextEncoder(phones, replace_oov=",")))
    items = SVSInferTorch.score_items(svs, [score, dict(score, spk_embed=None)])
    batch = SVSInferTorch.items_to_batch(svs, items)
    np.testing.assert_array_equal(batch["spk_embed"][0], np.asarray(score["spk_embed"],
                                                                    np.float32))
    assert not batch["spk_embed"][1].any()


# ---- the data variants --------------------------------------------------------------
DATA = dict(pitch_extractor="autocorr", test_prefixes=["Alto-1#song0"], num_spk=4,
            max_frames=5000, bucket_tokens=[32], bucket_frames=[512, 1024],
            max_tokens=20000, max_sentences=4, use_energy_embed=True,
            loud_norm=True)


@pytest.fixture(scope="module")
def data_env(tmp_path_factory):
    """An 8-item synthetic corpus with a long silence spliced into each wav,
    binarized by both packages with `trim_long_sil`, `with_spk_embed` and
    `loud_norm` (the BiSinger binarizer); and a 4-item TextGrid corpus
    binarized with `trim_long_sil` (skipped: its alignment is of the
    untrimmed audio), `with_spk_embed` and `loud_norm`."""
    from scipy.io import wavfile

    root = tmp_path_factory.mktemp("variants_data")
    raw = root / "raw"
    make_synthetic_corpus(str(raw), n_items=8, seed=0)
    with open(raw / "meta.json") as f:
        metas = [json.loads(ln) for ln in f if ln.strip()]
    spliced = {}
    for meta in metas:
        singer, song, sent = meta["item_name"].split("#")
        fn = raw / f"{singer}#{song}" / f"{sent}.wav"
        sr, wav = wavfile.read(fn)
        cut = len(wav) // 2
        wav = np.concatenate([wav[:cut], np.zeros(int(0.9 * sr), wav.dtype), wav[cut:]])
        wavfile.write(fn, sr, wav)
        spliced[meta["item_name"]] = len(wav) / sr
    args = dict(with_spk_embed=True, trim_long_sil=True, with_f0=True, with_align=True,
                with_wav=False, with_txt=True, shuffle=False, with_f0cwt=False)
    over = dict(TINY, **DATA, raw_data_dir=str(raw), raw_json_fn="meta.json",
                binarization_args=args)
    jhp = j_load_hparams(overrides=dict(over, binary_data_dir=str(root / "bin_jax")))
    php = make_hparams(dict(over, binary_data_dir=str(root / "bin_port")))
    JBinarizer(jhp).process()
    M4SingerBinarizer(php).process()
    tg = root / "tg"
    write_textgrid_corpus(str(tg), 4, dur_range=(0.8, 1.2))
    tg_over = dict(over, raw_data_dir=str(tg), audio_sample_rate=22050, hop_size=256,
                   fft_size=1024, win_size=1024, fmax=8000, test_prefixes=["LJ001-0001"],
                   use_midi=False)
    JTextGridBinarizer(j_load_hparams(overrides=dict(tg_over,
                                                     binary_data_dir=str(root / "tg_jax"))
                                      )).process()
    TextGridBinarizer(make_hparams(dict(tg_over, binary_data_dir=str(root / "tg_port")))
                      ).process()
    return dict(root=root, jhp=jhp, php=php, spliced=spliced)


def test_binarized_variant_items_match_jax(data_env):
    """Every item of both corpora: the same trimmed lengths (most of the
    spliced silence trimmed from the BiSinger items, nothing from the
    TextGrid items), the speaker vectors within 1e-6 and of unit norm, the
    loudness-normalised mels within 1e-5, the rest equal."""
    root = data_env["root"]
    for jdir, pdir, trimmed in (("bin_jax", "bin_port", True), ("tg_jax", "tg_port", False)):
        for split in ("train", "test"):
            jr, pr = JReader(str(root / jdir / split)), RecordReader(str(root / pdir / split))
            assert len(jr) == len(pr) > 0
            for i in range(len(jr)):
                a, b = jr[i], pr[i]
                assert set(a) == set(b) and "spk_embed" in b, (set(a) ^ set(b))
                assert a["len"] == b["len"] and a["sec"] == b["sec"]
                assert np.abs(a["spk_embed"] - b["spk_embed"]).max() <= 1e-6
                assert abs(np.linalg.norm(b["spk_embed"]) - 1.0) < 1e-5
                assert np.abs(a["mel"] - b["mel"]).max() <= 1e-5
                for k in ("phone", "mel2ph", "f0"):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            for i in range(len(pr)):  # the spliced 0.9 s of silence trimmed, or kept
                item = pr[i]
                if trimmed:
                    assert item["sec"] < data_env["spliced"][item["item_name"]] - 0.3
                else:
                    assert item["len"] == len(item["mel2ph"])


def test_variant_batches_match_jax(data_env):
    """The loaders at the same seed: `spk_embed` in every batch, the frame
    energy under `energy_convention` "ref" (e**mel) and the log10 one
    (10**mel), every array equal to JAX's; the device-resident feeder
    carries the speaker vectors."""
    for conv in ("ref", "pow10"):
        jhp = data_env["jhp"].replace(energy_convention=conv)
        php = dict(data_env["php"], energy_convention=conv)
        jb = device_batch(next(iter(JDataLoader(JDataset(jhp, "train", shuffle=True), jhp,
                                                shuffle=True, seed=5))))
        pb = next(iter(DataLoader(M4SingerDataset(php, "train", shuffle=True), php, shuffle=True,
                                  seed=5)))
        assert {"spk_embed", "energy"} <= set(pb)
        for k, v in jb.items():
            np.testing.assert_array_equal(np.asarray(v), pb[k], err_msg=f"{conv} {k}")
        mel = pb["mels"][0, :5]
        lin = np.exp(mel) if conv == "ref" else 10.0 ** mel
        np.testing.assert_allclose(pb["energy"][0, :5], np.sqrt((lin ** 2).sum(-1)), rtol=1e-6)
    feeder = DeviceResidentFeeder(M4SingerDataset(data_env["php"], "train"), data_env["php"],
                                  "cpu", seed=0)
    batch = next(feeder)
    assert batch["spk_embed"].shape == (feeder.batch_size, 256)
    assert torch.allclose(batch["spk_embed"].norm(dim=1), torch.ones(feeder.batch_size))


def test_decision_trim_takes_the_energy_vad_on_both_sides():
    """ROADMAP Queue 3: webrtcvad imports on neither machine, so JAX's
    `trim_long_silences` takes its energy VAD, the branch the port has
    (`utils/audio.py`). Here: webrtcvad absent; the mask and the trimmed
    wav equal JAX's on a wav with a long pause, and a wav of constant
    energy comes back whole on both sides; the loudness functions equal
    JAX's."""
    assert importlib.util.find_spec("webrtcvad") is None
    r = np.random.default_rng(0)
    sr = 24000
    tone = 0.3 * np.sin(2 * np.pi * 220 * np.arange(sr) / sr)
    wav = np.concatenate([tone, 1e-5 * r.standard_normal(2 * sr), tone]).astype(np.float32)
    got, mask = audio.trim_long_silences(wav, sr)
    ref, jmask = jaudio.trim_long_silences(wav, sr)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(got, ref)
    assert len(wav) - len(got) > sr
    flat = np.full(sr, 0.1, np.float32)
    assert len(audio.trim_long_silences(flat, sr)[0]) == len(jaudio.trim_long_silences(
        flat, sr)[0]) == sr
    assert audio.integrated_loudness(wav, sr) == jaudio.integrated_loudness(wav, sr)
    np.testing.assert_array_equal(audio.loudness_normalize(wav, sr),
                                  jaudio.loudness_normalize(wav, sr))


def test_decision_an_offline_work_dir_is_not_served_as_in_jax(tmp_path):
    """ROADMAP Queue 3: an offline diffusion work dir cannot serve a score.
    JAX's `SVSInfer.from_work_dir` builds its template state from a dummy
    batch without recorded fs2 mels and raises KeyError 'fs2_mels'
    (`tasks.py:438-441`; its `infer_step` would read `batch["fs2_mels"]`,
    which `items_to_batch` never makes); the port refuses the work dir,
    naming the recorded fs2 mels."""
    phones = ["<SP>", "a", "n"]
    binary = tmp_path / "binary"
    binary.mkdir()
    with open(binary / "phone_set.json", "w") as f:
        json.dump(phones, f)
    with open(binary / "spk_map.json", "w") as f:
        json.dump({"s": 0}, f)
    over = dict(binary_data_dir=str(binary), fs2_mel_dir=str(tmp_path / "fs2"),
                task_cls="bisinger_tpu.training.tasks.DiffSingerOfflineTask",
                bucket_tokens=[16], bucket_frames=[64])
    jhp, hp = hparams(**over)
    (tmp_path / "work" / "ckpt").mkdir(parents=True)
    with pytest.raises(KeyError, match="fs2_mels"):
        SVSInfer.from_work_dir(jhp, str(tmp_path / "work"))
    with open(tmp_path / "work" / "config.json", "w") as f:
        json.dump(hp, f)
    with pytest.raises(NotImplementedError, match="recorded fs2 mels"):
        SVSInferTorch.from_work_dir(str(tmp_path / "work"), str(tmp_path), device="cpu")
