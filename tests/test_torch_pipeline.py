"""The port's whole inference path against the JAX package on a tiny model,
the flagship checkpoint's keys against the port's modules, and the port's
import isolation.

Tolerances: the composed-path bounds of tests/test_reference_parity.py:
mel <= 1e-3 (:694), PE f0 <= 1 Hz (:719), waveform <= 2e-3 (:780). The
diffusion start noise is the JAX rng's draw, handed to the port; the NSF
phase and noise are numpy draws handed to both sides.
"""

import contextlib
import functools
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _batch as graft_batch
from bisinger_tpu.data.text.frontend import BilingualFrontend as JBilingualFrontend
from bisinger_tpu.inference.pipeline import SVSInfer
from bisinger_tpu.models.diffusion import GaussianDiffusion as JGaussianDiffusion
from bisinger_tpu.models.hifigan import HifiGanGenerator as JHifiGanGenerator
from bisinger_tpu.models.pe import PitchExtractor as JPitchExtractor
from bisinger_tpu.utils.text_encoder import TokenTextEncoder as JTokenTextEncoder
from bisinger_tpu_torch.config import load_hparams_json
from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch, make_batch
from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
from bisinger_tpu_torch.models.pe import PitchExtractor
from bisinger_tpu_torch.utils.text_encoder import TokenTextEncoder
from bisinger_tpu_torch.weights import load_flax_params, load_npz, unfilled

from torch_port_helpers import VOCAB, hparams, max_err, midi_batch, noisy, t, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


B, T = 2, 24


def _model_kw(batch):
    return dict(txt_tokens=batch["txt_tokens"], spk_embed=batch["spk_ids"],
                **{k: batch[k] for k in ("pitch_midi", "midi_dur", "is_slur", "lang",
                                         "speechsing")})


@contextlib.contextmanager
def _pinned_jax_random(phase, noise):
    """jax.random.uniform / normal hand back the given phase / noise."""
    saved = jax.random.uniform, jax.random.normal
    jax.random.uniform = lambda key, shape=(), dtype=jnp.float32, **kw: jnp.asarray(phase, dtype)
    jax.random.normal = lambda key, shape=(), dtype=jnp.float32, **kw: jnp.asarray(noise, dtype)
    try:
        yield
    finally:
        jax.random.uniform, jax.random.normal = saved


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """The tiny model's flax parameters, made once for both cases, and the
    PE and vocoder as jitted functions (one compile each, shared by the
    cases, instead of dispatching every op). Parameters do not depend on
    the values they are initialised on."""
    jhp, _ = hparams()
    batch = midi_batch(b=B, n_tokens=8, n_frames=T, seed=7)
    jm = JGaussianDiffusion(hp=jhp, vocab_size=VOCAB)
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        mel2ph=batch["mel2ph"], **_model_kw(batch),
        method=JGaussianDiffusion.init_path))()["params"]
    params = noisy(dict(params), ("denoise_fn", "output_projection", "kernel"), 3, 0.2)
    params["fs2"] = dict(params["fs2"])
    lin = params["fs2"]["dur_predictor"]["linear"]
    lin["bias"] = np.asarray(lin["bias"]) + 1.2  # ~2-3 frames a token when predicted
    mel, f0 = jnp.zeros((B, T, 80)), jnp.full((B, T), 200.0)
    jpe = JPitchExtractor(hp=jhp)
    pe_vars = jax.jit(lambda: jpe.init(jax.random.PRNGKey(4), mel))()
    jvoc = JHifiGanGenerator(hp=jhp)
    voc_params = jax.jit(lambda: jvoc.init(
        {"params": jax.random.PRNGKey(5), "nsf": jax.random.PRNGKey(6)}, mel, f0))()["params"]

    def vocode(mel, f0, phase, noise):
        with _pinned_jax_random(phase, noise):
            return jvoc.apply({"params": voc_params}, mel, f0,
                              rngs={"nsf": jax.random.PRNGKey(7)})

    pitch = jax.jit(lambda mel: jpe.apply(pe_vars, mel)["f0_denorm_pred"])
    return batch, jm, params, pe_vars, pitch, voc_params, jax.jit(vocode)


@pytest.mark.parametrize("given_mel2ph", [True, False])
def test_tiny_path_matches_jax(tmp_path, given_mel2ph):
    _, hp = hparams()
    batch, jm, params, pe_vars, pitch, voc_params, vocode = _jax_reference()
    rng = jax.random.PRNGKey(123)
    ret = jm.apply({"params": params}, mel2ph=batch["mel2ph"] if given_mel2ph else None,
                   infer=True, rng=rng, max_frames=T, rngs={"diffusion": rng},
                   **_model_kw(batch))
    mel_ref = np.asarray(ret["mel_out"])
    start = np.asarray(jax.random.normal(jax.random.split(rng)[0], (B, T, 80)))
    f0_ref = np.asarray(pitch(mel_ref))
    r = np.random.default_rng(8)
    phase = r.uniform(size=(B, 9)).astype(np.float32)
    noise = r.standard_normal((B, T * 128, 9)).astype(np.float32)
    wav_ref = np.asarray(vocode(mel_ref, f0_ref, phase, noise))

    svs = SVSInferTorch(
        hp,
        to_port(GaussianDiffusion(hp, VOCAB), params, tmp_path, "diff.npz"),
        to_port(PitchExtractor(hp), pe_vars["params"], tmp_path, "pe.npz",
                extra=pe_vars["batch_stats"]),
        to_port(HifiGanGenerator(hp), voc_params, tmp_path, "voc.npz"),
        device="cpu",
    )
    port_batch = {k: batch[k] for k in ("txt_tokens", "spk_ids", "pitch_midi", "midi_dur",
                                        "is_slur", "lang", "speechsing")}
    if given_mel2ph:
        port_batch["mel2ph"] = batch["mel2ph"]
    port_batch["n_frames"] = T
    out = svs.synthesize(port_batch, start_noise=t(start), nsf_phase=t(phase),
                         nsf_noise=t(noise))
    np.testing.assert_array_equal(out["mel2ph"].numpy(), np.asarray(ret["mel2ph"]))
    assert (out["mel2ph"].numpy() > 0).sum() >= B * T // 2
    assert max_err(out["mel"].numpy(), mel_ref) <= 1e-3
    assert max_err(out["f0"].numpy(), f0_ref) <= 1.0
    assert np.abs(wav_ref).max() > 1e-3
    assert max_err(out["wav"].numpy(), wav_ref) <= 2e-3


def test_flagship_keys_fill_the_port_modules():
    """Every key of the four flagship npz files maps onto a parameter or
    buffer of the full-width port modules, with its shape, and no port
    parameter is left unfilled (load_flax_params raises otherwise)."""
    hp = load_hparams_json(os.path.join(FLAGSHIP_DIR, "hparams_diff.json"))
    diff = load_npz(os.path.join(FLAGSHIP_DIR, "diff_params.npz"))
    vocab = diff["fs2/token_embed/embed/embedding"].shape[0]
    pe_flat = {**load_npz(os.path.join(FLAGSHIP_DIR, "pe_params.npz")),
               **load_npz(os.path.join(FLAGSHIP_DIR, "pe_batch_stats.npz"))}
    voc = load_npz(os.path.join(FLAGSHIP_DIR, "vocoder", "vocoder", "generator_000008000.npz"))
    for module, flat in ((GaussianDiffusion(hp, vocab), diff), (PitchExtractor(hp), pe_flat),
                         (HifiGanGenerator(hp), voc)):
        load_flax_params(module, flat)
        state = module.state_dict()
        assert len(unfilled(state.keys(), [])) == len(flat)
    with pytest.raises(KeyError, match="not filled"):  # PE without its BatchNorm statistics
        load_flax_params(PitchExtractor(hp),
                         load_npz(os.path.join(FLAGSHIP_DIR, "pe_params.npz")))


def test_make_batch_is_the_bench_batch():
    ours = make_batch(3, 16, 40, vocab=24, seed=5)
    ref = graft_batch(3, 16, 40, vocab=24, seed=5)
    for key, value in ours.items():
        np.testing.assert_array_equal(value, ref[key], err_msg=key)


def test_items_to_batch_pads_and_budgets():
    hp = dict(load_hparams_json(os.path.join(FLAGSHIP_DIR, "hparams_diff.json")),
              bucket_tokens=[8, 16], bucket_frames=[64, 128])
    svs = SVSInferTorch.__new__(SVSInferTorch)
    svs.hp = hp
    item = lambda n, **kw: dict(ph_token=np.arange(1, n + 1), pitch_midi=np.full(n, 60),  # noqa
                                midi_dur=np.full(n, 0.05, np.float32), is_slur=np.zeros(n),
                                lang=np.ones(n), spk_id=2, **kw)
    batch = svs.items_to_batch([item(5), item(10)])
    assert batch["txt_tokens"].shape == (2, 16) and batch["n_frames"] == 128
    assert "mel2ph" not in batch and batch["speechsing"].tolist() == [1, 1]
    given = svs.items_to_batch([item(3, mel2ph=np.array([1, 1, 2, 3]))])
    assert given["mel2ph"].tolist() == [[1, 1, 2, 3] + [0] * 60]
    with pytest.raises(ValueError, match="every request"):
        svs.items_to_batch([item(3, mel2ph=np.array([1])), item(3)])


# 17 phones + the 3 reserved ids fill the tiny model's VOCAB rows
PHONES = ["AY", "AE", "N", "T", "S", "B", "IY", "UW", "AH", "F", "L", "JH", "AA", "NG", "Y",
          "<AP>", "<SP>"]
# pinyin, English and mixed scores, short enough for the tiny buckets;
# three of them, so the batch axis pads to the bucket of 4
SCORES = [
    dict(item_name="pinyin", text="ai", notes="C4 D4", notes_duration="0.05 0.03",
         spk_name="b"),
    dict(item_name="english", text="oh la", notes="C4 | D4", notes_duration="0.06 | 0.05"),
    dict(item_name="mixed", text="SP ni love", notes="rest | E4 | F4 G4",
         notes_duration="0.01 | 0.03 | 0.02 0.02", speechsing=0),
]
SPK_MAP = {"a": 1, "b": 3}


def _stub(hp):
    """An object holding only `hp`, for the JAX package's items_to_batch."""
    return types.SimpleNamespace(hp=hp)


def _jax_frontend():
    return JBilingualFrontend(JTokenTextEncoder(PHONES, replace_oov=","))


def _port_svs(tmp_path, hp, params, pe_vars, voc_params):
    return SVSInferTorch(
        hp,
        to_port(GaussianDiffusion(hp, VOCAB), params, tmp_path, "diff.npz"),
        to_port(PitchExtractor(hp), pe_vars["params"], tmp_path, "pe.npz",
                extra=pe_vars["batch_stats"]),
        to_port(HifiGanGenerator(hp), voc_params, tmp_path, "voc.npz"),
        device="cpu", encoder=TokenTextEncoder(PHONES, replace_oov=","), spk_map=SPK_MAP,
    )


def _assert_batch_is_jax(port, ref):
    """Every array of the JAX package's batch: the inputs equal, dtype and
    values; the training targets it makes as zeros (mels, f0, uv, mel2ph,
    word_boundary), which inference never reads, at the port's sizes."""
    b, t_txt = ref["txt_tokens"].shape
    assert port["n_frames"] == ref["mels"].shape[1]
    for key, value in ref.items():
        if key in port:
            assert port[key].dtype == value.dtype, key
            np.testing.assert_array_equal(port[key], value, err_msg=key)
        else:
            assert key in ("mels", "f0", "uv", "mel2ph", "word_boundary"), key
            assert not np.any(value), key
            assert value.shape[:2] == ((b, t_txt) if key == "word_boundary"
                                       else (b, port["n_frames"])), key


def test_frame_budget_uses_total_sec():
    """Six "zhang ai" phrases: 5.4 s of notes (total_sec), while the
    per-phone midi_dur sum counts each note once per phone (10.2 s). The
    frame bucket follows the notes, as the JAX package's does: 1024 frames,
    not 2048."""
    jhp, hp = hparams(bucket_tokens=[64], bucket_frames=[256, 512, 1024, 2048])
    item = _jax_frontend()(dict(text=" ".join(["zhang ai"] * 6),
                                notes=" | ".join(["C4 D4 | E4"] * 6),
                                notes_duration=" | ".join(["0.3 0.2 | 0.4"] * 6)))
    assert item["total_sec"] == pytest.approx(5.4) and np.sum(item["midi_dur"]) > 10
    svs = SVSInferTorch.__new__(SVSInferTorch)
    svs.hp = hp
    ref = SVSInfer.items_to_batch(_stub(jhp), [item])
    assert ref["mels"].shape[1] == 1024
    port = svs.items_to_batch([item])
    assert port["n_frames"] == 1024
    _assert_batch_is_jax(port, ref)


@pytest.mark.parametrize("n_scores", [1, 3])
def test_score_items_to_batch_is_jax(n_scores, capsys):
    """The same scores through both front ends, then both items_to_batch:
    equal arrays, the batch axis padded to bucket_batch_sizes, and the
    truncation warning when a score outgrows the largest bucket."""
    jhp, hp = hparams(bucket_tokens=[4], bucket_frames=[16, 32])
    port_svs = SVSInferTorch.__new__(SVSInferTorch)
    port_svs.hp = hp
    jfe = _jax_frontend()
    items = [jfe(sc, SPK_MAP) for sc in SCORES[:n_scores]]
    ref = SVSInfer.items_to_batch(_stub(jhp), items)
    jax_said = capsys.readouterr().out
    port = port_svs.items_to_batch(items)
    assert capsys.readouterr().out == jax_said
    assert port["txt_tokens"].shape[0] == {1: 1, 3: 4}[n_scores]
    _assert_batch_is_jax(port, ref)
    assert ("TRUNCATED" in jax_said) == (n_scores == 3)


def test_score_to_wav_matches_jax(tmp_path):
    """Scores -> waveforms on the tiny model: the JAX package's front end,
    items_to_batch and infer step (`DiffSingerMIDITask.infer_step`:
    durations predicted within the bucket) -> PE -> vocoder, against the
    port's `infer_batch`, with the start noise and the NSF draws pinned.
    Bounds as test_tiny_path_matches_jax; each waveform trimmed to its
    filled frames as `SVSInfer.infer_batch` trims it. The pinyin and the
    mixed score, at that test's shapes (B=2, 8 tokens, 24 frames), whose
    compiled JAX functions it reuses."""
    jhp, hp = hparams(bucket_tokens=[8], bucket_frames=[24])
    _, jm, params, pe_vars, pitch, voc_params, vocode = _jax_reference()
    scores = [SCORES[0], SCORES[2]]
    items = [_jax_frontend()(sc, SPK_MAP) for sc in scores]
    batch = SVSInfer.items_to_batch(_stub(jhp), items)
    b, t_mel = batch["mels"].shape[:2]
    assert (b, t_mel, batch["txt_tokens"].shape[1]) == (B, T, 8)
    rng = jax.random.PRNGKey(9)
    ret = jm.apply({"params": params}, mel2ph=None, infer=True, rng=rng, max_frames=t_mel,
                   rngs={"diffusion": rng}, **_model_kw(batch))
    mel_ref, mel2ph_ref = np.asarray(ret["mel_out"]), np.asarray(ret["mel2ph"])
    f0_ref = np.asarray(pitch(mel_ref))
    r = np.random.default_rng(10)
    phase = r.uniform(size=(b, 9)).astype(np.float32)
    noise = r.standard_normal((b, t_mel * 128, 9)).astype(np.float32)
    wav_ref = np.asarray(vocode(mel_ref, f0_ref, phase, noise))
    pins = dict(start_noise=t(np.asarray(jax.random.normal(jax.random.split(rng)[0],
                                                           (b, t_mel, 80)))),
                nsf_phase=t(phase), nsf_noise=t(noise))

    svs = _port_svs(tmp_path, hp, params, pe_vars, voc_params)
    out = svs.synthesize(svs.items_to_batch(svs.score_items(scores)), **pins)
    np.testing.assert_array_equal(out["mel2ph"].numpy(), mel2ph_ref)
    assert max_err(out["mel"].numpy(), mel_ref) <= 1e-3
    assert max_err(out["f0"].numpy(), f0_ref) <= 1.0
    wavs = svs.infer_batch(scores, **pins)
    filled = (mel2ph_ref > 0).sum(axis=1)
    assert len(wavs) == 2 and filled.min() >= 4
    for i, wav in enumerate(wavs):
        ref_i = wav_ref[i][: max(int(filled[i]), 1) * 128]
        assert wav.dtype == np.float32 and wav.shape == ref_i.shape
        assert np.abs(ref_i).max() > 1e-3
        assert max_err(wav, ref_i) <= 2e-3
    assert np.array_equal(svs.infer_once(SCORES[1]), svs.infer_once(SCORES[1]))


def test_port_imports_nothing_of_jax():
    """In a fresh interpreter that refuses jax, flax, optax, orbax, yaml,
    pypinyin, jieba, parselmouth, resemblyzer, webrtcvad, pyloudnorm,
    tensorboard, matplotlib, the JAX package and __graft_entry__, every
    module of the port (the score
    front end, the server, the CLI, the data pipeline, the training
    modules, the GAN vocoder's task, weight norm, PQMF, STFT, wrapper and
    trainer tool, the card-vs-CPU step check, the YAML reader, the vocoder
    registry, PWG, MelGAN, the host vocoder utilities, the checkpoint
    importers, the corpus tools, the text processors, `freq_to_midi`, the
    native record codec's reader and tensor parallelism among them)
    and chip_smoke (without running it) import, and a YAML config of the
    repo loads with its cascade."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys
        BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "pypinyin", "jieba",
                   "parselmouth", "resemblyzer", "webrtcvad", "pyloudnorm", "tensorboard",
                   "matplotlib", "bisinger_tpu", "__graft_entry__")

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import bisinger_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(bisinger_tpu_torch.__path__,
                                                       "bisinger_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert callable(chip_smoke.main)
        from bisinger_tpu_torch.config import load_hparams
        hp = load_hparams("configs/usr/popcs_ds_beta6_offline.yaml")
        assert hp["K_step"] == 51 and hp["use_midi"] is False and hp["hop_size"] == 128
        from bisinger_tpu_torch.utils.pitch import freq_to_midi
        assert freq_to_midi(440.0) == 69
        loaded = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
        assert not loaded, loaded
        print(" ".join(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 24  # every module was imported
    assert {"bisinger_tpu_torch.data.text.frontend", "bisinger_tpu_torch.data.text.english",
            "bisinger_tpu_torch.data.text.pinyin", "bisinger_tpu_torch.utils.text_encoder",
            "bisinger_tpu_torch.utils.audio", "bisinger_tpu_torch.inference.server",
            "bisinger_tpu_torch.run", "bisinger_tpu_torch.data.binarizer",
            "bisinger_tpu_torch.data.dataset", "bisinger_tpu_torch.data.device_corpus",
            "bisinger_tpu_torch.data.records", "bisinger_tpu_torch.data.synthetic",
            "bisinger_tpu_torch.utils.praat_pitch", "bisinger_tpu_torch.training.tasks",
            "bisinger_tpu_torch.training.trainer", "bisinger_tpu_torch.training.optim",
            "bisinger_tpu_torch.training.checkpoints", "bisinger_tpu_torch.training.losses",
            "bisinger_tpu_torch.training.vocoder_task", "bisinger_tpu_torch.training.weight_norm",
            "bisinger_tpu_torch.models.pqmf", "bisinger_tpu_torch.ops.stft",
            "bisinger_tpu_torch.vocoders.hifigan", "bisinger_tpu_torch.tools.train_vocoder",
            "bisinger_tpu_torch.tools.step_parity", "bisinger_tpu_torch.yaml_subset",
            "bisinger_tpu_torch.models.pwg", "bisinger_tpu_torch.models.melgan",
            "bisinger_tpu_torch.vocoders.base_vocoder", "bisinger_tpu_torch.vocoders.pwg",
            "bisinger_tpu_torch.vocoders.vocoder_utils", "bisinger_tpu_torch.vocoders.torch_import",
            "bisinger_tpu_torch.compat.torch_params", "bisinger_tpu_torch.tools.merge",
            "bisinger_tpu_torch.tools.meta", "bisinger_tpu_torch.tools.proportional",
            "bisinger_tpu_torch.tools.db4_meta", "bisinger_tpu_torch.tools.pitch_shift",
            "bisinger_tpu_torch.tools.mfa_prep", "bisinger_tpu_torch.data.text.text_norm",
            "bisinger_tpu_torch.data.text.processors", "bisinger_tpu_torch.utils.pitch",
            "bisinger_tpu_torch.native", "bisinger_tpu_torch.parallel.tensor",
            "bisinger_tpu_torch.parallel.groups"} <= names
