"""The TTS slice of the port (DiffSpeech from the LJSpeech configs) against
the JAX package, on the CPU: the TextGrid parser and aligner and the
Chinese duration fixing, the host CWT features, the device inverse CWT,
FastSpeech2's CWT pitch head (fp32 with f0 given and predicted, and bf16),
the plain (non-NSF) HiFi-GAN generator, and the tiny TTS path from a
phoneme-level request to a waveform: durations from the predictor, f0
from the CWT head, PLMS from a Gaussian start over K < T steps, the plain
generator through K2's plain version; last, the vocoder built from its own
config in the assets dir (decision (b) of ROADMAP Queue 3).

Bounds: the host features (alignments, CWT) equal, bit for bit; the
inverse CWT 1e-6 of the largest |value|; the forward outputs within 1e-5
of max(1, the output's largest |value|) in fp32 (sums in another order);
bf16 at tests/test_torch_dtype.py's FS2 bound (mel_out max 1e-4); the
generator and the path at the parity bounds of
tests/test_reference_parity.py: mel 1e-3 (:694), waveform 2e-3 (:780).
The diffusion start is the JAX rng's draw handed to the port.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bisinger_tpu.data.textgrid as jtg
import bisinger_tpu.utils.cwt as jcwt
from bisinger_tpu.config import load_hparams as j_load_hparams
from bisinger_tpu.data.text.frontend import BilingualFrontend as JBilingualFrontend
from bisinger_tpu.inference.pipeline import SVSInfer
from bisinger_tpu.models.fs2 import FastSpeech2 as JFastSpeech2
from bisinger_tpu.models.hifigan import HifiGanGenerator as JHifiGanGenerator
from bisinger_tpu.training.tasks import DiffSpeechTask as JDiffSpeech
from bisinger_tpu.training.trainer import device_batch
from bisinger_tpu.utils.text_encoder import TokenTextEncoder as JTokenTextEncoder
from bisinger_tpu.vocoders.hifigan import flatten_params, unflatten_params
from bisinger_tpu_torch.config import load_hparams
from bisinger_tpu_torch.data import textgrid as ptg
from bisinger_tpu_torch.inference.pipeline import SVSInferTorch
from bisinger_tpu_torch.models.fs2 import FastSpeech2
from bisinger_tpu_torch.models.hifigan import HifiGanGenerator
from bisinger_tpu_torch.training.checkpoints import CheckpointManager
from bisinger_tpu_torch.training.tasks import DiffSpeechTask, flax_init_
from bisinger_tpu_torch.utils import cwt as pcwt
from bisinger_tpu_torch.weights import export_flax_params

from test_torch_dtype import _strict_jit
from test_torch_vocoder import _draw
from torch_port_helpers import ARPABET, TINY, VOCAB, max_err, midi_batch, noisy, t, \
    textgrid_text, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {name: os.path.join(REPO, "configs", path) for name, path in (
    ("fs2", "tts/lj/fs2.yaml"), ("ds", "usr/lj_ds_beta6.yaml"), ("voc", "tts/hifigan.yaml"))}
B, NT, T, M = 2, 8, 24, 80
# the LJ configs at TINY widths, fp32 (TINY turns the pitch embedding off and the PE on)
LJ_TINY = dict(TINY, use_pitch_embed=True, cwt_hidden_size=16, num_spk=1, pe_enable=False)
VOC_TINY = dict(upsample_initial_channel=32, compute_dtype="float32")


def _lj(name, **over):
    """(JAX HParams, port dict) of an LJ config with the TINY overrides."""
    over = dict(LJ_TINY if name != "voc" else VOC_TINY, **over)
    return j_load_hparams(CFG[name], over), load_hparams(CFG[name], over)


# ---- host side ----------------------------------------------------------------
PINYIN_PH = "<SP> n i h ao , sh ang x in <SP>"


def _pinyin_textgrid():
    """A pinyin TextGrid (two tiers, the phones last) with a separator ','
    aligned as a silence, and its frame-level f0 (voiced in the first frames
    of the separator, so that the Chinese fixing moves them)."""
    segs = [("", 0.3), ("n", 0.1), ("i", 0.3), ("h", 0.08), ("ao", 0.35), ("sil", 0.4),
            ("sh", 0.12), ("ang", 0.3), ("x", 0.1), ("in", 0.4), ("sp", 0.25)]
    bounds = np.concatenate([[0.0], np.cumsum([d for _, d in segs])])
    ivs = [(a, b, p) for (p, _), a, b in zip(segs, bounds[:-1], bounds[1:])]
    words = [(0.0, 0.3, ""), (0.3, 0.7, "ni"), (0.7, 1.13, "hao"), (1.13, 1.53, ""),
             (1.53, 1.95, "shang"), (1.95, 2.45, "xin"), (2.45, float(bounds[-1]), "")]
    f0 = np.where(np.arange(300) < 150, 220.0, 0.0).astype(np.float32)
    return textgrid_text(float(bounds[-1]), [("words", words), ("phones", ivs)]), f0


def test_textgrid_alignment_and_zh_fix_equal_jax():
    """parse_textgrid, textgrid_to_mel2ph and fix_zh_durations equal JAX's,
    on tests/test_textgrid_binarizer.py's TextGrid (24 kHz, hop 128) and on
    a pinyin one at the LJ settings (22.05 kHz, hop 256) with and without
    f0; a TextGrid whose phones disagree with the meta raises in both."""
    from test_textgrid_binarizer import _TG_TMPL

    cases = [(_TG_TMPL.format(dur=0.8), "<SP> n i <SP>", 150, 128, 24000, None)]
    tg, f0 = _pinyin_textgrid()
    cases += [(tg, PINYIN_PH, 300, 256, 22050, None), (tg, PINYIN_PH, 300, 256, 22050, f0)]
    for text, ph, n, hop, sr, f0 in cases:
        assert ptg.parse_textgrid(text) == jtg.parse_textgrid(text)
        pm, pd = ptg.textgrid_to_mel2ph(text, ph, n, hop, sr)
        jm, jd = jtg.textgrid_to_mel2ph(text, ph, n, hop, sr)
        np.testing.assert_array_equal(pm, jm)
        np.testing.assert_array_equal(pd, jd)
        assert (pd > 0).sum() >= 3
        pf = ptg.fix_zh_durations(pm, ph.split(" "), f0=f0)
        np.testing.assert_array_equal(pf, jtg.fix_zh_durations(jm, ph.split(" "), f0=f0))
        if ph == PINYIN_PH:
            assert not np.array_equal(pf, pm)  # the fixing moved frames
    for mod in (ptg, jtg):
        with pytest.raises(ValueError, match="mismatch"):
            mod.textgrid_to_mel2ph(tg, PINYIN_PH.replace(" i ", " u "), 300, 256, 22050)
    assert [ptg.is_sil_phoneme(p) for p in PINYIN_PH.split()] == [
        jtg.is_sil_phoneme(p) for p in PINYIN_PH.split()]


def _f0_track(n, seed):
    """A frame f0 track with unvoiced stretches at both ends and inside."""
    r = np.random.default_rng(seed)
    f0 = (160 + 40 * np.sin(np.arange(n) / r.uniform(5, 15))).astype(np.float32)
    f0[: r.integers(1, 10)] = 0
    f0[n - r.integers(1, 10):] = 0
    a = r.integers(10, n - 20)
    f0[a: a + r.integers(3, 15)] = 0
    return f0


@pytest.mark.parametrize("n", [64, 100, 257])
def test_host_cwt_features_are_jax_bit_for_bit(n):
    """The binarizer's CWT features (continuous log-f0, its statistics, the
    Mexican-hat CWT over 10 scales zero-padded to a power of two, the
    per-scale normalisation) equal JAX's bit for bit, at a power-of-two
    length and two others."""
    f0 = _f0_track(n, n)
    for fn in ("convert_continuous_f0", "get_cont_lf0"):
        for a, b in zip(getattr(pcwt, fn)(f0), getattr(jcwt, fn)(f0)):
            np.testing.assert_array_equal(a, b)
    _, lf0 = pcwt.get_cont_lf0(f0)
    m, s = float(np.mean(lf0)), float(np.std(lf0))
    for a, b in zip(pcwt.mexican_hat_cwt((lf0 - m) / s), jcwt.mexican_hat_cwt((lf0 - m) / s)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pcwt.cwt_scales(), jcwt.cwt_scales())
    got, want = pcwt.f0_to_cwt_spec(f0, m, s), jcwt.f0_to_cwt_spec(f0, m, s)
    assert got[0].shape == (n, 10) and got[0].dtype == np.float32
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_inverse_cwt_and_cwt2f0_norm_match_jax():
    """inverse_cwt (mean and population std over the whole padded time axis),
    cwt2f0 and cwt2f0_norm (padding f0 with its last frame to the mel
    length, or cropping) on a zero-padded batch of two recorded spectrograms,
    within 1e-6 of the largest |value|; the weights against their formula."""
    specs, stats = [], []
    for n, seed in ((90, 1), (70, 2)):
        f0 = _f0_track(n, seed)
        _, lf0 = jcwt.get_cont_lf0(f0)
        spec, _, _ = jcwt.f0_to_cwt_spec(f0, float(lf0.mean()), float(lf0.std()))
        specs.append(np.pad(spec, ((0, 96 - n), (0, 0))))
        stats.append((lf0.mean(), lf0.std()))
    spec = np.stack(specs)
    mean = np.asarray([m for m, _ in stats], np.float32)
    std = np.asarray([s for _, s in stats], np.float32)

    def close(a, b):
        b = np.asarray(b)
        assert max_err(a, b) <= 1e-6 * max(np.abs(b).max(), 1.0), max_err(a, b)

    close(pcwt.inverse_cwt(t(spec)).numpy(), jcwt.inverse_cwt(jnp.asarray(spec)))
    close(pcwt.cwt2f0(t(spec), t(mean), t(std)).numpy(),
          jcwt.cwt2f0(jnp.asarray(spec), jnp.asarray(mean), jnp.asarray(std)))
    for t_mel in (96, 120, 80):
        mel2ph = np.ones((2, t_mel), np.int64)
        got = pcwt.cwt2f0_norm(t(spec), t(mean), t(std), t(mel2ph)).numpy()
        want = jcwt.cwt2f0_norm(jnp.asarray(spec), jnp.asarray(mean), jnp.asarray(std),
                                jnp.asarray(mel2ph))
        assert got.shape == (2, t_mel)
        close(got, want)
    rec = pcwt.inverse_cwt(t(spec)).numpy()
    raw = (spec * (np.arange(10) + 3.5) ** -2.5).sum(-1)
    np.testing.assert_allclose(rec, (raw - raw.mean(-1, keepdims=True))
                               / raw.std(-1, keepdims=True), atol=1e-5)


# ---- FastSpeech2's CWT head -----------------------------------------------------
def _cwt_params(hp, seed):
    """The plain FastSpeech2 with the CWT head, flax's initialisers drawn on
    the port's side; the stats head's bias at a log-f0 mean of 5.3 (200 Hz)
    and std 0.25, the uv logit's at -0.5 (mostly voiced)."""
    m = flax_init_(FastSpeech2(hp, VOCAB), seed)
    params = dict(unflatten_params(export_flax_params(m)))
    params["cwt_stats_2"] = dict(params["cwt_stats_2"],
                                 bias=np.asarray([5.3, 0.25], np.float32))
    lin = dict(params["cwt_predictor"]["linear"])
    lin["bias"] = np.asarray(lin["bias"]) + np.asarray([0.0] * 10 + [-0.5], np.float32)
    params["cwt_predictor"] = dict(params["cwt_predictor"], linear=lin)
    return m, params


def _cwt_inputs(seed):
    batch = midi_batch(b=B, n_tokens=NT, n_frames=T, seed=seed)
    r = np.random.default_rng(seed + 100)
    f0 = r.uniform(7.3, 8.6, (B, T)).astype(np.float32)  # log2 Hz, as cwt2f0_norm gives
    uv = (r.random((B, T)) < 0.3).astype(np.float32)
    return batch, f0, uv


KEYS = ("decoder_inp", "mel_out", "dur", "cwt", "f0_mean", "f0_std", "f0_denorm")


@pytest.mark.parametrize("give_f0", [True, False], ids=["f0 given", "f0 predicted"])
def test_fs2_cwt_head_matches_flax(tmp_path, give_f0):
    """The plain FastSpeech2 of configs/tts/lj/fs2.yaml (pitch_type cwt, uv)
    at TINY widths: with the recorded f0 and uv given (training), and with
    neither (the CWT head's f0, std x cwt_std_scale, uv from its logit)."""
    jhp, hp = _lj("fs2")
    assert hp["pitch_type"] == jhp["pitch_type"] == "cwt" and not hp["use_midi"]
    batch, f0, uv = _cwt_inputs(3 + give_f0)
    m, params = _cwt_params(hp, 4)
    kw = dict(txt_tokens=batch["txt_tokens"], mel2ph=batch["mel2ph"],
              f0=f0 if give_f0 else None, uv=uv if give_f0 else None)
    ref = jax.jit(lambda: JFastSpeech2(hp=jhp, vocab_size=VOCAB).apply(
        {"params": params}, **kw))()
    m = to_port(m, params, tmp_path)
    with torch.no_grad():
        got = m(t(batch["txt_tokens"]), mel2ph=t(batch["mel2ph"]), ref_mels=torch.zeros(B, T, M),
                **{k: None if kw[k] is None else t(kw[k]) for k in ("f0", "uv")})
    for k in KEYS:
        want = np.asarray(ref[k])
        assert got[k].shape == want.shape, k
        assert max_err(got[k].numpy(), want) <= 1e-5 * max(1.0, np.abs(want).max()), k
    hz = np.asarray(ref["f0_denorm"])
    assert ((hz > 80) & (hz < 600)).mean() > 0.4  # the CWT f0 reaches the pitch embedding


def test_fs2_cwt_head_matches_jax_in_bf16(tmp_path):
    """In bf16 on both sides (JAX without excess precision, as
    tests/test_torch_dtype.py compiles it): the CWT head's Dense layers in
    fp32 as flax's (no dtype=), its PitchPredictor in bf16; mel_out within
    test_torch_dtype.py's FS2 bound (max 1e-4), with f0 predicted, and the
    head's outputs with it. Measured: the bf16 port 9.5e-7 (mel_out and
    cwt), 0 and 3e-8 (the stats); a port in fp32 0.63, 3.4e-2, 7.9e-4 and
    2.4e-3."""
    jhp, hp = _lj("fs2", compute_dtype="bfloat16")
    batch, _, _ = _cwt_inputs(9)
    m, params = _cwt_params(hp, 5)
    jm = JFastSpeech2(hp=jhp, vocab_size=VOCAB)
    ref = _strict_jit(lambda tok, m2p: jm.apply({"params": params}, txt_tokens=tok,
                                                mel2ph=m2p), jnp.asarray(batch["txt_tokens"]),
                      jnp.asarray(batch["mel2ph"]))
    m = to_port(m, params, tmp_path)
    with torch.no_grad():
        got = m(t(batch["txt_tokens"]), mel2ph=t(batch["mel2ph"]), ref_mels=torch.zeros(B, T, M))
    for k in ("mel_out", "cwt", "f0_mean", "f0_std"):
        want = np.asarray(ref[k])
        assert np.abs(want).max() > 1e-2 and got[k].dtype == torch.float32, k
        assert max_err(got[k].numpy(), want) <= 1e-4, (k, max_err(got[k].numpy(), want))


# ---- the plain HiFi-GAN ---------------------------------------------------------
def _plain_voc(seed=5):
    """The generator of configs/tts/hifigan.yaml (no NSF, rates 8·8·2·2, hop
    256) at 32 channels: (JAX hparams, port hparams, flax params drawn as
    tests/test_torch_vocoder.py draws them, from the tree flax's init gives
    without an f0; the MRF convs small, the upsamplers and conv_post at unit
    gain, so that the waveform carries the stages' signal and not only
    conv_post's bias)."""
    jhp, hp = _lj("voc")
    assert not hp["use_nsf"] and hp["upsample_rates"] == [8, 8, 2, 2]
    shapes = jax.eval_shape(lambda: JHifiGanGenerator(hp=jhp).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4, M)))["params"])
    return jhp, hp, _draw(shapes, seed, small=("res_",))


def test_plain_generator_matches_flax(tmp_path):
    """The plain generator without f0, against flax's generator called
    without one: no m_source, noise_conv or noise_norm parameters on either
    side; eval mode (K2's plain version) and train mode (the ResBlock1
    layers) within 2e-3 of the waveform; an f0 handed to it raises."""
    jhp, hp, params = _plain_voc()
    mel = np.random.default_rng(6).normal(-4, 1.5, (B, 12, M)).astype(np.float32)
    assert not any(k.startswith(("m_source", "noise_")) for k in flatten_params(params))
    ref = np.asarray(jax.jit(lambda: JHifiGanGenerator(hp=jhp).apply({"params": params},
                                                                     mel))())
    gen = to_port(HifiGanGenerator(hp), params, tmp_path)
    assert ref.shape == (B, 12 * 256) and ref.std() > 1e-2
    for train in (False, True):
        gen.train(train)
        with torch.no_grad():
            got = gen(t(mel)).numpy()
        assert max_err(got, ref) <= 2e-3, (train, max_err(got, ref))
    with pytest.raises(ValueError, match="use_nsf"):
        gen(t(mel), torch.full((B, 12), 200.0))


# ---- the tiny TTS path ------------------------------------------------------------
PHONES = ["<SP>"] + ARPABET
REQUEST = dict(item_name="tts", input_type="phoneme",
               ph_seq="<SP> K AH0 L OW1 <SP> M ER0 L D <SP>",
               note_seq=" ".join(["rest"] * 11), note_dur_seq=" ".join(["0.06"] * 11),
               is_slur_seq=" ".join(["0"] * 11), lang_seq=" ".join(["0"] * 11))


@pytest.fixture(scope="module")
def tts_path(tmp_path_factory):
    """A DiffSpeechTask work dir of configs/usr/lj_ds_beta6.yaml at TINY
    widths (T=40, K=29: PLMS at pndm_speedup 5 over a K no multiple of it)
    and an assets dir holding the plain generator with configs/tts/
    hifigan.yaml's keys; JAX's front end, items_to_batch, infer_step and
    generator on the same parameters and start noise."""
    tmp = tmp_path_factory.mktemp("tts")
    over = dict(timesteps=40, K_step=29, bucket_tokens=[16], bucket_frames=[64],
                bucket_batch_sizes=[1, 2])
    jhp, hp = _lj("ds", **over)
    assert hp["gaussian_start"] and hp["pndm_speedup"] == 5 and hp["pitch_type"] == "cwt"
    binary = tmp / "binary"
    binary.mkdir()
    with open(binary / "phone_set.json", "w") as f:
        json.dump(PHONES, f)
    with open(binary / "spk_map.json", "w") as f:
        json.dump({"LJSpeech": 0}, f)
    jhp = jhp.replace(binary_data_dir=str(binary))
    hp = dict(hp, binary_data_dir=str(binary))
    vocab = len(PHONES) + 3  # the encoder's reserved ids first
    items = [JBilingualFrontend(JTokenTextEncoder(PHONES, replace_oov=","))(REQUEST, {})]
    batch = SVSInfer.items_to_batch(types.SimpleNamespace(hp=jhp), items)
    b, t_mel = batch["mels"].shape[:2]
    task = DiffSpeechTask(hp, vocab, device="cpu")
    params = dict(unflatten_params(export_flax_params(task.model)))
    params = noisy(params, ("denoise_fn", "output_projection", "kernel"), 3, 0.2)
    fs2 = params["fs2"] = dict(params["fs2"])
    fs2["dur_predictor"] = dict(fs2["dur_predictor"], linear=dict(
        fs2["dur_predictor"]["linear"], bias=np.asarray([1.6], np.float32)))
    fs2["cwt_stats_2"] = dict(fs2["cwt_stats_2"], bias=np.asarray([5.3, 0.25], np.float32))
    lin = fs2["cwt_predictor"]["linear"]
    fs2["cwt_predictor"] = dict(fs2["cwt_predictor"], linear=dict(
        lin, bias=np.asarray(lin["bias"]) + np.asarray([0.0] * 10 + [-1.0], np.float32)))
    rng = jax.random.PRNGKey(9)
    ret = JDiffSpeech(jhp, vocab).infer_step(params, device_batch(batch), rng)
    jvhp, vhp, voc_params = _plain_voc(7)
    mel = np.asarray(ret["mel_out"])
    wav = np.asarray(jax.jit(lambda x: JHifiGanGenerator(hp=jvhp).apply(
        {"params": voc_params}, x))(mel))

    work, assets = tmp / "work", tmp / "assets"
    task.load_state({k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()})
    (work / "ckpt").mkdir(parents=True)
    with open(work / "config.json", "w") as f:
        json.dump(hp, f)
    state = task.state()
    CheckpointManager(str(work / "ckpt")).save(1, state["params"], state["opt_state"],
                                               torch.Generator().get_state())
    (assets / "vocoder").mkdir(parents=True)
    with open(assets / "hparams_diff.json", "w") as f:
        json.dump(vhp, f)
    np.savez(assets / "vocoder" / "generator_000001.npz",
             **{k: np.asarray(v) for k, v in flatten_params(jax.device_get(voc_params)).items()})
    start = t(np.asarray(jax.random.normal(jax.random.split(rng)[0], (b, t_mel, M))))
    return dict(hp=hp, vhp=vhp, work=str(work), assets=str(assets), start=start, mel=mel,
                mel2ph=np.asarray(ret["mel2ph"]), f0=np.asarray(ret["f0_denorm"]), wav=wav,
                t_mel=t_mel)


def test_tiny_tts_path_matches_jax(tts_path):
    """SVSInferTorch.from_work_dir on the DiffSpeech work dir and the assets
    dir: the phoneme-level request through the front end, durations from the
    predictor, f0 from the CWT head, PLMS (7 denoiser calls: 2 + len(arange(0,
    29, 5)) - 1, as JAX's loop makes them), the plain generator through K2's
    plain version; mel2ph equal, mel within 1e-3, the CWT f0 within 1 Hz,
    the waveform within 2e-3."""
    p = tts_path
    svs = SVSInferTorch.from_work_dir(p["work"], p["assets"], device="cpu")
    calls = []
    real = svs.model.denoise_fn.forward
    svs.model.denoise_fn.forward = lambda *a, **k: calls.append(1) or real(*a, **k)
    batch = svs.items_to_batch(svs.score_items([REQUEST]))
    out = svs.synthesize(batch, start_noise=p["start"])
    assert len(calls) == 2 + len(np.arange(0, 29, 5)) - 1
    np.testing.assert_array_equal(out["mel2ph"].numpy(), p["mel2ph"])
    filled = int((p["mel2ph"][0] > 0).sum())
    assert 11 <= filled < p["t_mel"]
    assert max_err(out["mel"].numpy(), p["mel"]) <= 1e-3
    assert max_err(out["f0"].numpy(), p["f0"]) <= 1.0
    f0 = p["f0"][0, :filled]  # the CWT head's f0 reaches the pitch embedding
    assert (f0 > 0).mean() > 0.3 and ((f0[f0 > 0] > 50) & (f0[f0 > 0] < 1100)).all()
    wav = svs.infer_batch([REQUEST], start_noise=p["start"])[0]
    ref = p["wav"][0][: filled * 256]
    assert wav.shape == ref.shape and ref.std() > 1e-2
    assert max_err(wav, ref) <= 2e-3


def test_vocoder_is_built_from_its_own_config_in_the_assets_dir(tts_path):
    """Decision (b): the served vocoder takes configs/tts/hifigan.yaml's keys
    from the assets dir's hparams_diff.json (rates 8·8·2·2, whose product is
    the hop of 256, no NSF), not the acoustic run's, whose rates are the
    defaults' 8·4·2·2 (a product of 128) with use_nsf on, as JAX's `run
    --infer` builds it (`bisinger_tpu/run.py:125`)."""
    p = tts_path
    hp, vhp = p["hp"], p["vhp"]
    assert np.prod(hp["upsample_rates"]) == 128 != hp["hop_size"] == 256 and hp["use_nsf"]
    svs = SVSInferTorch.from_work_dir(p["work"], p["assets"], device="cpu")
    voc = svs.vocoder
    assert voc.rates == vhp["upsample_rates"] == [8, 8, 2, 2] and not voc.use_nsf
    assert not any(n.startswith(("m_source", "noise_")) for n, _ in voc.named_parameters())
    batch = svs.items_to_batch(svs.score_items([REQUEST]))
    out = svs.synthesize(batch, start_noise=p["start"])
    assert out["wav"].shape == (1, p["t_mel"] * hp["hop_size"])
