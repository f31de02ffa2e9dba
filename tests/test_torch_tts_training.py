"""The TTS slice's data and training path of the port against the JAX
package, on the CPU at tiny widths, fp32, from the repo's LJSpeech configs
(configs/tts/lj/fs2.yaml, configs/usr/lj_ds_beta6.yaml,
configs/tts/hifigan.yaml) with the same overrides on both sides:
`TextGridBinarizer` with the CWT features on a TextGrid corpus written
here (the port's through `run --binarize`, which picks it as
`binarizer_cls` ZhBinarizer), the loader's batches with the recorded CWT,
one train step of the LJ FastSpeech2 (AuxDecoderMIDITask without MIDI, CWT
pitch) and of DiffSpeechTask (the conditioner frozen but for its
predictors, the CWT head's Dense layers among the frozen), decision (a) of
ROADMAP Queue 3 (the plain GAN task hands its generator no f0); then the
whole recipe through the CLI: binarize, lj/fs2, lj_ds_beta6 warm-started
from it, the plain vocoder through `tools/train_vocoder` with TV_CONFIG,
the assets dir, and `run --infer` on a phoneme-level request.

The binarized shards are held equal to JAX's, every array (the mel
included: both packages run the same numpy STFT); the loader's batches
equal; the steps as tests/test_torch_training.py holds them
(`_check_step`): every loss within 1e-5 of its value, every gradient within
1e-4 of the largest |gradient|, the parameters after the clip + AdamW update
within 1e-6 of optax's. Both sides get the same batch, the same parameters
(flax's initialisers drawn on the port's side into the tree JAX's traced
init gives) and, for DiffSpeech, JAX's draws of t and the noise.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from bisinger_tpu.config import load_hparams as j_load_hparams
from bisinger_tpu.data.binarizer import TextGridBinarizer as JTextGridBinarizer
from bisinger_tpu.data.dataset import DataLoader as JDataLoader
from bisinger_tpu.data.dataset import M4SingerDataset as JDataset
from bisinger_tpu.data.records import RecordReader as JReader
from bisinger_tpu.training import tasks as JT
from bisinger_tpu.training.trainer import device_batch
from bisinger_tpu.training.vocoder_task import HifiGanTask as JHifiGanTask
from bisinger_tpu.utils.text_encoder import build_phone_encoder
from bisinger_tpu.vocoders.hifigan import flatten_params, unflatten_params
from bisinger_tpu_torch import run
from bisinger_tpu_torch.config import load_hparams
from bisinger_tpu_torch.data.dataset import NON_ARRAY_KEYS, DataLoader, M4SingerDataset
from bisinger_tpu_torch.data.dataset import batch_to_device
from bisinger_tpu_torch.data.records import RecordReader
from bisinger_tpu_torch.training import tasks as PT
from bisinger_tpu_torch.training.vocoder_task import HifiGanTask
from bisinger_tpu_torch.weights import export_flax_params

from test_torch_training import _check_step, _diff_draws, _flat, _jax_step, _with_noisy_out
from torch_port_helpers import TINY, write_textgrid_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {name: os.path.join(REPO, "configs", path) for name, path in (
    ("fs2", "tts/lj/fs2.yaml"), ("ds", "usr/lj_ds_beta6.yaml"), ("voc", "tts/hifigan.yaml"))}
N_ITEMS = 10
ZH = "bisinger_tpu.data.binarizer.ZhBinarizer"  # the TextGrid binarizer, as base_zh.yaml names it
DATA = dict(raw_json_fn="meta.json", pitch_extractor="autocorr")
TRAIN = dict(
    TINY, **DATA, use_pitch_embed=True, cwt_hidden_size=16, num_spk=1, pe_enable=False,
    bucket_tokens=[32], bucket_frames=[128], max_tokens=4000, max_sentences=4,
    max_eval_sentences=4, max_words=32, dropout=0.0, predictor_dropout=0.0, lr=1e-3,
    warmup_updates=2, decay_steps=2, clip_grad_norm=1.0, log_interval=1,
    val_check_interval=1000, num_sanity_val_steps=1, num_ckpt_keep=2, timesteps=40, K_step=29)


def _over_string(over):
    return ",".join(f"{k}={json.dumps(v) if isinstance(v, (list, bool)) else v}"
                    for k, v in over.items())


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A 10-item TextGrid corpus of 0.8-1.4 s at 22.05 kHz, binarized from
    configs/tts/lj/fs2.yaml (with_f0cwt) by each package, the port through
    its CLI; two batches of JAX's DataLoader."""
    root = tmp_path_factory.mktemp("lj")
    write_textgrid_corpus(str(root / "raw"), N_ITEMS, seed=0, dur_range=(0.8, 1.4))
    data = dict(DATA, raw_data_dir=str(root / "raw"))
    JTextGridBinarizer(j_load_hparams(CFG["fs2"], dict(data, binary_data_dir=str(
        root / "bin_jax")))).process()
    cwd = os.getcwd()
    os.chdir(root)
    try:
        assert run.main(["--config", CFG["fs2"], "--binarize", "--hparams", _over_string(
            dict(data, binary_data_dir=str(root / "bin_port"), binarizer_cls=ZH))]) == 0
    finally:
        os.chdir(cwd)
    over = dict(TRAIN, raw_data_dir=str(root / "raw"), binary_data_dir=str(root / "bin_jax"))
    jhp = {name: j_load_hparams(CFG[name], over) for name in ("fs2", "ds")}
    php = {name: load_hparams(CFG[name], over) for name in ("fs2", "ds")}
    vocab = build_phone_encoder(str(root / "bin_jax")).vocab_size
    dl = iter(JDataLoader(JDataset(jhp["ds"], "train", shuffle=True), jhp["ds"], shuffle=True,
                          endless=True))
    batches = [device_batch(next(dl)) for _ in range(2)]
    return dict(root=root, jhp=jhp, php=php, vocab=vocab, batches=batches, over=over)


def test_textgrid_binarizer_writes_jax_shards(env):
    """Per item every field equal to JAX's: mel2ph from the TextGrid, f0,
    the CWT spectrogram with the log-f0 mean and std, ph_is_sil, the mel;
    no MIDI field; the splits (the tail held out: test_num), lengths, f0
    statistics, phone set and speaker map too."""
    jdir, pdir = env["root"] / "bin_jax", env["root"] / "bin_port"
    for fn in ("phone_set.json", "spk_map.json"):
        with open(jdir / fn) as a, open(pdir / fn) as b:
            assert json.load(a) == json.load(b)
    with open(pdir / "spk_map.json") as f:
        assert json.load(f) == {"LJSpeech": 0}
    for split in ("train", "valid", "test"):
        for fn in (f"{split}_lengths.npy", f"{split}_f0s_mean_std.npy"):
            np.testing.assert_array_equal(np.load(jdir / fn), np.load(pdir / fn))
        jr, pr = JReader(str(jdir / split)), RecordReader(str(pdir / split))
        assert len(jr) == len(pr) == ({"train": 8}.get(split, 2))
        for i in range(len(jr)):
            a, b = jr[i], pr[i]
            assert set(a) == set(b) and "pitch_midi" not in b and "cwt_spec" in b
            for k, v in a.items():
                if isinstance(v, np.ndarray):
                    assert v.dtype == b[k].dtype, k
                    np.testing.assert_array_equal(v, b[k], err_msg=k)
                else:
                    assert v == b[k], k
            assert b["cwt_spec"].shape == (b["len"], 10) and b["ph_is_sil"].sum() >= 2
            assert 0 < (b["f0"] > 0).mean() < 1  # voiced and unvoiced frames


def test_cwt_batches_match_jax(env):
    """The loaders of lj_ds_beta6 at the same seed over an epoch and a half:
    the same batches, every array equal, the recorded CWT spectrogram padded
    to the frame bucket and the per-item log-f0 mean and std among them."""
    jhp, php = env["jhp"]["ds"], env["php"]["ds"]
    ji = iter(JDataLoader(JDataset(jhp, "train", shuffle=True), jhp, shuffle=True, endless=True,
                          seed=3))
    pdl = DataLoader(M4SingerDataset(php, "train", shuffle=True), php, shuffle=True,
                     endless=True, seed=3)
    pi = iter(pdl)
    for _ in range(3 * pdl.batches_per_epoch() // 2 + 1):
        jb, pb = next(ji), next(pi)
        assert jb["item_names"] == pb["item_names"]
        jb = device_batch(jb)
        pb = {k: v for k, v in pb.items() if k not in NON_ARRAY_KEYS}
        assert {"cwt_spec", "f0_mean", "f0_std", "ph_is_sil", "uv"} <= set(pb)
        assert set(jb) == set(pb) and pb["cwt_spec"].shape[1] == pb["mels"].shape[1]
        for k, v in jb.items():
            np.testing.assert_array_equal(np.asarray(v), pb[k], err_msg=k)


PAIRS = {
    "LJ FastSpeech2 (AuxDecoderMIDITask, CWT pitch)": ("fs2", JT.AuxDecoderMIDITask,
                                                       PT.AuxDecoderMIDITask),
    "DiffSpeechTask (CWT pitch)": ("ds", JT.DiffSpeechTask, PT.DiffSpeechTask),
}
LOSSES = {"l1", "pdur", "wdur", "sdur", "C", "uv", "f0_mean", "f0_std"}


@pytest.mark.parametrize("name", list(PAIRS))
def test_one_fp32_train_step_matches_jax(env, name):
    """The f0 the model is fed comes from the batch's recorded CWT
    (`cwt2f0_norm`) on both sides; DiffSpeech's conditioner, the CWT head's
    in_proj and stats layers with it, stays where it was."""
    cfg, jcls, pcls = PAIRS[name]
    jhp, php, vocab, batch = env["jhp"][cfg], env["php"][cfg], env["vocab"], env["batches"][0]
    assert php["pitch_type"] == "cwt" and not php["use_midi"] and "cwt_spec" in batch
    jtask = jcls(jhp, vocab)
    shapes = jax.eval_shape(jtask.init_state, jax.random.PRNGKey(0), batch).params
    ptask, fresh = (pcls(php, vocab, device="cpu") for _ in range(2))
    params = unflatten_params(export_flax_params(ptask.model))
    assert {k: v.shape for k, v in flatten_dict(shapes, sep="/").items()} == {
        k: v.shape for k, v in flatten_dict(params, sep="/").items()}
    diffusion = cfg == "ds"
    if diffusion:
        params = _with_noisy_out(params)
    state = JT.TrainState.create(apply_fn=jtask.model.apply, params=params, tx=jtask.tx)
    for task in (ptask, fresh):
        task.load_state(_flat(params))
    rng = jax.random.PRNGKey(17)
    jres = _jax_step(jtask, state, batch, rng)
    pins = {}
    if diffusion:
        t, noise = _diff_draws(rng, batch, jhp["K_step"])
        pins = dict(t=t, noise=noise)
    pout = ptask.train_step(batch_to_device(batch, "cpu"), **pins)
    want = LOSSES - {"l1"} | {"mel"} if diffusion else LOSSES
    assert want == set(jres[1]) == set(pout) - {"total_loss", "grad_norm"}
    jg = _check_step(jres, ptask, fresh, pout, name)
    prefix = "fs2/" if diffusion else ""
    assert np.abs(jg[prefix + "cwt_predictor/linear/kernel"]).max() > 0
    assert np.abs(jg[prefix + "cwt_stats_2/kernel"]).max() > 0
    if diffusion:
        after = export_flax_params(ptask.model)
        before = _flat(params)
        for k in ("fs2/cwt_in_proj/kernel", "fs2/cwt_stats_0/kernel",
                  "fs2/token_embed/embed/embedding"):
            assert np.array_equal(after[k], before[k]), k
        assert not np.array_equal(after["fs2/cwt_predictor/linear/kernel"],
                                  before["fs2/cwt_predictor/linear/kernel"])


def test_plain_gan_task_hands_the_generator_no_f0():
    """Decision (a): with use_nsf off (configs/tts/hifigan.yaml) the port's
    task builds its generator without the NSF source and trains it without
    f0, as JAX's task computes a step handed f0=None, where JAX's own task,
    handed the batch's f0, builds and trains m_source and noise_conv_* that
    its wrapper never runs. The step's parity with JAX is
    tests/test_torch_vocoder.py::test_one_gan_step_matches_jax[plain]."""
    over = dict(upsample_initial_channel=16, compute_dtype="float32")
    jhp, hp = j_load_hparams(CFG["voc"], over), load_hparams(CFG["voc"], over)
    assert not hp["use_nsf"] and not jhp["use_nsf"]
    frames = 2
    mel = np.random.default_rng(0).normal(-4, 1, (1, frames, 80)).astype(np.float32)
    wav = np.zeros((1, frames * 256), np.float32)
    f0 = np.full((1, frames), 200.0, np.float32)
    jtask = JHifiGanTask(jhp)
    with_f0, without = (jax.eval_shape(lambda f: jtask.init_states(
        jax.random.PRNGKey(0), mel, f, wav)[0].params, f) for f in (f0, None))
    nsf = ("m_source", "noise_conv_", "noise_norm_")
    assert any(k.startswith(nsf) for k in flatten_params(with_f0))
    task = HifiGanTask(hp, device="cpu")
    assert not task.generator.use_nsf
    leaves = ("kernel", "bias", "scale", "wn_g", "wn_v")  # weight norm's (g, v) pairs too

    def layers(keys):
        return {"/".join(p for p in k.split("/") if p not in leaves) for k in keys}

    keys = set(task.export_gen_params())
    assert layers(keys) == layers(flatten_params(without))
    assert not any(k.startswith(nsf) for k in keys)
    # an f0 in the batch is not read: NaN would reach the waveform
    out = task.train_step({"mels": torch.tensor(mel), "f0": torch.full((1, frames), np.nan),
                           "wav": torch.tensor(wav)})
    assert all(np.isfinite(float(v)) for v in out.values())


def test_cli_trains_and_serves_the_lj_recipe(env, tmp_path, monkeypatch, capsys):
    """The README's TTS recipe at TINY widths on the CPU: lj/fs2 for 2 steps
    (the binarized corpus of the fixture), lj_ds_beta6 for 2 warm-started
    from its work dir, the plain vocoder for 2 steps through
    tools/train_vocoder with TV_CONFIG=configs/tts/hifigan.yaml, the assets
    dir (hparams_diff.json with the vocoder config's keys, vocoder/
    generator_*.npz), and `run --infer` on a phoneme-level request: a
    22.05 kHz WAV of a whole number of 256-sample frames."""
    monkeypatch.chdir(tmp_path)
    over = _over_string(env["over"])
    fs2_dir = str(tmp_path / "checkpoints" / "fs2")
    for cfg, exp, extra in (("fs2", "fs2", ""), ("ds", "ds", f",fs2_ckpt={fs2_dir}")):
        assert run.main(["--config", CFG[cfg], "--exp_name", exp, "--device", "cpu",
                         "--hparams", over + extra, "--max_updates", "2"]) == 0
        out = capsys.readouterr().out
        steps = [ln for ln in out.splitlines() if ln.startswith("| step 2 [tr]")]
        assert len(steps) == 1 and "nan" not in steps[0] and " C=" in steps[0], out[-2000:]
        assert ("| warm-started fs2 from" in out) == bool(extra)
    voc_out = tmp_path / "voc"
    env_v = dict(os.environ, TV_STEPS="2", TV_BATCH="1", TV_FRAMES="8", TV_CHANNELS="16",
                 TV_OUT=str(voc_out), TV_CONFIG=CFG["voc"], TV_IMPROVE="10", TV_DMIN="0",
                 TV_DMAX="100", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "bisinger_tpu_torch.tools.train_vocoder",
                           "--device", "cpu"], env=env_v, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assets = tmp_path / "assets"
    (assets / "vocoder").mkdir(parents=True)
    voc_hp = load_hparams(CFG["voc"], dict(upsample_initial_channel=16))
    with open(assets / "hparams_diff.json", "w") as f:
        json.dump(voc_hp, f)
    gen = voc_out / "vocoder" / "generator_000000002.npz"
    os.replace(gen, assets / "vocoder" / gen.name)
    req = dict(item_name="lj_req", input_type="phoneme", ph_seq="<SP> K AH0 L OW1 <SP>",
               note_seq="rest " * 5 + "rest", note_dur_seq=" ".join(["0.1"] * 6),
               is_slur_seq="0 0 0 0 0 0", lang_seq="0 0 0 0 0 0")
    with open(tmp_path / "req.json", "w") as f:
        json.dump([req], f)
    assert run.main(["--infer", "--exp_name", "ds", "--ckpt_dir", str(assets), "--device", "cpu",
                     "--input", str(tmp_path / "req.json"), "--out", str(tmp_path / "out")]) == 0
    from scipy.io import wavfile

    sr, wav = wavfile.read(tmp_path / "out" / "lj_req.wav")
    assert sr == 22050 and len(wav) > 0 and len(wav) % 256 == 0
