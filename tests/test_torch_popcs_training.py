"""The PopCS family's data and training path of the port against the JAX
package, on the CPU at tiny widths, fp32, from the repo's own YAML configs
(configs/usr/popcs_*.yaml) with the same overrides on both sides:
MidiSingingBinarizer on the synthetic corpus (fmt "popcs"; the port's
through `run --binarize`, which picks it by `binarizer_cls`), the
dataset's energy and recorded fs2 mels in the loader's batches, and one
train step of FastSpeech2Task (frame pitch, uv and energy on),
DiffSingerMIDITask without MIDI, DiffSingerOfflineTask (recorded fs2 mels
from `fs2_mel_dir`) and DiffSpeechTask (the conditioner frozen but for its
predictors); then the three configs trained a few steps through `run`, as
chip_smoke.py's phase 12 trains them on the card.

The steps are held as tests/test_torch_training.py holds the flagship's
(`_check_step`): every loss within 1e-5 of its value, every gradient
within 1e-4 of the largest |gradient|, the parameters after the clip +
AdamW update within 1e-6 of optax's; both sides get the same batch, the
same parameters (flax's initialisers, drawn on the port's side into the
tree JAX's traced init gives, the DiffNet's zero output projection drawn at
random) and, for the diffusion tasks, JAX's draws of t and the noise.
"""

import json
import os

import jax
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

from bisinger_tpu.config import load_hparams as j_load_hparams
from bisinger_tpu.data.binarizer import MidiSingingBinarizer as JMidiBinarizer
from bisinger_tpu.data.dataset import DataLoader as JDataLoader
from bisinger_tpu.data.dataset import M4SingerDataset as JDataset
from bisinger_tpu.data.records import RecordReader as JReader
from bisinger_tpu.data.synthetic import make_synthetic_corpus as j_corpus
from bisinger_tpu.training import tasks as JT
from bisinger_tpu.training.trainer import device_batch
from bisinger_tpu.utils.text_encoder import build_phone_encoder
from bisinger_tpu.vocoders.hifigan import flatten_params, unflatten_params
from bisinger_tpu_torch import run
from bisinger_tpu_torch.config import load_hparams
from bisinger_tpu_torch.data.dataset import (
    NON_ARRAY_KEYS,
    DataLoader,
    M4SingerDataset,
    batch_to_device,
)
from bisinger_tpu_torch.data.records import RecordReader
from bisinger_tpu_torch.data.synthetic import make_synthetic_corpus
from bisinger_tpu_torch.training import tasks as PT
from bisinger_tpu_torch.training.optim import predictor_only_frozen
from bisinger_tpu_torch.weights import export_flax_params

from test_torch_training import _check_step, _diff_draws, _flat, _jax_step, _with_noisy_out
from torch_port_helpers import TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {name: os.path.join(REPO, "configs", "usr", f"{name}.yaml")
       for name in ("popcs_fs2", "popcs_ds_beta6", "popcs_ds_beta6_offline")}
N_ITEMS = 10
# the synthetic items are "<singer>#song<i % 3>#<i:04d>"; the configs' PopCS
# song names match none of them
DATA = dict(test_prefixes=["song0#000"], pitch_extractor="autocorr")
TRAIN = dict(
    TINY, **DATA, use_pitch_embed=True, use_energy_embed=True, num_spk=1, predictor_layers=2,
    bucket_tokens=[16], bucket_frames=[256], max_tokens=4000, max_sentences=4,
    max_eval_sentences=4, max_words=32, dropout=0.0, predictor_dropout=0.0, lr=1e-3,
    warmup_updates=2, decay_steps=2, clip_grad_norm=1.0, log_interval=1,
    val_check_interval=1000, num_sanity_val_steps=1, num_ckpt_keep=2, timesteps=100,
    K_step=51)


def _over_string(over):
    return ",".join(f"{k}={json.dumps(v) if isinstance(v, (list, bool)) else v}"
                    for k, v in over.items())


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Each package binarizes its own copy of a 10-item PopCS corpus from
    popcs_fs2.yaml (the port through its CLI); recorded fs2 mels for every
    item; two batches of JAX's DataLoader."""
    root = tmp_path_factory.mktemp("popcs")
    j_corpus(str(root / "raw_jax"), n_items=N_ITEMS, seed=0, fmt="popcs")
    make_synthetic_corpus(str(root / "raw_port"), n_items=N_ITEMS, seed=0, fmt="popcs")
    jbin = j_load_hparams(CFG["popcs_fs2"], dict(DATA, raw_data_dir=str(root / "raw_jax"),
                                                binary_data_dir=str(root / "bin_jax")))
    JMidiBinarizer(jbin).process()
    cwd = os.getcwd()
    os.chdir(root)
    try:
        assert run.main(["--config", CFG["popcs_fs2"], "--binarize", "--hparams", _over_string(
            dict(DATA, raw_data_dir=str(root / "raw_port"),
                 binary_data_dir=str(root / "bin_port")))]) == 0
    finally:
        os.chdir(cwd)
    fs2_mel_dir = root / "fs2_mels"
    fs2_mel_dir.mkdir()
    r = np.random.default_rng(0)
    for split in ("train", "valid", "test"):
        reader = JReader(str(root / "bin_jax" / split))
        for i in range(len(reader)):
            item = reader[i]
            noise = r.normal(0, 0.3, item["mel"].shape).astype(np.float32)
            np.save(fs2_mel_dir / f"{item['item_name']}.npy", item["mel"] + noise)
    over = dict(TRAIN, raw_data_dir=str(root / "raw_jax"), binary_data_dir=str(root / "bin_jax"),
                fs2_mel_dir=str(fs2_mel_dir))
    jhp = {name: j_load_hparams(path, over) for name, path in CFG.items()}
    php = {name: load_hparams(path, over) for name, path in CFG.items()}
    vocab = build_phone_encoder(str(root / "bin_jax")).vocab_size
    dl = iter(JDataLoader(JDataset(jhp["popcs_ds_beta6_offline"], "train", shuffle=True),
                          jhp["popcs_ds_beta6_offline"], shuffle=True, endless=True))
    batches = [device_batch(next(dl)) for _ in range(2)]
    return dict(root=root, jhp=jhp, php=php, vocab=vocab, batches=batches, over=over)


def test_binarized_popcs_items_match_jax(env):
    """Per item: mel within 1e-5, f0 within 1e-3 Hz, the rest equal; the
    splits (a test prefix matched anywhere in the name), lengths, f0
    statistics (1e-5 relative), phone set and speaker map ("pop-cs") too."""
    jdir, pdir = env["root"] / "bin_jax", env["root"] / "bin_port"
    for fn in ("phone_set.json", "spk_map.json"):
        with open(jdir / fn) as a, open(pdir / fn) as b:
            assert json.load(a) == json.load(b)
    with open(pdir / "spk_map.json") as f:
        assert json.load(f) == {"pop-cs": 0}
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(np.load(jdir / f"{split}_lengths.npy"),
                                      np.load(pdir / f"{split}_lengths.npy"))
        np.testing.assert_allclose(np.load(pdir / f"{split}_f0s_mean_std.npy"),
                                   np.load(jdir / f"{split}_f0s_mean_std.npy"), rtol=1e-5)
        jr, pr = JReader(str(jdir / split)), RecordReader(str(pdir / split))
        assert len(jr) == len(pr) == ({"train": 6}.get(split, 4))
        for i in range(len(jr)):
            a, b = jr[i], pr[i]
            assert set(a) == set(b) and a["item_name"] == b["item_name"]
            assert np.abs(a["mel"] - b["mel"]).max() <= 1e-5
            assert np.abs(a["f0"] - b["f0"]).max() <= 1e-3
            for k in ("phone", "mel2ph", "pitch_midi", "word_boundary", "is_slur", "lang",
                      "pitch", "speechsing", "ph_is_sil", "midi_dur"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            for k in ("spk_id", "len", "txt", "ph"):
                assert a[k] == b[k], k


def test_batches_with_energy_and_fs2_mels_match_jax(env):
    """The loaders of the offline config with the energy embedding on, at
    the same seed over an epoch and a half: the same batches, every array
    equal (the frame energy of the log-mel, the recorded fs2 mels cut and
    padded to each item's frames); `pitch_norm: standard` without f0_mean
    raises in both; JAX's other energy_convention (10**mel) gives JAX's
    energies."""
    jhp, php = env["jhp"]["popcs_ds_beta6_offline"], env["php"]["popcs_ds_beta6_offline"]
    assert jhp["use_energy_embed"] and php["fs2_mel_dir"]
    jdl = JDataLoader(JDataset(jhp, "train", shuffle=True), jhp, shuffle=True, endless=True,
                      seed=3)
    pdl = DataLoader(M4SingerDataset(php, "train", shuffle=True), php, shuffle=True,
                     endless=True, seed=3)
    ji, pi = iter(jdl), iter(pdl)
    for _ in range(3 * jdl.batches_per_epoch() // 2 + 1):
        jb, pb = next(ji), next(pi)
        assert jb["item_names"] == pb["item_names"]
        jb = device_batch(jb)
        pb = {k: v for k, v in pb.items() if k not in NON_ARRAY_KEYS}
        assert {"energy", "fs2_mels", "f0", "uv"} <= set(pb) and set(jb) == set(pb)
        for k, v in jb.items():
            np.testing.assert_array_equal(np.asarray(v), pb[k], err_msg=k)
        assert np.abs(pb["fs2_mels"] - pb["mels"]).max() > 0.1
    bad = dict(php, pitch_norm="standard", f0_mean=None)
    with pytest.raises(ValueError, match="f0_mean"):
        M4SingerDataset(bad, "train")[0]
    with pytest.raises(ValueError, match="f0_mean"):
        JDataset(jhp.replace(pitch_norm="standard", f0_mean=None), "train")[0]
    # JAX's other energy convention (10**mel, which no config sets) as JAX computes it
    for i in range(2):
        np.testing.assert_array_equal(
            M4SingerDataset(dict(php, energy_convention="pow10"), "train")[i]["energy"],
            JDataset(jhp.replace(energy_convention="pow10"), "train")[i]["energy"])


PAIRS = {
    "FastSpeech2Task": ("popcs_fs2", JT.FastSpeech2Task, PT.FastSpeech2Task),
    "DiffSingerMIDITask without MIDI": ("popcs_ds_beta6", JT.DiffSingerMIDITask,
                                        PT.DiffSingerMIDITask),
    "DiffSingerOfflineTask": ("popcs_ds_beta6_offline", JT.DiffSingerOfflineTask,
                              PT.DiffSingerOfflineTask),
    "DiffSpeechTask": ("popcs_ds_beta6", JT.DiffSpeechTask, PT.DiffSpeechTask),
}
LOSSES = {"l1", "ssim", "pdur", "wdur", "sdur", "f0", "uv", "e"}


def _frozen_keys(keys):
    """DiffSpeech's frozen leaves under their flax keys."""
    return {k for k in keys
            if k.startswith("fs2/") and not any("predictor" in p for p in k.split("/"))}


@pytest.mark.parametrize("name", list(PAIRS))
def test_one_fp32_train_step_matches_jax(env, name):
    cfg, jcls, pcls = PAIRS[name]
    jhp, php, vocab, batch = env["jhp"][cfg], env["php"][cfg], env["vocab"], env["batches"][0]
    assert not jhp["use_midi"] and not php["use_midi"] and php["pitch_type"] == "frame"
    jtask = jcls(jhp, vocab)
    # JAX's init traced, not run (a run costs a compile per op): it sets
    # DiffSpeech's mask and gives the tree the port's flax-style init fills
    shapes = jax.eval_shape(jtask.init_state, jax.random.PRNGKey(0), batch).params
    ptask, fresh = (pcls(php, vocab, device="cpu") for _ in range(2))
    params = unflatten_params(export_flax_params(ptask.model))
    assert {k: v.shape for k, v in flatten_dict(shapes, sep="/").items()} == {
        k: v.shape for k, v in flatten_dict(params, sep="/").items()}
    diffusion = name != "FastSpeech2Task"
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
    want = LOSSES - {"l1", "ssim"} | {"mel"} if diffusion else LOSSES
    assert want == set(jres[1]) == set(pout) - {"total_loss", "grad_norm"}
    jg = _check_step(jres, ptask, fresh, pout, name)
    assert np.abs(jg["fs2/pitch_predictor/linear/kernel" if diffusion
                     else "pitch_predictor/linear/kernel"]).max() > 0
    if name == "DiffSingerOfflineTask":
        assert not any(k.startswith("fs2/decoder/") for k in jg)
    if name != "DiffSpeechTask":
        return
    # the conditioner's non-predictor leaves and their Adam moments unchanged
    # on both sides; its predictors and the denoiser moved
    before, after = _flat(params), export_flax_params(ptask.model)
    jafter = flatten_params(jax.device_get(jres[3].params))
    frozen = _frozen_keys(before)
    names = predictor_only_frozen(dict(ptask.model.named_parameters()))
    assert len(frozen) == len(names) > 10 and "fs2/encoder/layer_0/ffn/ffn1/kernel" not in (
        set(before) - frozen)
    for k in frozen:
        assert np.array_equal(after[k], before[k]) and np.array_equal(jafter[k], before[k]), k
    for n in names:
        assert not ptask.opt.mu[n].any() and not ptask.opt.nu[n].any(), n
    for k in ("fs2/pitch_predictor/linear/kernel", "fs2/dur_predictor/linear/kernel",
              "denoise_fn/res_0/dilated_conv/kernel"):
        assert not np.array_equal(after[k], before[k]), k


def test_cli_trains_the_three_popcs_configs(env, tmp_path, monkeypatch, capsys):
    """`run` on the YAML configs, as phase 12 runs them: popcs_fs2 for 2
    steps, then popcs_ds_beta6 and popcs_ds_beta6_offline (on the recorded
    fs2 mels) for 2 steps each, warm-started from popcs_fs2's work dir;
    finite losses; a resume of the offline run to step 3."""
    monkeypatch.chdir(tmp_path)
    over = _over_string(env["over"])
    fs2_dir = str(tmp_path / "checkpoints" / "fs2")
    for cfg, exp, extra in (("popcs_fs2", "fs2", ""),
                            ("popcs_ds_beta6", "ds", f",fs2_ckpt={fs2_dir}"),
                            ("popcs_ds_beta6_offline", "off", f",fs2_ckpt={fs2_dir}")):
        assert run.main(["--config", CFG[cfg], "--exp_name", exp, "--device", "cpu",
                         "--hparams", over + extra, "--max_updates", "2"]) == 0
        out = capsys.readouterr().out
        steps = [ln for ln in out.splitlines() if ln.startswith("| step 2 [tr]")]
        assert len(steps) == 1 and "nan" not in steps[0], out[-2000:]
        assert ("| warm-started fs2 from" in out) == bool(extra)
        with open(tmp_path / "checkpoints" / exp / "config.json") as f:
            assert json.load(f)["task_cls"].rsplit(".", 1)[-1] == {
                "fs2": "FastSpeech2Task", "ds": "DiffSingerMIDITask",
                "off": "DiffSingerOfflineTask"}[exp]
    assert run.main(["--exp_name", "off", "--device", "cpu", "--max_updates", "3"]) == 0
    assert "| resumed from step 2" in capsys.readouterr().out
