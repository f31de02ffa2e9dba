"""The port's data pipeline against the JAX package, on the CPU: the
synthetic corpus, the binarizer (the flagship's `pitch_extractor:
parselmouth`, which without parselmouth falls back to the Praat AC tracker
in both packages), the record shards in both directions, the DataLoader's
batches over two epochs, the device-resident feeder, and the weights'
export. Each package binarizes its own copy of a 12-item corpus once
(module fixture). Tolerances are stated at each assertion.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from bisinger_tpu.config import load_hparams
from bisinger_tpu.data.binarizer import M4SingerBinarizer as JBinarizer
from bisinger_tpu.data.dataset import DataLoader as JDataLoader
from bisinger_tpu.data.dataset import M4SingerDataset as JDataset
from bisinger_tpu.data.device_corpus import DeviceResidentFeeder as JFeeder
from bisinger_tpu.data.records import RecordReader as JReader
from bisinger_tpu.data.records import RecordWriter as JWriter
from bisinger_tpu.data.synthetic import make_synthetic_corpus as j_corpus
from bisinger_tpu.parallel.mesh import make_mesh
from bisinger_tpu.training.trainer import device_batch
from bisinger_tpu.utils.audio import wav2spec as j_wav2spec
from bisinger_tpu_torch.config import load_hparams_json
from bisinger_tpu_torch.data.binarizer import M4SingerBinarizer
from bisinger_tpu_torch.data.dataset import NON_ARRAY_KEYS, DataLoader, M4SingerDataset
from bisinger_tpu_torch.data.device_corpus import DeviceResidentFeeder
from bisinger_tpu_torch.data.records import RecordReader, RecordWriter
from bisinger_tpu_torch.data.synthetic import make_synthetic_corpus
from bisinger_tpu_torch.utils.audio import wav2spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITEMS = 12


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    j_corpus(str(root / "raw_jax"), n_items=N_ITEMS, seed=0)
    make_synthetic_corpus(str(root / "raw_port"), n_items=N_ITEMS, seed=0)
    over = dict(raw_json_fn="meta.json", num_spk=4, test_prefixes=["Alto-1#song0"],
                pitch_extractor="parselmouth", bucket_tokens=[16, 32],
                bucket_frames=[256, 512], max_tokens=3000, max_sentences=3)
    jhp = load_hparams(overrides=dict(over, raw_data_dir=str(root / "raw_jax"),
                                      binary_data_dir=str(root / "bin_jax")))
    JBinarizer(jhp).process()
    with open(root / "config.json", "w") as f:
        json.dump(dict(jhp.to_dict(), raw_data_dir=str(root / "raw_port"),
                       binary_data_dir=str(root / "bin_port")), f, default=str)
    php = load_hparams_json(str(root / "config.json"))
    M4SingerBinarizer(php).process()
    return dict(root=root, jhp=jhp, php=php)


def test_synthetic_corpus_is_byte_identical(env):
    """The same seed writes the same meta.json and the same wav bytes."""
    root = env["root"]
    jfiles = sorted(os.path.relpath(p, root / "raw_jax")
                    for p in glob.glob(str(root / "raw_jax" / "**" / "*"), recursive=True)
                    if os.path.isfile(p))
    pfiles = sorted(os.path.relpath(p, root / "raw_port")
                    for p in glob.glob(str(root / "raw_port" / "**" / "*"), recursive=True)
                    if os.path.isfile(p))
    assert jfiles == pfiles and len(jfiles) == N_ITEMS + 1
    for rel in jfiles:
        with open(root / "raw_jax" / rel, "rb") as a, open(root / "raw_port" / rel, "rb") as b:
            assert a.read() == b.read(), rel


def test_binarized_items_match_jax(env):
    """Per item: mel within 1e-5, f0 within 1e-3 Hz, and mel2ph, tokens,
    pitch_midi, word boundary, slur, lang and speaker ids equal; the splits,
    lengths, f0 statistics (1e-5 relative), phone set and speaker map too."""
    jdir, pdir = env["jhp"]["binary_data_dir"], env["php"]["binary_data_dir"]
    for fn in ("phone_set.json", "spk_map.json"):
        with open(os.path.join(jdir, fn)) as a, open(os.path.join(pdir, fn)) as b:
            assert json.load(a) == json.load(b)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(np.load(f"{jdir}/{split}_lengths.npy"),
                                      np.load(f"{pdir}/{split}_lengths.npy"))
        np.testing.assert_allclose(np.load(f"{pdir}/{split}_f0s_mean_std.npy"),
                                   np.load(f"{jdir}/{split}_f0s_mean_std.npy"), rtol=1e-5)
        jr, pr = JReader(f"{jdir}/{split}"), RecordReader(f"{pdir}/{split}")
        assert len(jr) == len(pr) > 0
        for i in range(len(jr)):
            a, b = jr[i], pr[i]
            assert set(a) == set(b) and a["item_name"] == b["item_name"]
            assert np.abs(a["mel"] - b["mel"]).max() <= 1e-5
            assert np.abs(a["f0"] - b["f0"]).max() <= 1e-3
            for k in ("phone", "mel2ph", "pitch_midi", "word_boundary", "is_slur", "lang",
                      "pitch", "speechsing", "ph_is_sil"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            for k in ("spk_id", "len", "txt", "ph"):
                assert a[k] == b[k], k
            np.testing.assert_array_equal(a["midi_dur"], b["midi_dur"])
            assert abs(a["sec"] - b["sec"]) < 1e-12


def test_binarize_in_worker_processes_writes_the_same_shards(env, tmp_path, monkeypatch):
    """N_PROC=2 (spawned workers) writes the shards one process writes, byte
    for byte."""
    monkeypatch.setenv("N_PROC", "2")
    M4SingerBinarizer(dict(env["php"], binary_data_dir=str(tmp_path))).process()
    for fn in ("train.data", "train.idx", "valid.data", "train_lengths.npy"):
        with open(tmp_path / fn, "rb") as a, \
                open(os.path.join(env["php"]["binary_data_dir"], fn), "rb") as b:
            assert a.read() == b.read(), fn


def test_wav2spec_matches_jax():
    """wav2spec on a noise burst: the padded wav equal, the log-mel within 1e-5."""
    wav = np.random.RandomState(0).randn(24000).astype(np.float32) * 0.1
    (jw, jm), (pw, pm) = j_wav2spec(wav), wav2spec(wav)
    np.testing.assert_array_equal(jw, pw)
    assert np.abs(jm - pm).max() <= 1e-5


def _equal_records(a, b):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k] and type(a[k]) is type(b[k]), k


def test_shards_cross_read(env, tmp_path):
    """A shard written by JAX reads in the port and the reverse, field for
    field, every field type of the format included."""
    items = [dict(JReader(f"{env['jhp']['binary_data_dir']}/train")[0])]
    items.append({"arr": np.arange(6, dtype=np.int16).reshape(2, 3), "s": "é", "i": -3,
                  "f": 0.25, "b": b"\x00\x01", "n": None, "scalar": np.array(2.5, np.float32)})
    for writer, reader, name in ((JWriter, RecordReader, "jax"), (RecordWriter, JReader, "port")):
        with writer(str(tmp_path / name)) as w:
            for it in items:
                w.add_item(it)
        r = reader(str(tmp_path / name))
        assert len(r) == 2
        for i, it in enumerate(items):
            _equal_records(r[i], it)
    for ext in (".data", ".idx"):
        with open(tmp_path / f"jax{ext}", "rb") as a, open(tmp_path / f"port{ext}", "rb") as b:
            assert a.read() == b.read()


def _same_batch(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_dataloader_batches_match_jax_over_two_epochs(env):
    """Shuffled at the same seed, batch_multiple 2 (the last sample repeats
    to fill a batch): the same batches in the same order, every array
    equal, over two epochs; and the validation loader's."""
    jds = JDataset(env["jhp"], "train", shuffle=True)
    pds = M4SingerDataset(env["php"], "train", shuffle=True)
    jdl = JDataLoader(jds, env["jhp"], shuffle=True, endless=True, batch_multiple=2, seed=7)
    pdl = DataLoader(pds, env["php"], shuffle=True, endless=True, batch_multiple=2, seed=7)
    n = 2 * jdl.batches_per_epoch()
    assert pdl.batches_per_epoch() == n // 2 >= 2
    ji, pi = iter(jdl), iter(pdl)
    for _ in range(n):
        jb, pb = next(ji), next(pi)
        assert jb["item_names"] == pb["item_names"]
        _same_batch(device_batch(jb), {k: v for k, v in pb.items() if k not in NON_ARRAY_KEYS})
    assert pdl.epoch == jdl.epoch == 1
    jv = list(JDataLoader(JDataset(env["jhp"], "valid"), env["jhp"], shuffle=False,
                          max_sentences=1))
    pv = list(DataLoader(M4SingerDataset(env["php"], "valid"), env["php"], shuffle=False,
                         max_sentences=1))
    assert len(jv) == len(pv) == 2
    for jb, pb in zip(jv, pv):
        _same_batch(device_batch(jb), {k: v for k, v in pb.items() if k not in NON_ARRAY_KEYS})


def test_device_resident_feeder_matches_jax(env):
    """The same gathered batches as JAX's feeder (one-device mesh) for four
    epochs, with the epoch tail dropped as JAX drops it: 10 train items in
    batches of 3 give 3 batches an epoch and the permutation's last item
    sits the epoch out; in batches of 4, 2 batches and the last two. Each
    batch holds the rows of its indices exactly."""
    for ms in (3, 4):
        jhp = load_hparams(overrides=dict(max_sentences=ms), base=env["jhp"])
        php = dict(env["php"], max_sentences=ms)
        jf = JFeeder(JDataset(jhp, "train"), jhp, make_mesh(num_data=1), seed=5)
        pf = DeviceResidentFeeder(M4SingerDataset(php, "train"), php, "cpu", seed=5)
        assert pf.batch_size == jf.batch_size == ms and pf.n_items == jf.n_items == 10
        for _ in range(4 * (10 // ms)):
            ji = jf._next_indices()
            jf._pos -= ms  # __next__ draws the same indices again
            jb, pb = next(jf), next(pf)
            assert set(jb) == set(pb)
            for k in jb:
                np.testing.assert_array_equal(np.asarray(jb[k]), pb[k].numpy(), err_msg=k)
            np.testing.assert_array_equal(pb["txt_tokens"].numpy(),
                                          pf.corpus["txt_tokens"][torch.as_tensor(ji)].numpy())
        assert pf.bytes_resident == jf.bytes_resident


def test_export_round_trips_every_port_module(env):
    """weights.export_flax_params of each module the flagship's files fill
    (the diffusion model, the PE with its BatchNorm statistics, the
    vocoder) gives back the files' arrays bit for bit; loading the export
    into a fresh module reproduces it."""
    from bisinger_tpu_torch.inference.pipeline import FLAGSHIP_DIR, SVSInferTorch
    from bisinger_tpu_torch.models.diffusion import GaussianDiffusion
    from bisinger_tpu_torch.weights import export_flax_params, load_flax_params, load_npz

    svs = SVSInferTorch.from_checkpoint(device="cpu")
    voc = sorted(glob.glob(os.path.join(FLAGSHIP_DIR, "vocoder", "**", "generator_*.npz"),
                           recursive=True))[-1]
    for module, files in ((svs.model, ["diff_params.npz"]),
                          (svs.pe, ["pe_params.npz", "pe_batch_stats.npz"]),
                          (svs.vocoder, [voc])):
        want = {}
        for fn in files:
            want.update(load_npz(os.path.join(FLAGSHIP_DIR, fn)))
        got = export_flax_params(module)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k
    fresh = GaussianDiffusion(svs.hp, svs.vocab_size, 80)
    load_flax_params(fresh, export_flax_params(svs.model))
    for a, b in zip(fresh.state_dict().values(), svs.model.state_dict().values()):
        assert torch.equal(a, b)
