"""The BiSinger paper's systems through the port against the JAX package, on
the CPU at tiny widths, fp32, from their own YAML configs
(configs/usr/m4singer/*.yaml, configs/usr/les-m4-nus/*.yaml) with the same
overrides on both sides:

- the synthetic corpus in M4Singer's original layout converted to system
  1's meta by the port's tools/meta.py, and binarized by the port's
  `run --binarize` and by JAX's M4SingerBinarizer: the same items; the
  original-layout meta read through `derive_word_boundary`;
- the monolingual FastSpeech2MIDI (`use_lang_embed: false`: no ESM, lang
  or style parameters), its forward, and one train step of
  AuxDecoderMIDITask and of DiffSingerMIDITask;
- the EN->CN phone substitution of systems 1 and 2 in the score front end;
- the CLI: m4singer/fs2.yaml and system1.yaml a step each, the second
  warm-started from the first's work dir, then `run --infer` with the
  substitution.

Bounds, as PERF.md §2 states them: the forward within 1e-5 of
max(1, the output's largest |value|) (both sides fp32, sums in another
order); a step's losses within 1e-5 of their values, every gradient within
1e-4 of the largest, the parameters after the update within 1e-6
(tests/test_torch_training.py's `_check_step`). Parameters are flax's
initialisers drawn on the port's side into the tree JAX's traced init
gives, and carried to JAX through the flat flax keys.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from bisinger_tpu.config import load_hparams as j_load_hparams
from bisinger_tpu.data.binarizer import M4SingerBinarizer as JBinarizer
from bisinger_tpu.data.dataset import DataLoader as JDataLoader
from bisinger_tpu.data.dataset import M4SingerDataset as JDataset
from bisinger_tpu.data.records import RecordReader as JReader
from bisinger_tpu.data.synthetic import make_synthetic_corpus as j_corpus
from bisinger_tpu.data.text.frontend import BilingualFrontend as JFrontend
from bisinger_tpu.models.fs2 import FastSpeech2MIDI as JFastSpeech2MIDI
from bisinger_tpu.training import tasks as JT
from bisinger_tpu.training.trainer import device_batch
from bisinger_tpu.utils.text_encoder import TokenTextEncoder as JEncoder
from bisinger_tpu.utils.text_encoder import build_phone_encoder
from bisinger_tpu.vocoders.hifigan import unflatten_params
from bisinger_tpu_torch import run
from bisinger_tpu_torch.config import load_hparams
from bisinger_tpu_torch.data.binarizer import M4SingerBinarizer
from bisinger_tpu_torch.data.dataset import batch_to_device
from bisinger_tpu_torch.data.records import RecordReader
from bisinger_tpu_torch.data.text.frontend import ENGLISH, EN_PHONE_SUBST, BilingualFrontend
from bisinger_tpu_torch.models.fs2 import FastSpeech2MIDI
from bisinger_tpu_torch.tools.meta import convert_m4_meta
from bisinger_tpu_torch.training import tasks as PT
from bisinger_tpu_torch.training.checkpoints import CheckpointManager
from bisinger_tpu_torch.utils.text_encoder import TokenTextEncoder
from bisinger_tpu_torch.weights import export_flax_params, load_flax_params

from test_torch_popcs_training import _over_string
from test_torch_training import _check_step, _diff_draws, _flat, _jax_step, _with_noisy_out
from torch_port_helpers import TINY, max_err, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {name: os.path.join(REPO, "configs", "usr", "m4singer", f"{name}.yaml")
       for name in ("fs2", "system1", "system2")}
N_ITEMS = 10
# the synthetic items are "<singer>#song<i % 3>#<i:04d>"; the configs' own
# held-out songs match none of them
DATA = dict(test_prefixes=["Alto-1#song0#000", "Tenor-1#song1#000"], pitch_extractor="autocorr",
            raw_json_fn="meta_system1.json")
TRAIN = dict(
    {k: v for k, v in TINY.items() if k != "num_spk"}, **DATA, bucket_tokens=[32],
    bucket_frames=[256], max_tokens=4000, max_sentences=4, max_eval_sentences=4, dropout=0.0,
    predictor_dropout=0.0, lr=1e-3, warmup_updates=2, decay_steps=2, clip_grad_norm=1.0,
    log_interval=1, val_check_interval=1000, num_sanity_val_steps=1, num_ckpt_keep=2)
LANG_KEYS = ("esm", "lang_embed", "style_embed")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The synthetic M4Singer corpus (original layout, 10 items) converted by
    the port's tools/meta.py to system 1's meta; each package binarizes it
    from m4singer/fs2.yaml (the port through its CLI); two batches of JAX's
    DataLoader."""
    root = tmp_path_factory.mktemp("m4singer")
    j_corpus(str(root / "raw"), n_items=N_ITEMS, seed=0, fmt="m4_original")
    with open(root / "raw" / "meta.json", encoding="utf-8") as f:
        original = [json.loads(ln) for ln in f if ln.strip()]
    (root / "raw" / "meta_list.json").write_text(json.dumps(original))
    assert convert_m4_meta(str(root / "raw" / "meta_list.json"),
                           str(root / "raw" / "meta_system1.json")) == N_ITEMS
    raw = str(root / "raw")
    JBinarizer(j_load_hparams(CFG["fs2"], dict(DATA, raw_data_dir=raw,
                                               binary_data_dir=str(root / "bin_jax")))).process()
    cwd = os.getcwd()
    os.chdir(root)
    try:
        assert run.main(["--config", CFG["fs2"], "--binarize", "--hparams", _over_string(
            dict(DATA, raw_data_dir=raw, binary_data_dir=str(root / "bin_port")))]) == 0
    finally:
        os.chdir(cwd)
    over = dict(TRAIN, raw_data_dir=raw, binary_data_dir=str(root / "bin_jax"))
    jhp = {name: j_load_hparams(path, over) for name, path in CFG.items()}
    php = {name: load_hparams(path, over) for name, path in CFG.items()}
    vocab = build_phone_encoder(str(root / "bin_jax")).vocab_size
    dl = iter(JDataLoader(JDataset(jhp["system1"], "train", shuffle=True), jhp["system1"],
                          shuffle=True, endless=True))
    batches = [device_batch(next(dl)) for _ in range(2)]
    return dict(root=root, jhp=jhp, php=php, vocab=vocab, batches=batches, over=over,
                original=original)


def test_paper_configs_are_the_monolingual_midi_systems(env):
    for name in CFG:
        jhp, php = env["jhp"][name], env["php"][name]
        assert php["use_midi"] and not php["use_lang_embed"] and not jhp["use_lang_embed"]
        assert php["num_spk"] == jhp["num_spk"] == 21
        assert php["test_prefixes"] == list(jhp["test_prefixes"]) == DATA["test_prefixes"]
        assert php.get("en_phone_subst") == jhp.get("en_phone_subst") == (
            None if name == "fs2" else name)
        assert php["task_cls"] == jhp["task_cls"]


def test_les_m4_nus_diff_resolves_as_jax_does():
    """les-m4-nus/diff.yaml lists ../m4-detect-ori-shift/diff.yaml and then
    ./base.yaml; the second reaches tts/fs2.yaml again, and its task_cls
    and lr merge back over the diffusion stage's. JAX and the port both
    resolve it to the FFT-Singer task (ROADMAP Queue 3, fault 6, matched);
    the reference's loader, which loads each file once, gives
    DiffSingerMIDITask and lr 0.001. Naming the task gives the diffusion
    stage on both sides."""
    path = os.path.join(REPO, "configs", "usr", "les-m4-nus", "diff.yaml")
    jhp, php = j_load_hparams(path), load_hparams(path)
    assert php["task_cls"] == jhp["task_cls"] == "bisinger_tpu.training.tasks.AuxDecoderMIDITask"
    assert php["lr"] == jhp["lr"] == 2.0 and php["fs2_ckpt"] == jhp["fs2_ckpt"]
    over = dict(task_cls="bisinger_tpu.training.tasks.DiffSingerMIDITask")
    assert PT.task_class(load_hparams(path, over)["task_cls"]) is PT.DiffSingerMIDITask
    assert j_load_hparams(path, over)["task_cls"] == over["task_cls"]


def test_binarized_items_match_jax(env):
    """The tool-converted meta through both binarizers: the splits (the
    configs' '#' prefixes replaced by ours), phone set, speaker map,
    lengths, f0 statistics and every item's arrays."""
    jdir, pdir = env["root"] / "bin_jax", env["root"] / "bin_port"
    for fn in ("phone_set.json", "spk_map.json"):
        with open(jdir / fn) as a, open(pdir / fn) as b:
            assert json.load(a) == json.load(b)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(np.load(jdir / f"{split}_lengths.npy"),
                                      np.load(pdir / f"{split}_lengths.npy"))
        np.testing.assert_allclose(np.load(pdir / f"{split}_f0s_mean_std.npy"),
                                   np.load(jdir / f"{split}_f0s_mean_std.npy"), rtol=1e-5)
        jr, pr = JReader(str(jdir / split)), RecordReader(str(pdir / split))
        assert len(jr) == len(pr) == {"train": 6}.get(split, 4)
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


def test_original_layout_meta_reads_as_jax(env):
    """The original-layout meta (pinyin phones, no word_boundary, lang or
    speechsing) as both binarizers read it: word boundaries derived from
    the finals and silences, lang 1 on every phone, speechsing 1, the wav
    found by the item's name."""
    raw = str(env["root"] / "raw")
    hp = dict(DATA, raw_data_dir=raw, raw_json_fn="meta.json")
    jb = JBinarizer(j_load_hparams(CFG["fs2"], hp))
    pb = M4SingerBinarizer(load_hparams(CFG["fs2"], hp))
    jb.load_meta_data()
    pb.load_meta_data()
    assert jb.item_names == pb.item_names and len(pb.item_names) == N_ITEMS
    for name in pb.item_names:
        a, b = jb.items[name], pb.items[name]
        assert set(a) == set(b)
        for k in b:
            assert json.dumps(a[k]) == json.dumps(b[k]), (name, k)
        assert os.path.exists(b["wav_fn"]) and b["lang"] == [1] * len(b["word_boundary"])
    assert jb.split_train_test() == tuple(pb.split_train_test())


def _task_pair(env, name, jcls, pcls, seed=0):
    jhp, php, batch = env["jhp"][name], env["php"][name], env["batches"][0]
    jtask = jcls(jhp, env["vocab"])
    shapes = jax.eval_shape(jtask.init_state, jax.random.PRNGKey(0), batch).params
    ptask, fresh = (pcls(php, env["vocab"], device="cpu") for _ in range(2))
    PT.flax_init_(ptask.model, seed)
    params = unflatten_params(export_flax_params(ptask.model))
    assert {k: v.shape for k, v in flatten_dict(shapes, sep="/").items()} == {
        k: v.shape for k, v in flatten_dict(params, sep="/").items()}
    return jtask, ptask, fresh, params


def test_lang_free_model_has_no_lang_parameters_and_loads_strictly(env, tmp_path):
    """JAX's traced init and the port's module hold the same tree, without
    an ESM, lang or style embedding; load_flax_params takes that tree and
    refuses a key it does not use, a missing key and a misshaped one."""
    _, ptask, _, params = _task_pair(env, "fs2", JT.AuxDecoderMIDITask, PT.AuxDecoderMIDITask)
    flat = _flat(params)
    assert flat and not [k for k in flat if k.split("/")[0] in LANG_KEYS]
    model = FastSpeech2MIDI(env["php"]["fs2"], env["vocab"])
    load_flax_params(model, flat)
    with pytest.raises(KeyError, match="lang_embed"):
        load_flax_params(model, dict(flat, **{"lang_embed/embedding": np.zeros((2, 32))}))
    key = "midi_embed/embed/embedding"
    with pytest.raises(KeyError, match="not filled"):
        load_flax_params(model, {k: v for k, v in flat.items() if k != key})
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(model, dict(flat, **{key: flat[key][:-1]}))
    lang_model = FastSpeech2MIDI(dict(env["php"]["fs2"], use_lang_embed=True), env["vocab"])
    with pytest.raises(KeyError, match="not filled"):  # the bilingual model needs its ESM
        load_flax_params(lang_model, flat)


def test_lang_free_forward_matches_jax(env):
    """The lang-free FastSpeech2MIDI on a corpus batch, given durations and
    predicted ones: mel_out, decoder_inp and dur within 1e-5 of max(1,
    |output|); lang and speechsing (a 2 among them) move neither side."""
    _, ptask, _, params = _task_pair(env, "fs2", JT.AuxDecoderMIDITask, PT.AuxDecoderMIDITask,
                                     seed=5)
    b = env["batches"][1]
    kw = {k: np.asarray(b[k]) for k in ("pitch_midi", "midi_dur", "is_slur", "lang",
                                        "speechsing")}
    jm = JFastSpeech2MIDI(hp=env["jhp"]["fs2"], vocab_size=env["vocab"])
    m = FastSpeech2MIDI(env["php"]["fs2"], env["vocab"])
    load_flax_params(m, _flat(params))
    m.eval()
    for mel2ph in (np.asarray(b["mel2ph"]), None):
        extra = {} if mel2ph is not None else {"max_frames": 64}
        apply = jax.jit(lambda p, tokens, m2p, spk, kw: jm.apply(
            {"params": p}, tokens, mel2ph=m2p, spk_embed=spk, **kw, **extra))
        ref = apply(params, np.asarray(b["txt_tokens"]), mel2ph, np.asarray(b["spk_ids"]), kw)
        with torch.no_grad():
            got = m(t(b["txt_tokens"]), mel2ph=None if mel2ph is None else t(mel2ph),
                    spk_id=t(b["spk_ids"]), **{k: t(v) for k, v in kw.items()}, **extra)
            other = m(t(b["txt_tokens"]), mel2ph=None if mel2ph is None else t(mel2ph),
                      spk_id=t(b["spk_ids"]), **{k: t(v) for k, v in kw.items()
                                                 if k not in ("lang", "speechsing")},
                      lang=t(1 - kw["lang"]), speechsing=t(np.full_like(kw["speechsing"], 2)),
                      **extra)
        for key in ("mel_out", "decoder_inp") + (("dur",) if mel2ph is None else ()):
            ref_k = np.asarray(ref[key])
            assert max_err(got[key].numpy(), ref_k) <= 1e-5 * max(1.0, np.abs(ref_k).max()), key
            np.testing.assert_array_equal(got[key].numpy(), other[key].numpy())
        np.testing.assert_array_equal(got["mel2ph"].numpy(), np.asarray(ref["mel2ph"]))


PAIRS = {"AuxDecoderMIDITask": ("fs2", JT.AuxDecoderMIDITask, PT.AuxDecoderMIDITask),
         "DiffSingerMIDITask": ("system1", JT.DiffSingerMIDITask, PT.DiffSingerMIDITask)}


@pytest.mark.parametrize("name", list(PAIRS))
def test_one_fp32_train_step_matches_jax(env, name):
    cfg, jcls, pcls = PAIRS[name]
    jtask, ptask, fresh, params = _task_pair(env, cfg, jcls, pcls)
    batch = env["batches"][0]
    diffusion = name == "DiffSingerMIDITask"
    if diffusion:
        params = _with_noisy_out(params)
    state = JT.TrainState.create(apply_fn=jtask.model.apply, params=params, tx=jtask.tx)
    for task in (ptask, fresh):
        task.load_state(_flat(params))
    rng = jax.random.PRNGKey(17)
    jres = _jax_step(jtask, state, batch, rng)
    pins = {}
    if diffusion:
        tt, noise = _diff_draws(rng, batch, env["jhp"][cfg]["K_step"])
        pins = dict(t=tt, noise=noise)
    pout = ptask.train_step(batch_to_device(batch, "cpu"), **pins)
    assert set(jres[1]) == set(pout) - {"total_loss", "grad_norm"}
    assert ("mel" in pout) == diffusion and {"pdur", "wdur", "sdur"} <= set(pout)
    jg = _check_step(jres, ptask, fresh, pout, name)
    prefix = "fs2/" if diffusion else ""
    assert np.abs(jg[prefix + "midi_embed/embed/embedding"]).max() > 0
    assert not [k for k in jg if k.split("/")[1 if diffusion else 0] in LANG_KEYS]


SCORES = [
    dict(text="SP they ni hao SP", notes="rest | C4 | D4 | E4 | rest",
         notes_duration="0.1 | 0.3 | 0.3 | 0.4 | 0.1"),
    dict(text="yeah wo ai ni", notes="E4 | D4 | C4 D4 | G4",
         notes_duration="0.3 | 0.2 | 0.2 0.2 | 0.5"),
    dict(text="SP the voice of you with joy SP", notes="rest | C4 | D4 E4 | F4 | G4 | A4 | B4 C5 | rest",
         notes_duration="0.1 | 0.2 | 0.2 0.2 | 0.2 | 0.3 | 0.2 | 0.2 0.3 | 0.1"),
    dict(text="think of boy yi wu", notes="C4 | D4 | E4 | F4 | G4",
         notes_duration="0.3 | 0.2 | 0.4 | 0.3 | 0.3"),
]


@pytest.mark.parametrize("system", [None, "system1", "system2"])
def test_phone_substitution_equals_jax(system):
    """The score front end with each system's EN->CN table on bilingual
    scores: ph_seq, notes, durations, slurs and lang as JAX's; the English
    rows hold no key of the table and hold the phones it substituted; the
    Chinese rows are left as they are (W and Y come from pinyin too)."""
    phones = sorted({p for ps in EN_PHONE_SUBST["system1"].items() for p in ps}
                    | {"<SP>", "AA", "AE", "AH", "AW", "AY", "EH", "ER", "EY", "F", "HH", "IY",
                       "JH", "K", "L", "M", "N", "NG", "R", "S", "T", "UH", "UW", "Z"})
    jfe = JFrontend(JEncoder(vocab_list=phones, replace_oov=","), phone_subst=system)
    pfe = BilingualFrontend(TokenTextEncoder(vocab_list=phones, replace_oov=","),
                            phone_subst=system)
    plain = BilingualFrontend(TokenTextEncoder(vocab_list=phones, replace_oov=","))
    table = EN_PHONE_SUBST.get(system, {})
    for score in SCORES:
        a, b = jfe.preprocess_word_level(score), pfe.preprocess_word_level(score)
        assert json.dumps(a, default=str) == json.dumps(b, default=str)
        raw = plain.preprocess_word_level(score)
        en = [p for p, lg in zip(b["ph_seq"].split(), b["lang"]) if lg == ENGLISH]
        raw_en = [p for p, lg in zip(raw["ph_seq"].split(), raw["lang"]) if lg == ENGLISH]
        assert not set(en) & set(table) and {table[p] for p in raw_en if p in table} <= set(en)
        cn = [p for p, lg in zip(b["ph_seq"].split(), b["lang"]) if lg != ENGLISH]
        assert cn == [p for p, lg in zip(raw["ph_seq"].split(), raw["lang"]) if lg != ENGLISH]
        assert len(b["ph_seq"].split()) == len(b["note_lst"]) == len(b["is_slur"])
        if system:
            assert set(raw_en) & set(table)  # each score gives the table work


def test_cli_trains_and_serves_system1(env, tmp_path, monkeypatch, capsys):
    """`run` on the configs, as chip_smoke.py's phase 16 runs them:
    m4singer/fs2.yaml for a step on the port's binarized corpus, then
    system1.yaml for a step warm-started from its work dir; neither
    checkpoint holds an ESM, lang or style key; `run --infer` serves a
    bilingual score from system1's work dir with the flagship's PE and
    vocoder, its English word through system 1's table."""
    monkeypatch.chdir(tmp_path)
    over = _over_string(dict(env["over"], binary_data_dir=str(env["root"] / "bin_port")))
    fs2_dir = str(tmp_path / "checkpoints" / "fs2")
    for cfg, exp, extra in (("fs2", "fs2", ""), ("system1", "s1", f",fs2_ckpt={fs2_dir}")):
        assert run.main(["--config", CFG[cfg], "--exp_name", exp, "--device", "cpu",
                         "--hparams", over + extra, "--max_updates", "1"]) == 0
        out = capsys.readouterr().out
        steps = [ln for ln in out.splitlines() if ln.startswith("| step 1 [tr]")]
        assert len(steps) == 1 and "nan" not in steps[0], out[-2000:]
        assert ("| warm-started fs2 from" in out) == bool(extra)
        restored = CheckpointManager(str(tmp_path / "checkpoints" / exp / "ckpt")).restore()
        keys = list(restored["params"])
        assert keys and not [k for k in keys if k.split("/")[1 if extra else 0] in LANG_KEYS]
    with open(tmp_path / "checkpoints" / "s1" / "config.json") as f:
        saved = json.load(f)
    assert saved["task_cls"].endswith("DiffSingerMIDITask") and saved["en_phone_subst"] == "system1"
    score = dict(item_name="paper", text="SP hao xin yeah ma SP",
                 notes="rest | C4 | D4 | E4 | G4 | rest",
                 notes_duration="0.1 | 0.2 | 0.2 | 0.3 | 0.2 | 0.1")
    (tmp_path / "score.json").write_text(json.dumps([score]))
    assert run.main(["--infer", "--exp_name", "s1", "--device", "cpu", "--input", "score.json",
                     "--out", "out"]) == 0
    from scipy.io import wavfile

    sr, wav = wavfile.read(tmp_path / "out" / "paper.wav")
    assert sr == 24000 and len(wav) > 0 and len(wav) % 128 == 0
    hp = load_hparams(str(tmp_path / "checkpoints" / "s1" / "config.json"))
    fe = BilingualFrontend(build_phone_encoder(hp["binary_data_dir"]),
                           phone_subst=hp["en_phone_subst"])
    ret = fe.preprocess_word_level(score)
    en = [p for p, lg in zip(ret["ph_seq"].split(), ret["lang"]) if lg == ENGLISH]
    assert en == ["IY", "AE"]  # yeah: Y AE, Y -> IY
    assert all(i != fe.encoder.unk_index for i in fe.encoder.encode(ret["ph_seq"]))
