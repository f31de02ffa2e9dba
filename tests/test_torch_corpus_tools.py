"""The port's corpus tools and text processors against the JAX package, on
the CPU: `tools/{merge,meta,proportional,db4_meta,pitch_shift,mfa_prep}.py`,
`data/text/{text_norm,processors}.py` and `utils/pitch.freq_to_midi`.

Every function takes the same inputs on both sides: those of
tests/test_tools.py, tests/test_proportional.py,
tests/test_db4_and_radam.py and tests/test_text_processors.py (imported
from them), plus seeded numpy and `random` ones (the synthetic corpus in
M4Singer's original layout, its M4Singer and MFA TextGrids as
chip_smoke.py's phase 16 writes them, a DB-4 speech set). Outputs must be
equal exactly: JSON-equal items, byte-identical files, the same
RuntimeError without pyworld or pypinyin. Each tool with a command line
runs it (`python -m bisinger_tpu_torch.tools.<tool>`, all in one
interpreter through runpy) and must write the file JAX's function writes.
"""

import filecmp
import json
import os
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import chip_smoke
from bisinger_tpu.data.synthetic import make_synthetic_corpus as j_corpus
from bisinger_tpu.data.text import processors as JP
from bisinger_tpu.data.text import text_norm as JN
from bisinger_tpu.tools import db4_meta as JD
from bisinger_tpu.tools import merge as JM
from bisinger_tpu.tools import meta as JMeta
from bisinger_tpu.tools import mfa_prep as JF
from bisinger_tpu.tools import pitch_shift as JS
from bisinger_tpu.tools import proportional as JPr
from bisinger_tpu.utils import pitch as JPitch
from bisinger_tpu_torch.data.text import processors as PP
from bisinger_tpu_torch.data.text import text_norm as PN
from bisinger_tpu_torch.data.text.pinyin import pinyin_to_cmu
from bisinger_tpu_torch.tools import db4_meta as PD
from bisinger_tpu_torch.tools import merge as PM
from bisinger_tpu_torch.tools import meta as PMeta
from bisinger_tpu_torch.tools import mfa_prep as PF
from bisinger_tpu_torch.tools import pitch_shift as PS
from bisinger_tpu_torch.tools import proportional as PPr
from bisinger_tpu_torch.utils import pitch as PPitch

from test_db4_and_radam import _TG as DB4_TG
from test_proportional import _case, _tg
from test_tools import _m4_item

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITEMS = 12


def _both(jfn, pfn, *args, **kw):
    """JAX's and the port's results on the same arguments, which must be
    equal as JSON (tuples as lists, the types of the numbers kept)."""
    a, b = jfn(*args, **kw), pfn(*args, **kw)
    assert json.dumps(a, ensure_ascii=False) == json.dumps(b, ensure_ascii=False)
    return b


def _items(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(ln) for ln in f if ln.strip()]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A synthetic M4Singer corpus in its original layout (seeded), its meta
    as a JSON list, and its M4Singer and MFA TextGrids in the layout
    tools/proportional reads; a DB-4 speech set of 4 wav and TextGrid pairs
    at 24 kHz in the CMU phones of pinyin."""
    root = tmp_path_factory.mktemp("tools")
    m4 = root / "m4"
    j_corpus(str(m4), n_items=N_ITEMS, seed=3, fmt="m4_original")
    items = _items(m4 / "meta.json")
    (m4 / "meta_list.json").write_text(json.dumps(items, ensure_ascii=False))
    r = np.random.RandomState(0)
    grids = {}
    for item in items:
        singer, song, sent = item["item_name"].split("#")
        grids[item["item_name"]] = m4_tg, mfa_tg = chip_smoke.m4_textgrids(item, r)
        for path, text in ((m4 / "tg_m4" / f"{singer}#{song}" / f"{sent}.TextGrid", m4_tg),
                           (m4 / "tg_mfa" / singer / f"{song}#{sent}.TextGrid", mfa_tg)):
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(text)
    db4 = root / "db4"
    meta = chip_smoke.write_textgrid_corpus(
        str(db4), 4, seed=1, sample_rate=24000, dur_range=(1.0, 1.5), prefix="DB",
        lexicon={s: pinyin_to_cmu(s) for s in chip_smoke.DB4_SYLLABLES})
    transcripts = {m["item_name"]: m["txt"] for m in meta}
    return dict(root=root, m4=m4, items=items, grids=grids, db4=db4, transcripts=transcripts)


# ---- utils/pitch, tools/merge ------------------------------------------------

def test_freq_to_midi_equals_jax():
    freqs = [0.0, -3.0, 1e-3, 27.5, 261.63, 440.0, 466.16, 4186.0]
    freqs += list(np.random.default_rng(0).uniform(20.0, 2000.0, 64))
    assert [JPitch.freq_to_midi(f) for f in freqs] == [PPitch.freq_to_midi(f) for f in freqs]
    assert PS.freq_to_midi is PPitch.freq_to_midi and PD.freq_to_midi is PPitch.freq_to_midi


def test_merge_equals_jax(corpus, tmp_path):
    for name in ("db4#cn#001", "db4#cn-shift#001", "db4#en-shift#7", "db4", "Alto-1#song#001",
                 "ADIZ#01#0002", "db4#shift"):
        _both(JM.speechsing_tag, PM.speechsing_tag, name)
    ins = []
    for k, names in enumerate((["db4#cn#1", "db4#cn-shift#1"], ["Alto-1#s#1", "ADIZ#x#2"])):
        path = tmp_path / f"in{k}.json"
        path.write_text("".join(json.dumps({"item_name": n, "txt": "你好"}, ensure_ascii=False)
                                + "\n\n" for n in names))
        ins.append(str(path))
    ins.append(str(corpus["m4"] / "meta.json"))
    assert JM.merge_meta_jsons(ins, str(tmp_path / "j.json")) == PM.merge_meta_jsons(
        ins, str(tmp_path / "p.json")) == 4 + N_ITEMS
    assert filecmp.cmp(tmp_path / "j.json", tmp_path / "p.json", shallow=False)


# ---- tools/meta ---------------------------------------------------------------

def _py2cmu(path):
    path.write_text("sh SH\nang AE NG\nx X\nin IY N\n\nh HH\nao AW\nbad\nm M\na AA\nl L\ni IY\n")
    return str(path)


def test_meta_conversion_equals_jax(corpus, tmp_path):
    _both(JMeta.slur_runs, PMeta.slur_runs, [0, 0, 1, 1, 0])
    r = random.Random(0)
    for _ in range(20):
        _both(JMeta.slur_runs, PMeta.slur_runs, [r.randint(0, 1) for _ in range(r.randint(0, 12))])
    assert JMeta.ALL_YUNMU == PMeta.ALL_YUNMU
    py2cmu = _both(JMeta.load_py2cmu_map, PMeta.load_py2cmu_map, _py2cmu(tmp_path / "map.txt"))
    for item in [_m4_item()] + corpus["items"]:
        _both(JMeta.convert_m4_item, PMeta.convert_m4_item, item)
        _both(JMeta.convert_m4_item, PMeta.convert_m4_item, item, py2cmu)
    ratios = {"ang": [2.0, 1.0], "in": [1.0, 3.0], "ao": [1.0, 1.0]}
    for item in corpus["items"]:
        _both(JMeta.convert_m4_item, PMeta.convert_m4_item, item, split_ratios=ratios)
    src = str(corpus["m4"] / "meta_list.json")
    assert JMeta.convert_m4_meta(src, str(tmp_path / "j.json")) == PMeta.convert_m4_meta(
        src, str(tmp_path / "p.json")) == N_ITEMS
    assert filecmp.cmp(tmp_path / "j.json", tmp_path / "p.json", shallow=False)


def _aligned_grid(item, r, lead=False):
    """An MFA phone tier over the item's own phones, each duration moved by
    up to 20% (silences empty), with a leading silence the item lacks when
    `lead`."""
    ivs, t = ([(0.0, 0.15, "")], 0.15) if lead else ([], 0.0)
    for ph, d in zip(item["phs"], item["ph_dur"]):
        d = d * float(r.uniform(0.8, 1.2))
        ivs.append((t, t + d, "" if ph == "<SP>" else ph))
        t += d
    return chip_smoke.textgrid_text(t, [("phones", ivs)])


def test_adjust_durations_equals_jax(corpus, tmp_path):
    """adjust_item_durations on each synthetic item against an alignment of
    its own phones (reconciled), the same with a leading silence the item
    lacks (inserted), and the M4Singer grid of another item (left
    unchanged, with the message), each also on the item reduced to its
    phones and durations; adjust_meta_file over the {singer}#{song}/
    layout, the flat one and no grid."""
    items, grids = corpus["items"], corpus["grids"]
    r = np.random.default_rng(4)
    for k, item in enumerate(items):
        other, _ = grids[items[(k + 1) % len(items)]["item_name"]]
        for tg in (_aligned_grid(item, r), _aligned_grid(item, r, lead=True), other):
            _both(JMeta.adjust_item_durations, PMeta.adjust_item_durations, item, tg)
            reduced = {key: item[key] for key in ("item_name", "phs", "ph_dur")}
            _both(JMeta.adjust_item_durations, PMeta.adjust_item_durations, reduced, tg)
    tg_dir = tmp_path / "tg"
    with open(tmp_path / "meta.json", "w", encoding="utf-8") as f:
        for k, item in enumerate(items):
            singer, song, sent = item["item_name"].split("#")
            if k % 3 == 0:  # the reference layout
                path = tg_dir / f"{singer}#{song}" / f"{sent}.TextGrid"
            elif k % 3 == 1:  # the flat fallback, with its warning
                path = tg_dir / f"{sent}.TextGrid"
            else:  # no grid: the item passes through
                path = None
            if path is not None:
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text(_aligned_grid(item, r, lead=k % 2 == 0))
            f.write(json.dumps(item, ensure_ascii=False) + "\n")
    meta = str(tmp_path / "meta.json")
    assert JMeta.adjust_meta_file(meta, str(tg_dir), str(tmp_path / "j.json")) == \
        PMeta.adjust_meta_file(meta, str(tg_dir), str(tmp_path / "p.json")) == N_ITEMS
    assert filecmp.cmp(tmp_path / "j.json", tmp_path / "p.json", shallow=False)


# ---- tools/proportional -------------------------------------------------------

def test_proportional_pieces_equal_jax():
    item, m4_tg, mfa_tg = _case()
    for tg in (m4_tg, mfa_tg):
        _both(JPr.tier_word_phones, PPr.tier_word_phones, tg)
    _both(JPr.align_words, PPr.align_words, ["<AP>", "han", "", "ni"], ["", "han", "sil", "ni"])
    for a, b in ((["a", "b"], ["a"]), (["sp", "x"], ["x", "y"])):
        with pytest.raises(ValueError) as je:
            JPr.align_words(a, b)
        with pytest.raises(ValueError) as pe:
            PPr.align_words(a, b)
        assert str(je.value) == str(pe.value)
    r = np.random.default_rng(0)
    _both(JPr.split_time, PPr.split_time, [0.4, 0.3], 0.6)
    _both(JPr.split_time, PPr.split_time, [0.0, 0.0], 0.5)
    for _ in range(20):
        durs = [round(float(x), 4) for x in r.uniform(0.01, 0.3, r.integers(1, 5))]
        _both(JPr.split_time, PPr.split_time, durs, round(float(r.uniform(0.1, 1.0)), 4))
        notes = [round(float(x), 4) for x in r.uniform(0.05, 0.4, r.integers(1, 5))]
        _both(JPr.locate_boundary, PPr.locate_boundary, float(r.uniform(0, 1.2 * sum(notes))),
              notes)
        n_cmu = int(r.integers(1, 4))
        cmu_durs = PPr.split_time(list(r.uniform(0.2, 1.0, n_cmu)), sum(notes))
        _both(JPr.split_final_rows, PPr.split_final_rows, ["AE", "N", "G"][:n_cmu], cmu_durs,
              notes, [int(x) for x in r.integers(50, 70, len(notes))], notes)


def test_proportional_items_equal_jax(corpus):
    """convert_item_proportional on test_proportional's case and on every
    synthetic item with the grids phase 16 writes; the errors it raises on
    mismatched grids carry the same message."""
    _both(JPr.convert_item_proportional, PPr.convert_item_proportional, *_case())
    items, grids = corpus["items"], corpus["grids"]
    for item in items:
        _both(JPr.convert_item_proportional, PPr.convert_item_proportional, item,
              *grids[item["item_name"]])
    bad_words = _tg([("words", [(0.0, 0.5, "ni"), (0.5, 1.0, "hao")]),
                     ("phones", [(0.0, 0.5, "N"), (0.5, 1.0, "AW")])])
    three = _tg([("words", [(0.0, 0.9, "han")]),
                 ("phones", [(0.0, 0.3, "h"), (0.3, 0.6, "a"), (0.6, 0.9, "n")])])
    item3 = dict(_case()[0], phs=["h", "a", "n"], ph_dur=[0.3, 0.3, 0.3], notes=[60] * 3,
                 notes_dur=[0.9] * 3, is_slur=[0, 0, 0])
    for args in ((items[0], grids[items[0]["item_name"]][0], bad_words),
                 (items[0], grids[items[1]["item_name"]][0], grids[items[0]["item_name"]][1]),
                 (item3, three, _tg([("words", [(0.0, 0.9, "han")]),
                                     ("phones", [(0.0, 0.9, "HH")])]))):
        with pytest.raises(ValueError) as je:
            JPr.convert_item_proportional(*args)
        with pytest.raises(ValueError) as pe:
            PPr.convert_item_proportional(*args)
        assert str(je.value) == str(pe.value)


def test_proportional_pipeline_equals_jax(corpus, tmp_path, capsys):
    """pipeline() over the synthetic corpus plus one item whose grids are
    missing (skipped and reported on both sides; raised under strict)."""
    m4 = corpus["m4"]
    meta = tmp_path / "meta.json"
    meta.write_text((m4 / "meta.json").read_text()
                    + json.dumps(dict(corpus["items"][0], item_name="X#y#0000")) + "\n")
    args = (str(m4 / "tg_m4"), str(m4 / "tg_mfa"))
    assert JPr.pipeline(str(meta), str(tmp_path / "j.json"), *args) == \
        PPr.pipeline(str(meta), str(tmp_path / "p.json"), *args) == (N_ITEMS, 1)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1] and out[0].startswith("[proportional] skip X#y#0000")
    assert filecmp.cmp(tmp_path / "j.json", tmp_path / "p.json", shallow=False)
    with pytest.raises(FileNotFoundError):
        PPr.pipeline(str(meta), str(tmp_path / "s.json"), *args, strict=True)


# ---- tools/db4_meta ------------------------------------------------------------

def test_db4_item_equals_jax(corpus):
    f0 = np.zeros(100, np.float32)
    f0[20:70], f0[70:100] = 220.0, 330.0
    for args in ((f0, 0.2, 0.7, 100.0), (f0, 0.0, 0.2, 100.0), (f0, 0.95, 0.95, 100.0)):
        _both(JD.word_note_from_f0, PD.word_note_from_f0, *args)
    _both(JD.extract_item, PD.extract_item, DB4_TG, f0, 100.0, "db4#cn#0001", "你好", lang=1)
    r = np.random.default_rng(1)
    for m in chip_smoke.write_textgrid_corpus(str(corpus["root"] / "db4_items"), 3, seed=2,
                                              sample_rate=24000, dur_range=(1.0, 1.5)):
        with open(m["tg_fn"]) as f:
            tg = f.read()
        f0 = np.where(r.random(400) < 0.3, 0.0, r.uniform(80, 400, 400)).astype(np.float32)
        _both(JD.extract_item, PD.extract_item, tg, f0, 187.5, m["item_name"], m["txt"], 0)


def test_db4_corpus_equals_jax(corpus, tmp_path):
    """extract_corpus on the DB-4 set (f0 from the Praat-AC tracker where
    parselmouth is absent, with the same warning): the same file."""
    db4 = str(corpus["db4"])
    kw = dict(lang=1, singer="db4", song="cn", transcripts=corpus["transcripts"])
    assert JD.extract_corpus(db4, db4, str(tmp_path / "j.json"), **kw) == PD.extract_corpus(
        db4, db4, str(tmp_path / "p.json"), **kw) == 4
    assert filecmp.cmp(tmp_path / "j.json", tmp_path / "p.json", shallow=False)
    assert any(n > 0 for item in _items(tmp_path / "p.json") for n in item["notes"])


# ---- tools/pitch_shift -----------------------------------------------------------

def test_pitch_shift_equals_jax(corpus, tmp_path):
    assert JS.CHORDS == PS.CHORDS and JS.CANON == PS.CANON and JS._BASE_FREQ == PS._BASE_FREQ
    for note in ("C0", "A4", "B7", "G2"):
        _both(JS.note_to_freq, PS.note_to_freq, note)
    for num in range(1, 8):
        _both(JS.num_to_freq, PS.num_to_freq, num, 3)
    items = [dict(_m4_item(), item_name="db4#cn#0001")]
    items += [dict(it, item_name=f"db4#cn#{k:04d}") for k, it in enumerate(corpus["items"])]
    for k, item in enumerate(items):
        _both(JS.group_notes, PS.group_notes, item["notes"], item["notes_dur"], item["ph_dur"])
        unique, _, sp = PS.group_notes(item["notes"], item["notes_dur"], item["ph_dur"])
        _both(JS.chord_f0_per_window, PS.chord_f0_per_window, unique, sp, PS.CHORDS[k % 10])
        _both(JS.shift_item_meta, PS.shift_item_meta, item, chord=PS.CHORDS[k % 10])
        a = JS.shift_item_meta(item, rng=random.Random(k))
        b = PS.shift_item_meta(item, rng=random.Random(k))
        assert json.dumps(a) == json.dumps(b)
    with pytest.raises(ValueError) as je:  # the name's three '#' parts
        JS.shift_item_meta(_m4_item() | {"item_name": "db4#cn"}, chord=PS.CANON)
    with pytest.raises(ValueError) as pe:
        PS.shift_item_meta(_m4_item() | {"item_name": "db4#cn"}, chord=PS.CANON)
    assert str(je.value) == str(pe.value)
    meta = tmp_path / "db4.json"
    meta.write_text("".join(json.dumps(it, ensure_ascii=False) + "\n" for it in items))
    for seed in (1234, 7):
        assert JS.shift_meta_file(str(meta), str(tmp_path / "j.json"), seed) == \
            PS.shift_meta_file(str(meta), str(tmp_path / "p.json"), seed) == len(items)
        assert filecmp.cmp(tmp_path / "j.json", tmp_path / "p.json", shallow=False)


def test_shift_audio_raises_as_jax_without_pyworld():
    try:
        import pyworld  # noqa: F401
        pytest.skip("pyworld is installed: the resynthesis runs instead of raising")
    except ImportError:
        pass
    args = (np.zeros(2400, np.float32), 24000, [0.1], [220.0])
    with pytest.raises(RuntimeError) as je:
        JS.shift_item_audio(*args)
    with pytest.raises(RuntimeError) as pe:
        PS.shift_item_audio(*args)
    assert str(je.value) == str(pe.value) and "pyworld" in str(pe.value)
    assert type(je.value.__cause__) is type(pe.value.__cause__) is ModuleNotFoundError


# ---- tools/mfa_prep ------------------------------------------------------------

def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


def test_mfa_prep_equals_jax(corpus, tmp_path, capsys):
    tr = tmp_path / "tr.txt"
    lines = [f"{k}\t{v}" for k, v in corpus["transcripts"].items()]
    lines += ["missing\tx y", "DB001-0002 spaced transcript  ", "", "DB001-0003\ttab\tinside"]
    tr.write_text("\n".join(lines) + "\n")
    transcripts = _both(JF.load_transcripts, PF.load_transcripts, str(tr))
    db4 = str(corpus["db4"])
    assert JF.prepare_corpus(db4, transcripts, str(tmp_path / "j"), "db4") == \
        PF.prepare_corpus(db4, transcripts, str(tmp_path / "p"), "db4") == 4
    err = capsys.readouterr().err.splitlines()
    assert err == ["| missing wav for missing, skipped"] * 2
    assert _tree(tmp_path / "j") == _tree(tmp_path / "p")


# ---- the command lines ---------------------------------------------------------

CLI = textwrap.dedent("""
    import runpy, sys
    for argv in {runs!r}:
        sys.argv = argv
        try:
            runpy.run_module(argv[0], run_name="__main__", alter_sys=True)
        except SystemExit as e:
            assert not e.code, (argv, e.code)
""")


def test_clis_write_what_jax_writes(corpus, tmp_path):
    """`python -m bisinger_tpu_torch.tools.<tool>` for the six tools, in one
    interpreter that refuses the JAX package: each output file equals the
    one JAX's function writes from the same inputs."""
    m4, db4 = corpus["m4"], str(corpus["db4"])
    (tmp_path / "tr.txt").write_text(
        "".join(f"{k}\t{v}\n" for k, v in corpus["transcripts"].items()))
    py2cmu = _py2cmu(tmp_path / "map.txt")
    JMeta.convert_m4_meta(str(m4 / "meta_list.json"), str(tmp_path / "j_meta.json"),
                          JMeta.load_py2cmu_map(py2cmu))
    JPr.pipeline(str(m4 / "meta.json"), str(tmp_path / "j_prop.json"), str(m4 / "tg_m4"),
                 str(m4 / "tg_mfa"))
    JD.extract_corpus(db4, db4, str(tmp_path / "j_db4.json"), 0, "db4", "en")
    JS.shift_meta_file(str(tmp_path / "j_db4.json"), str(tmp_path / "j_shift.json"))
    JM.merge_meta_jsons([str(tmp_path / "j_db4.json"), str(tmp_path / "j_shift.json")],
                        str(tmp_path / "j_merge.json"))
    JF.prepare_corpus(db4, JF.load_transcripts(str(tmp_path / "tr.txt")), str(tmp_path / "j_mfa"),
                      "spk")
    t = str(tmp_path)
    runs = [
        ["bisinger_tpu_torch.tools.meta", f"{m4}/meta_list.json", f"{t}/p_meta.json", py2cmu],
        ["bisinger_tpu_torch.tools.proportional", f"{m4}/meta.json", f"{t}/p_prop.json",
         "--m4-tg-dir", f"{m4}/tg_m4", "--mfa-tg-dir", f"{m4}/tg_mfa", "--strict"],
        ["bisinger_tpu_torch.tools.db4_meta", db4, db4, f"{t}/p_db4.json", "--lang", "0",
         "--song", "en"],
        ["bisinger_tpu_torch.tools.pitch_shift", f"{t}/p_db4.json", f"{t}/p_shift.json"],
        ["bisinger_tpu_torch.tools.merge", f"{t}/p_merge.json", f"{t}/p_db4.json",
         f"{t}/p_shift.json"],
        ["bisinger_tpu_torch.tools.mfa_prep", db4, f"{t}/tr.txt", f"{t}/p_mfa"],
    ]
    code = ("import importlib.abc, sys\n"
            "class Refuse(importlib.abc.MetaPathFinder):\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'flax', 'bisinger_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Refuse())\n" + CLI.format(runs=runs))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name in ("meta", "prop", "db4", "shift", "merge"):
        assert filecmp.cmp(tmp_path / f"j_{name}.json", tmp_path / f"p_{name}.json",
                           shallow=False), name
    assert _tree(tmp_path / "j_mfa") == _tree(tmp_path / "p_mfa")
    assert "| converted 12 items ->" in proc.stdout
    assert "[proportional] 12 items written, 0 skipped" in proc.stdout


# ---- data/text/text_norm, data/text/processors -----------------------------------

NSW = [
    "固话：0595-23865596或23880880。", "手机：+86 19859213959或15659451527。", "分数：32477/76391。",
    "百分数：80.03%。", "编号：31520181154418。", "纯数：2983.07克或12345.60米。",
    "日期：1999年2月20日或09年3月15号。", "金钱：12块5，34.5元，20.1万", "特殊：O2O或B2C。",
    "3456万吨", "2938个", "938", "今天吃了115个小笼包231个馒头", "有62％的概率", "我有2个苹果",
    "全长20202米высота", "2024年", "5月1日", "98年5月", "涨了5%", "3/4拍", "共15人", "3.5倍",
    "sing一首歌给你听123", "^开头$结尾^", "ＡＢＣ１２３　全角", "",
]


def test_text_norm_equals_jax():
    r = np.random.default_rng(2)
    numbers = ["0", "10", "14", "2024", "10203", "100000000", "1200", "20202", "0595", "34.5",
               ".5", "0.25", "200002", "1020304050"]
    numbers += [str(int(x)) for x in r.integers(0, 10 ** 12, 40)]
    numbers += [f"{x:.3f}" for x in r.uniform(0, 1000, 20)]
    for s in numbers:
        for kw in ({}, {"use_units": False}, {"alt_two": False}):
            _both(JN.num_to_hanzi, PN.num_to_hanzi, s, **kw)
        _both(JN.digit_reading, PN.digit_reading, s.replace(".", ""), telephone=True)
        _both(JN.cardinal_reading, PN.cardinal_reading, s.split(".")[0])
    for s in ("3.14", "0.5", "12.0"):
        _both(JN.decimal_reading, PN.decimal_reading, s)
    for s in NSW:
        _both(JN.fullwidth_to_halfwidth, PN.fullwidth_to_halfwidth, s)
        _both(JN.normalize_chinese, PN.normalize_chinese, s)
        assert JN.NSWNormalizer(s).normalize(remove_punc=False) == PN.NSWNormalizer(
            s).normalize(remove_punc=False)


def test_processors_equal_jax():
    assert set(JP.REGISTERED_TXT_PROCESSORS) == set(PP.REGISTERED_TXT_PROCESSORS)
    assert PP.get_txt_processor_cls("zh_g2pM") is PP.ZhTxtProcessor
    assert PP.get_txt_processor_cls("en") is PP.EnTxtProcessor
    for n in [0, 21, 105, 3000, -42, 10 ** 9 + 7] + [int(x) for x in
                                                        np.random.default_rng(3).integers(0, 10 ** 10, 30)]:
        _both(JP.english_number_reading, PP.english_number_reading, n)
    for txt in ("I love you 2", "Hello, my 21 friends!", "the quick brown fox's 1999 song",
                "yeah yeah", ""):
        _both(JP.EnTxtProcessor.process, PP.EnTxtProcessor.process, txt)
    for sylls in (["ni", "hao"], ["wo", "ai", "ni"], ["zhuang", "lv", "er"], []):
        _both(JP.ZhTxtProcessor.process_pinyin, PP.ZhTxtProcessor.process_pinyin, sylls)
    for bad in (["ni", "xyz"], ["hello"]):
        with pytest.raises(ValueError) as je:
            JP.ZhTxtProcessor.process_pinyin(bad)
        with pytest.raises(ValueError) as pe:
            PP.ZhTxtProcessor.process_pinyin(bad)
        assert str(je.value) == str(pe.value)
    for txt in ("你好世界", "我爱北京天安门", "ABC"):
        _both(JP._jieba_boundaries, PP._jieba_boundaries, txt)
    _both(JP.ZhTxtProcessor.process, PP.ZhTxtProcessor.process, "abc, O2O")  # no hanzi
    try:
        import pypinyin  # noqa: F401
        _both(JP.ZhTxtProcessor.process, PP.ZhTxtProcessor.process, "你好123")
    except ImportError:
        with pytest.raises(RuntimeError) as je:
            JP.ZhTxtProcessor.process("你好123")
        with pytest.raises(RuntimeError) as pe:
            PP.ZhTxtProcessor.process("你好123")
        assert str(je.value) == str(pe.value) and "pypinyin" in str(pe.value)
