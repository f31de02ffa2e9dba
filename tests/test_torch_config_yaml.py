"""The port's YAML configs against the JAX package's loader, on the CPU:
every `configs/**/*.yaml` read by the port's subset reader and cascade
(`bisinger_tpu_torch/yaml_subset.py`, `config.load_hparams`) gives the
mapping `bisinger_tpu.config.load_hparams` gives (PyYAML's safe_load,
YAML 1.1): the same keys, values and Python types, and the same
`_explicit_keys`, alone and with a dotted override on top. The scalar
typing is held to PyYAML's on a list of spellings; each construct outside
the subset raises naming the file and the line; the base_config cascade's
resolution, diamonds and cycles behave as JAX's; and a YAML config loads
in an interpreter that refuses `yaml`.
"""

import glob
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import yaml

from bisinger_tpu.config import load_hparams as j_load_hparams
from bisinger_tpu_torch import run
from bisinger_tpu_torch import yaml_subset
from bisinger_tpu_torch.config import DEFAULTS, load_config_file, load_hparams
from bisinger_tpu_torch.data.binarizer import binarizer_class
from bisinger_tpu_torch.training.tasks import task_class

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO)
                 for p in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                                    recursive=True))
# keys the port's defaults hold and the JAX package's do not (JAX reads
# them with a default of the same value)
PORT_ONLY = {"use_lang_embed", "esm_cross_batch", "diff_sampler", "dpm_steps",
             "vocoder_multiband", "device_resident_corpus", "dataloader_prefetch"}
OVERRIDE = "hidden_size=64,binarization_args.with_wav=true,lr=0.5"


def same(a, b) -> bool:
    """Equal values of the same Python types, all the way down (a JAX
    HParams gives tuples where the port keeps lists)."""
    a = list(a) if isinstance(a, tuple) else a
    b = list(b) if isinstance(b, tuple) else b
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_every_config_is_listed():
    assert len(CONFIGS) >= 48
    assert {"configs/usr/popcs_fs2.yaml", "configs/usr/popcs_ds_beta6.yaml",
            "configs/usr/popcs_ds_beta6_offline.yaml", "configs/usr/m4singer/base.yaml",
            "configs/config_base.yaml"} <= set(CONFIGS)


@pytest.mark.parametrize("path", CONFIGS)
def test_config_loads_as_jax_loads_it(path, monkeypatch):
    """The file with its bases merged, and its own keys as _explicit_keys,
    equal JAX's (load_hparams over an empty base); over the defaults, every
    key of the port's mapping equals JAX's and every key JAX's cascade set
    is there, with and without a dotted --hparams override."""
    monkeypatch.chdir(REPO)
    own: list = []
    cascade = load_config_file(os.path.join(REPO, path), own_keys=own)
    cascade["_explicit_keys"] = sorted(set(own))
    want = j_load_hparams(path, base={}).to_dict()
    assert same(cascade, want), path
    for over in (None, OVERRIDE):
        jax_hp = j_load_hparams(path, over).to_dict()
        port_hp = load_hparams(path, over)
        for k, v in port_hp.items():
            if k in PORT_ONLY and k not in jax_hp:
                assert k in DEFAULTS and k not in cascade
                continue
            assert k in jax_hp and same(v, jax_hp[k]), (path, over, k, v, jax_hp.get(k))
        assert set(cascade) <= set(port_hp)
        assert same(port_hp["_explicit_keys"], jax_hp["_explicit_keys"])


def test_wav2spec_eps_stays_the_string_pyyaml_reads():
    """YAML 1.1 needs a dot in a float: `1e-6` is the string "1e-6" in
    both loaders (the binarizer float()s it)."""
    path = "configs/usr/m4singer/base.yaml"
    got = load_hparams(os.path.join(REPO, path))["wav2spec_eps"]
    assert got == "1e-6" == j_load_hparams(os.path.join(REPO, path))["wav2spec_eps"]
    assert yaml.safe_load("a: 1e-6")["a"] == "1e-6"


SCALARS = """\
a: 1e-6
b: 1.0e5
c: 1.0e+5
d: .5
e: -.inf
f: .NaN
g: 0o17
k: 1_000
n: yes
o: Off
p: ~
q:
r: 'it''s'
s: "tab here é # not a comment"
t: [1, [2, 3], {x: 1, y: [a, b]}, '', "q", ]
u: {data: -1, model: 1}
v: plain text # a comment
w: a#b
x: -1
y: +12
z: 2.
aa: [ ]
bb: {}
1: one
true: t
null: n
cc:
- 1
- two
dd:
  e:
    f: [x]
  g: 3
ee: http://x.y/z
ff: 'a: b'
hh: 0.
ii: 1.5e-3
jj: [null, ~, True, no, NULL, FALSE]
kk: ?x
ll: -x
mm: 'a' # c
nn:
  - [1, 2]
  -
    - 3
oo: 1.0
oo: 2
"""


def test_scalars_are_typed_as_pyyaml_types_them():
    """Each spelling (null, the YAML 1.1 bools, decimal ints, floats with
    and without exponents, `0o17` (a string in YAML 1.1), quoted strings,
    nested flow collections, a repeated key) gives safe_load's value and
    type."""
    assert same(yaml_subset.loads(SCALARS), yaml.safe_load(SCALARS))


BAD = [
    ("a: 1\nb: &x 2\n", 2, "anchor"),
    ("a: 1\nb: *x\n", 2, "alias"),
    ("a: |\n  x\n", 1, "block scalar"),
    ("a: >\n  x\n", 1, "block scalar"),
    ("a: 1\n---\nb: 2\n", 2, "more than one document"),
    ("a:\n\t- 1\n", 2, "tab"),
    ("a: [1,\n  2]\n", 1, "several lines"),
    ("a: 1\n? b\n: 2\n", 2, "complex key"),
    ("a: !!str 1\n", 1, "tag"),
    ("a: 2001-12-14\n", 1, "timestamp"),
    ("- a: 1\n", 1, "inside a block sequence"),
    ("a: b: c\n", 1, "mapping value"),
    ("a: 'x\n", 1, "several lines"),
    ("a: x\n  y\n", 2, "several lines"),
    ("%YAML 1.1\n---\na: 1\n", 1, "directive"),
    ("a: 1\nb: 017\n", 2, "octal, binary, hex or base 60"),
    ("a: 0x1F\n", 1, "octal, binary, hex or base 60"),
    ("a: [0b101]\n", 1, "octal, binary, hex or base 60"),
    ("a: 1:30\n", 1, "octal, binary, hex or base 60"),
    ("a: {b: 1:30.5}\n", 1, "octal, binary, hex or base 60"),
    ('a: "tab\\there"\n', 1, "backslash escape"),
]


@pytest.mark.parametrize("text,line,what", BAD)
def test_unsupported_constructs_name_the_file_and_line(tmp_path, text, line, what):
    fn = tmp_path / "bad.yaml"
    fn.write_text(text)
    with pytest.raises(yaml_subset.YAMLSubsetError, match=what) as e:
        yaml_subset.load_file(str(fn))
    assert str(e.value).startswith(f"{fn}:{line}: ") and e.value.line == line


def test_cascade_resolution_diamond_and_cycle(tmp_path, monkeypatch):
    """A base is found next to the including file, then under configs/,
    then in the current directory; two parents may share a base (a
    diamond); a cycle raises. Both loaders agree on each file."""
    (tmp_path / "sub").mkdir()
    (tmp_path / "cwd").mkdir()
    (tmp_path / "sub" / "grand.yaml").write_text("g: 1\nnest: {a: 1, b: 2}\nx: grand\n")
    (tmp_path / "sub" / "left.yaml").write_text("base_config: ./grand.yaml\nx: left\n"
                                                "nest:\n  a: 10\n")
    (tmp_path / "sub" / "right.yaml").write_text("base_config: grand.yaml\nx: right\nr: 1\n")
    (tmp_path / "cwd" / "from_cwd.yaml").write_text("c: 3\n")
    (tmp_path / "sub" / "child.yaml").write_text(
        "base_config:\n  - ./left.yaml\n  - right.yaml\n  - tts/base.yaml\n"
        "  - from_cwd.yaml\nx: child\nhidden_size: 7\n")
    (tmp_path / "sub" / "cyc_a.yaml").write_text("base_config: cyc_b.yaml\na: 1\n")
    (tmp_path / "sub" / "cyc_b.yaml").write_text("base_config: cyc_a.yaml\nb: 1\n")
    monkeypatch.chdir(tmp_path / "cwd")
    child = str(tmp_path / "sub" / "child.yaml")
    got = load_hparams(child)
    want = j_load_hparams(child).to_dict()
    assert got["x"] == "child" and got["r"] == 1 and got["c"] == 3 and got["g"] == 1
    # right.yaml comes after left.yaml and brings grand.yaml's nest back
    assert got["nest"] == {"a": 1, "b": 2} and got["hop_size"] == 256  # tts/base.yaml
    assert got["_explicit_keys"] == ["hidden_size", "x"]
    for k in ("x", "r", "c", "g", "nest", "hop_size", "hidden_size", "_explicit_keys"):
        assert same(got[k], want[k]), k
    for fn in ("cyc_a.yaml", "cyc_b.yaml"):
        with pytest.raises(ValueError, match="cycle"):
            load_hparams(str(tmp_path / "sub" / fn))
        with pytest.raises(ValueError, match="cycle"):
            j_load_hparams(str(tmp_path / "sub" / fn))
    (tmp_path / "sub" / "missing.yaml").write_text("base_config: nowhere.yaml\n")
    with pytest.raises(FileNotFoundError, match="nowhere.yaml"):
        load_hparams(str(tmp_path / "sub" / "missing.yaml"))
    (tmp_path / "sub" / "list.yaml").write_text("- 1\n")
    with pytest.raises(ValueError, match="top level must be a mapping"):
        load_hparams(str(tmp_path / "sub" / "list.yaml"))


def test_run_takes_a_yaml_or_a_json_config(tmp_path, monkeypatch):
    """`run --config` reads a YAML config (a path under configs/ or from the
    current directory) or a JSON one; --hparams goes on top; the work dir's
    saved config.json keeps precedence on resume."""
    monkeypatch.chdir(REPO)
    for path in ("usr/popcs_ds_beta6.yaml", "configs/usr/popcs_ds_beta6.yaml"):
        hp = run.load_config(run.parse_args(["--config", path, "--hparams", "K_step=7"]),
                             str(tmp_path / "none"))
        assert hp["K_step"] == 7 and hp["timesteps"] == 100 and hp["max_beta"] == 0.06
        assert hp["use_midi"] is False and hp["task_cls"].endswith("DiffSingerMIDITask")
        assert "K_step" in hp["_explicit_keys"] and "lr" not in hp["_explicit_keys"]
    assert task_class(load_hparams("usr/popcs_ds_beta6_offline.yaml")["task_cls"]) \
        .__name__ == "DiffSingerOfflineTask"
    assert binarizer_class(load_hparams("usr/popcs_fs2.yaml")["binarizer_cls"]) \
        .__name__ == "MidiSingingBinarizer"
    with open(tmp_path / "c.json", "w") as f:
        json.dump({"hidden_size": 48}, f)
    assert run.load_config(run.parse_args(["--config", str(tmp_path / "c.json")]),
                           str(tmp_path / "none"))["hidden_size"] == 48
    work = tmp_path / "work"
    work.mkdir()
    with open(work / "config.json", "w") as f:
        json.dump(dict(load_hparams("usr/popcs_fs2.yaml"), hidden_size=96), f)
    hp = run.load_config(run.parse_args(["--config", "usr/popcs_fs2.yaml"]), str(work))
    assert hp["hidden_size"] == 96


def test_loading_a_yaml_config_imports_no_yaml():
    """In an interpreter that refuses yaml (and the JAX package), the
    port's loader reads the PopCS configs with their cascades."""
    code = textwrap.dedent("""
        import importlib.abc, sys
        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("yaml", "jax", "bisinger_tpu"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Refuse())
        from bisinger_tpu_torch.config import load_hparams
        hp = load_hparams("configs/usr/popcs_ds_beta6_offline.yaml")
        assert hp["K_step"] == 51 and hp["hop_size"] == 128 and hp["max_tokens"] == 31250
        assert hp["mesh_shape"] == {"data": -1, "model": 1}
        assert hp["resblock_dilation_sizes"] == [[1, 3, 5], [1, 3, 5], [1, 3, 5]]
        assert "yaml" not in sys.modules
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
