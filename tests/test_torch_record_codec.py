"""The port's native record codec (`bisinger_tpu_torch/native/`, its own copy
of `record_codec.cc`, built at first use with the host C++ compiler) against
its Python decoder and JAX's `decode_record`, on shards written by JAX's
`RecordWriter` and by the port's, with every field type; and the cases of
tests/test_native_codec.py: a corrupt record raises IOError, an empty shard
opens, the field cap holds at write, an oversized length is rejected. The
port's "auto" is the native codec and raises when it cannot be built (a
departure from JAX, which decodes in Python then)."""

import struct

import numpy as np
import pytest

from bisinger_tpu.data.records import RecordWriter as JRecordWriter
from bisinger_tpu.data.records import decode_record as j_decode
from bisinger_tpu_torch import native
from bisinger_tpu_torch.data import records
from bisinger_tpu_torch.data.records import RecordReader, RecordWriter, encode_record
from bisinger_tpu_torch.ops import _build


def _items(n=12, seed=0):
    """Every field type: arrays of several dtypes and ranks (0-d and empty
    among them), str, int, bool, float, bytes, None."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append({
            "item_name": f"it{i:03d}-歌",
            "mel": r.standard_normal((20 + i, 80)).astype(np.float32),
            "phone": r.integers(0, 60, size=5 + i).astype(np.int64),
            "f0": r.random(20 + i).astype(np.float64),
            "uv": r.random(20 + i) > 0.5,
            "mel2ph": r.integers(0, 255, size=(2, 3, 4)).astype(np.uint8),
            "half": r.standard_normal(7).astype(np.float16),
            "scalar": np.array(0.25 * i, np.float32),
            "empty": np.zeros((0, 80), np.float32),
            "spk_id": int(i % 4),
            "flag": bool(i % 2),
            "loudness": float(i) * 0.5,
            "maybe": None,
            "raw": b"\x00\x01bytes" * i,
        })
    return out


def _equal(a, b):
    assert list(a) == list(b)
    for k, v in b.items():
        got = a[k]
        if isinstance(v, np.ndarray):
            assert isinstance(got, np.ndarray) and got.dtype == v.dtype, k
            assert got.shape == v.shape, k
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            assert type(got) is type(v) and got == v, (k, got, v)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("codec")
    items = _items()
    for name, writer in (("jax", JRecordWriter), ("port", RecordWriter)):
        with writer(str(root / name)) as w:
            for it in items:
                w.add_item(it)
    return root, items


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_native_equals_python_and_jax_decoders(shards, writer):
    """Every record of a shard from either writer: the native reader, the
    port's Python decoder and JAX's decode_record give the same dict, array
    by array with dtype and shape (bools read back as ints, as both
    decoders give them)."""
    root, items = shards
    prefix = str(root / writer)
    nat, py = RecordReader(prefix), RecordReader(prefix, backend="python")
    assert nat.backend == "native" and py.backend == "python"
    assert len(nat) == len(py) == len(items)
    offsets = np.load(prefix + ".idx")
    view = memoryview(np.fromfile(prefix + ".data", np.uint8))
    native.counter.records = 0
    for i in range(len(items)):
        want, got = j_decode(view, int(offsets[i])), nat[i]
        _equal(got, want)
        _equal(py[i], want)
        assert got["flag"] == int(items[i]["flag"])
        np.testing.assert_array_equal(got["mel"], items[i]["mel"])
    assert native.counter.records == len(items)
    assert [r["item_name"] for r in nat] == [it["item_name"] for it in items]


def test_corrupt_record_raises_ioerror(tmp_path):
    prefix = str(tmp_path / "bad")
    with RecordWriter(prefix) as w:
        w.add_item({"x": 1})
    with open(prefix + ".data", "r+b") as f:
        f.write(b"XXXX")  # the magic
    with pytest.raises(IOError):
        RecordReader(prefix, backend="native")[0]


@pytest.mark.parametrize("backend", ["auto", "python"])
def test_empty_shard_opens(tmp_path, backend):
    prefix = str(tmp_path / "empty")
    with RecordWriter(prefix):
        pass
    r = RecordReader(prefix, backend=backend)
    assert len(r) == 0 and list(r) == []


def test_field_cap_enforced_at_write():
    assert native.MAX_FIELDS == 64
    encode_record({f"k{i}": i for i in range(64)})
    with pytest.raises(ValueError, match="64"):
        encode_record({f"k{i}": i for i in range(65)})


def test_oversized_length_rejected(tmp_path):
    """A near-2^64 array length fails the bounds check (IOError), and so
    does a string length past the record's end."""
    for value, n in ((np.zeros(4, np.float32), 16), ("abcd", 4)):
        prefix = str(tmp_path / f"bad{n}")
        with RecordWriter(prefix) as w:
            w.add_item({"x": value})
        data = bytearray(open(prefix + ".data", "rb").read())
        pos = data.find(struct.pack("<Q", n))
        assert pos > 0
        data[pos:pos + 8] = struct.pack("<Q", 2 ** 64 - 8)
        open(prefix + ".data", "wb").write(bytes(data))
        with pytest.raises(IOError):
            RecordReader(prefix, backend="native")[0]


@pytest.mark.parametrize("backend", ["native", "auto"])
def test_a_codec_that_cannot_be_built_raises(shards, tmp_path, monkeypatch, backend):
    """With the compiler setting at a missing binary, "native" and "auto"
    raise naming the compiler, and nothing is decoded in Python."""
    root, _ = shards
    monkeypatch.setattr(_build, "CXX", str(tmp_path / "no-such-c++"))
    monkeypatch.setattr(records, "decode_record", lambda *a, **k: pytest.fail("decoded"))
    with pytest.raises(RuntimeError, match="no-such-c\\+\\+"):
        RecordReader(str(root / "port"), backend=backend)
    with pytest.raises(ValueError, match="backend"):
        RecordReader(str(root / "port"), backend="mmap")
