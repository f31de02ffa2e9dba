"""Binary feature-record shards: the binarizer's on-disk format (the port's
copy of `bisinger_tpu/data/records.py`; the same `BTR1` bytes, so a shard
written by either package reads in the other). `RecordReader` decodes
through the port's native codec (`native/`, C++ built at first use) or in
Python (`backend="python"`).

Replaces the reference `IndexedDataset` (pickle + offset table,
`train_bisinger/utils/indexed_datasets.py:7-54`) with a schema-aware,
pickle-free binary codec:

  - `<prefix>.data`: concatenated records; each record is a sequence of
    (key, payload) fields with an explicit type tag — numpy arrays carry
    dtype + shape and their bytes are stored raw (zero-copy mmap reads),
    scalars/strings are length-prefixed UTF-8/struct;
  - `<prefix>.idx`: uint64 offsets (+ trailing end offset), numpy `.npy`.

Random access is O(1) via the offset table over a single mmap; no pickle
means records are safe to read from untrusted dirs and fast to decode.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterator, List

import numpy as np

_MAGIC = b"BTR1"
_T_ARRAY = 0
_T_STR = 1
_T_INT = 2
_T_FLOAT = 3
_T_BYTES = 4
_T_NONE = 5


def _encode_field(key: str, value: Any) -> bytes:
    kb = key.encode("utf-8")
    head = struct.pack("<H", len(kb)) + kb
    if isinstance(value, np.ndarray):
        dt = np.dtype(value.dtype).str.encode("ascii")
        shape = value.shape
        meta = struct.pack("<BH", _T_ARRAY, len(dt)) + dt
        meta += struct.pack("<B", len(shape)) + struct.pack(f"<{len(shape)}q", *shape)
        payload = np.ascontiguousarray(value).tobytes()
        return head + meta + struct.pack("<Q", len(payload)) + payload
    if isinstance(value, str):
        vb = value.encode("utf-8")
        return head + struct.pack("<B", _T_STR) + struct.pack("<Q", len(vb)) + vb
    if isinstance(value, (bool, np.bool_)):
        return head + struct.pack("<B", _T_INT) + struct.pack("<q", int(value))
    if isinstance(value, (int, np.integer)):
        return head + struct.pack("<B", _T_INT) + struct.pack("<q", int(value))
    if isinstance(value, (float, np.floating)):
        return head + struct.pack("<B", _T_FLOAT) + struct.pack("<d", float(value))
    if isinstance(value, bytes):
        return head + struct.pack("<B", _T_BYTES) + struct.pack("<Q", len(value)) + value
    if value is None:
        return head + struct.pack("<B", _T_NONE)
    raise TypeError(f"unsupported record field type for {key!r}: {type(value)}")


def encode_record(item: Dict[str, Any]) -> bytes:
    if len(item) > 64:
        # hard format limit shared with the native readers (the port's
        # `native/record_codec.cc` and the JAX package's, max_fields=64):
        # enforced at write, or a native reader would open the shard and
        # then raise on every record the Python decoder reads
        raise ValueError(
            f"record has {len(item)} fields; the shard format caps at 64"
        )
    body = b"".join(_encode_field(k, v) for k, v in item.items())
    return _MAGIC + struct.pack("<I", len(item)) + body


def decode_record(buf: memoryview, offset: int = 0) -> Dict[str, Any]:
    if bytes(buf[offset : offset + 4]) != _MAGIC:
        raise ValueError(f"corrupt record at offset {offset}: no {_MAGIC!r} magic")
    (n_fields,) = struct.unpack_from("<I", buf, offset + 4)
    pos = offset + 8
    out: Dict[str, Any] = {}
    for _ in range(n_fields):
        (klen,) = struct.unpack_from("<H", buf, pos)
        pos += 2
        key = bytes(buf[pos : pos + klen]).decode("utf-8")
        pos += klen
        (tag,) = struct.unpack_from("<B", buf, pos)
        pos += 1
        if tag == _T_ARRAY:
            (dtlen,) = struct.unpack_from("<H", buf, pos)
            pos += 2
            dt = np.dtype(bytes(buf[pos : pos + dtlen]).decode("ascii"))
            pos += dtlen
            (ndim,) = struct.unpack_from("<B", buf, pos)
            pos += 1
            shape = struct.unpack_from(f"<{ndim}q", buf, pos)
            pos += 8 * ndim
            (nbytes,) = struct.unpack_from("<Q", buf, pos)
            pos += 8
            arr = np.frombuffer(buf, dtype=dt, count=int(np.prod(shape)) if ndim else 1, offset=pos)
            out[key] = arr.reshape(shape).copy() if ndim else arr.reshape(()).copy()
            pos += nbytes
        elif tag == _T_STR:
            (n,) = struct.unpack_from("<Q", buf, pos)
            pos += 8
            out[key] = bytes(buf[pos : pos + n]).decode("utf-8")
            pos += n
        elif tag == _T_INT:
            (v,) = struct.unpack_from("<q", buf, pos)
            pos += 8
            out[key] = v
        elif tag == _T_FLOAT:
            (v,) = struct.unpack_from("<d", buf, pos)
            pos += 8
            out[key] = v
        elif tag == _T_BYTES:
            (n,) = struct.unpack_from("<Q", buf, pos)
            pos += 8
            out[key] = bytes(buf[pos : pos + n])
            pos += n
        elif tag == _T_NONE:
            out[key] = None
        else:
            raise ValueError(f"unknown field tag {tag}")
    return out


class RecordWriter:
    """Append-only shard writer (`IndexedDatasetBuilder` counterpart)."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        self._f = open(prefix + ".data", "wb")
        self._offsets: List[int] = [0]

    def add_item(self, item: Dict[str, Any]):
        blob = encode_record(item)
        self._f.write(blob)
        self._offsets.append(self._offsets[-1] + len(blob))

    def finalize(self):
        self._f.close()
        # np.save would append '.npy' to a bare path; write via the handle
        with open(self.prefix + ".idx", "wb") as f:
            np.save(f, np.asarray(self._offsets, dtype=np.uint64))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finalize()

    def __len__(self):
        return len(self._offsets) - 1


BACKENDS = ("auto", "native", "python")


class RecordReader:
    """mmap-backed random-access shard reader (`IndexedDataset`
    counterpart). `backend`, JAX's three values: "auto" and "native" decode
    through the native codec (`native.NativeShardReader`), "python" through
    `decode_record`. A departure from JAX: "auto" is the native codec, and a
    codec that cannot be built or loaded raises (with the compiler's
    output), where JAX's "auto" quietly decodes in Python (ROADMAP Queue 3).
    Both return the same dict, arrays copied."""

    def __init__(self, prefix: str, backend: str = "auto"):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {', '.join(BACKENDS)}")
        self.prefix = prefix
        self.backend = "python" if backend == "python" else "native"
        self._offsets = np.load(prefix + ".idx")
        self._native = None
        if self.backend == "native":
            from bisinger_tpu_torch.native import NativeShardReader

            self._native = NativeShardReader(prefix)
            return
        if os.path.getsize(prefix + ".data") == 0:
            # valid empty shard (e.g. a split with no items):
            # np.memmap refuses zero-length files
            self._data = np.zeros(0, np.uint8)
        else:
            self._data = np.memmap(prefix + ".data", dtype=np.uint8, mode="r")
        self._view = memoryview(self._data)

    def __len__(self) -> int:
        return len(self._offsets) - 1

    def __getitem__(self, i: int) -> Dict[str, Any]:
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        if self._native is not None:
            return self._native[i]
        return decode_record(self._view, int(self._offsets[i]))

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for i in range(len(self)):
            yield self[i]
