"""ctypes reader of the native record codec (the port's counterpart of
`bisinger_tpu/native/__init__.py`, over its own copy of the C++ source,
`record_codec.cc`).

`NativeShardReader(prefix)` reads one `<prefix>.data/.idx` shard with the
mapping semantics of the Python decoder (`data/records.decode_record`): the
C++ side mmaps the data file and parses a record's fields in place; each
array is copied out of the mmap, so a record outlives the reader. The
library is compiled at first use by `ops/_build.load_host` (the host C++
compiler, `c++ -O3 -fPIC -std=c++17 -shared`, into the gitignored
`bisinger_tpu_torch/_build/`, under the kernels' file lock); a compiler that
fails raises with its output: there is no quiet return to the Python
decoder. `counter.records` counts the records decoded natively since the
last reset (`counter.records = 0`).
"""

from __future__ import annotations

import ctypes
import os
from typing import Any, Dict

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "record_codec.cc")
MAX_DIMS = 8
MAX_FIELDS = 64  # the format's cap, which `data/records.encode_record` enforces at write


class _RCField(ctypes.Structure):
    _fields_ = [
        # c_void_p, not c_char_p: a c_char_p reads up to a NUL, and the mmap'd
        # keys have none; string_at(key, key_len) reads exactly key_len bytes
        ("key", ctypes.c_void_p),
        ("key_len", ctypes.c_uint32),
        ("type", ctypes.c_uint8),
        ("dtype", ctypes.c_void_p),
        ("dtype_len", ctypes.c_uint32),
        ("ndim", ctypes.c_uint32),
        ("shape", ctypes.c_int64 * MAX_DIMS),
        ("data", ctypes.c_void_p),
        ("data_len", ctypes.c_uint64),
        ("ival", ctypes.c_int64),
        ("fval", ctypes.c_double),
    ]


SIGNATURES = {
    "rc_open": ([ctypes.c_char_p, ctypes.c_char_p], ctypes.c_void_p),
    "rc_close": ([ctypes.c_void_p], None),
    "rc_len": ([ctypes.c_void_p], ctypes.c_int64),
    "rc_parse": ([ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(_RCField), ctypes.c_int],
                 ctypes.c_int),
}


class DecodeCounter:
    """Records decoded natively since the last reset (`records = 0`)."""

    def __init__(self):
        self.records = 0


counter = DecodeCounter()


def load_library() -> ctypes.CDLL:
    """The codec's library, compiled at first use; raises RuntimeError with
    the compiler's output when it cannot be built."""
    from bisinger_tpu_torch.ops import _build

    return _build.load_host(SOURCE, SIGNATURES)


class NativeShardReader:
    """Random-access reader over one `<prefix>.data/.idx` shard."""

    def __init__(self, prefix: str):
        self._lib = load_library()
        self._h = self._lib.rc_open((prefix + ".data").encode(), (prefix + ".idx").encode())
        if not self._h:
            raise IOError(f"cannot open shard {prefix!r}")
        self._fields = (_RCField * MAX_FIELDS)()

    def __len__(self) -> int:
        return self._lib.rc_len(self._h)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        n = self._lib.rc_parse(self._h, idx, self._fields, MAX_FIELDS)
        if n < 0:
            raise IOError(f"corrupt record {idx}")
        out: Dict[str, Any] = {}
        for i in range(n):
            f = self._fields[i]
            key = ctypes.string_at(f.key, f.key_len).decode("utf-8")
            t = f.type
            if t == 0:  # array
                dt = np.dtype(ctypes.string_at(f.dtype, f.dtype_len).decode("ascii"))
                shape = tuple(f.shape[j] for j in range(f.ndim))
                buf = (ctypes.c_char * f.data_len).from_address(f.data)
                # a copy out of the mmap: a record outlives the parse
                out[key] = np.frombuffer(buf, dtype=dt).reshape(shape).copy()
            elif t == 1:
                out[key] = ctypes.string_at(f.data, f.data_len).decode("utf-8")
            elif t == 2:
                out[key] = int(f.ival)
            elif t == 3:
                out[key] = float(f.fval)
            elif t == 4:
                out[key] = ctypes.string_at(f.data, f.data_len)
            else:
                out[key] = None
        counter.records += 1
        return out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.rc_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def open_shard(prefix: str) -> NativeShardReader:
    return NativeShardReader(prefix)
