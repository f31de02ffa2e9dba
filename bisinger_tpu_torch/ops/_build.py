"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers) and is
compiled on its own into `bisinger_tpu_torch/_build/lib<name>_<hash>.so`
(the bf16 sources include `csrc/mma_bf16.cuh`, the fp32 ones
`csrc/mma_tf32.cuh`):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o ... csrc/<name>.cu

The file name carries a hash of the source, the headers of `csrc/` and
the flags, so an edited source or header builds anew and an unchanged one
is loaded as it is. `build_all` starts one nvcc per source at once and
waits for all of them; it prints each build's time and the `-Xptxas -v`
lines (registers, shared memory, spills) once. Builds and loads hold a
lock (a thread lock and a file lock on `_build/.lock`), so threads or
processes that reach a kernel first together build it once. Nothing here
runs at import.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Dict, Iterable

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_P, _I = ctypes.c_void_p, ctypes.c_int
# each library's C entry points: name -> (argtypes, restype); every pointer,
# host arrays and the stream included, is a c_void_p
SIGNATURES = {
    "diffnet_stack": {"diffnet_residual_stack": ([_P] * 10 + [_I] * 5 + [_P], _I)},
    "mrf_stage": {"mrf_stage": ([_P] * 4 + [_I] * 5 + [_P] * 2 + [_I, _P], _I)},
    "diffnet_stack_bf16": {"diffnet_residual_stack_bf16": ([_P] * 10 + [_I] * 5 + [_P], _I)},
    "mrf_stage_bf16": {"mrf_stage_bf16": ([_P] * 4 + [_I] * 5 + [_P] * 2 + [_I, _P], _I)},
}
KERNELS = tuple(SIGNATURES)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


@contextlib.contextmanager
def _locked():
    """This process's threads one at a time, and then other processes too."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fn in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build_all(names: Iterable[str] = KERNELS, log=None) -> Dict[str, float]:
    """Compile every listed kernel whose library is missing, one nvcc per
    source, all started together. Returns {name: seconds} of the builds
    that ran; raises with nvcc's output if any fails."""
    with _locked():
        return _build(names, log)


def _build(names: Iterable[str], log=None) -> Dict[str, float]:
    """`build_all` for a caller that holds the lock."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    todo = [n for n in names if not os.path.exists(library_path(n))]
    procs = {}
    nvcc = nvcc_path() if todo else None
    for name in todo:
        out = library_path(name)
        cmd = [nvcc, *NVCC_FLAGS, "-o", out + ".tmp", os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for name, (t0, proc) in procs.items():
        text, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{text}")
            continue
        os.replace(library_path(name) + ".tmp", library_path(name))
        lines = [ln.strip() for ln in text.splitlines()
                 if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
        log(f"[build] {name}.cu in {seconds[name]:.1f} s")
        for ln in lines:
            log(f"[build]   {ln}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when grad mode is on and an input requires grad: the kernels
    have no backward, and their output would silently cut the graph (on the
    CPU their plain versions would differentiate, but round as the TPU
    kernel does, not as a training step). Training runs the layers' plain
    autograd path instead, as the JAX package trains through flax's
    layers."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an input requires grad, and the kernel has no backward; "
                           "call it under torch.no_grad() (training takes the layers' "
                           "autograd path)")


class LaunchCounter:
    """Launches of one kernel since the last reset (`launches = 0`), and
    the input shape of every launch since import (`shapes`, never reset)."""

    def __init__(self):
        self.launches = 0
        self.shapes = set()

    def add(self, shape) -> None:
        self.launches += 1
        self.shapes.add(tuple(shape))


def load(name: str) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu`, built at first use, with the
    argument and result types of its entry points set."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _locked():
        lib = _loaded.get(name)
        if lib is None:
            _build([name])
            lib = ctypes.CDLL(library_path(name))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
            lib.kernel_error_string.argtypes = [_I]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
    return lib


def int_array(values) -> "ctypes.Array":
    return (ctypes.c_int * len(values))(*[int(v) for v in values])


def check(err: int, what: str, lib: ctypes.CDLL) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} {lib.kernel_error_string(err).decode()}")
