"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers) and is
templated on the width it computes (K1's residual channels C, K2's stage
channels F). It is compiled once per width listed in `WIDTHS`, the one
list of the instantiations, into
`bisinger_tpu_torch/_build/lib<name>_w<width>_<hash>.so` (the bf16
sources include `csrc/mma_bf16.cuh`, the fp32 ones `csrc/mma_tf32.cuh`):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -DKERNEL_WIDTH=<width> -o ... csrc/<name>.cu

The file name carries a hash of the source, the headers of `csrc/`, the
flags and the width, so an edited source or header builds anew and an
unchanged one is loaded as it is. A run loads only the widths its models
have (the flagship's: K1 at 256, K2 at 256, 128, 64 and 32). `build_all`
starts one nvcc per library, all at once (with `nice`, for a build in the
background of other work: at a lower priority, at most one per CPU core)
and waits for all of them; it prints each build's time and the `-Xptxas -v`
lines (registers, shared memory, spills) once. Builds hold a lock (a
thread lock and a file lock on `_build/.lock`), so threads or processes
that reach a kernel first together build it once; a library that exists
loads without the file lock (a build renames its file into place whole),
so a build of other widths in the background holds up no load. Nothing
here runs at import.

Host libraries (the record codec, `native/record_codec.cc`) take the same
directory and hashing, and a lock of their own, through `load_host`: the
host C++ compiler `CXX` (default `c++`, the environment's CXX if set) with
`CXX_FLAGS`, the file name keyed by a hash of the source, the compiler and
the flags; a compiler that fails or cannot run raises with its output.
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
    "diffnet_stack": {"diffnet_residual_stack": ([_P] * 10 + [_I] * 6 + [_P], _I)},
    "mrf_stage": {"mrf_stage": ([_P] * 4 + [_I] * 5 + [_P] * 2 + [_I, _P], _I)},
    "diffnet_stack_bf16": {"diffnet_residual_stack_bf16": ([_P] * 11 + [_I] * 6 + [_P], _I)},
    "mrf_stage_bf16": {"mrf_stage_bf16": ([_P] * 4 + [_I] * 5 + [_P] * 2 + [_I, _P], _I)},
}
KERNELS = tuple(SIGNATURES)
# The widths each kernel is instantiated for, one library a width: K1 (both
# routes) every residual channel count C that is a multiple of 32 from 32
# to 512, K2 (both routes) the stage channels F of a HiFi-GAN whose
# upsample_initial_channel is a power of two from 16 to 1024. The wrappers
# take these widths and raise on any other.
K1_WIDTHS = tuple(range(32, 513, 32))
K2_WIDTHS = (8, 16, 32, 64, 128, 256, 512)
WIDTHS = {"diffnet_stack": K1_WIDTHS, "diffnet_stack_bf16": K1_WIDTHS,
          "mrf_stage": K2_WIDTHS, "mrf_stage_bf16": K2_WIDTHS}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

CXX = os.environ.get("CXX") or "c++"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()  # kernel builds (with the file lock `.lock`)
_host_lock = threading.Lock()  # host builds (with `.host.lock`)
_loaded_lock = threading.Lock()  # _loaded


@contextlib.contextmanager
def _locked(thread_lock=_lock, name: str = ".lock"):
    """This process's threads one at a time, and then other processes too."""
    with thread_lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, name), "w") as f:
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


def library_path(name: str, width: int) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + [f"-DKERNEL_WIDTH={width}"]).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fn in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_w{width}_{digest}.so")


def targets(names: Iterable[str] = KERNELS, widths=None):
    """[(name, width)] of every listed kernel at each of `widths`: every
    width in `WIDTHS` (None), the same list for each name, or {name: list}."""
    out = []
    for name in names:
        if name not in WIDTHS:
            raise ValueError(f"no kernel source {name!r}: one of {KERNELS}")
        ws = widths.get(name, ()) if isinstance(widths, dict) else widths
        for w in (WIDTHS[name] if ws is None else ws):
            if w not in WIDTHS[name]:
                raise ValueError(f"{name} is built for widths {WIDTHS[name]}, not {w}")
            out.append((name, int(w)))
    return out


def build_all(names: Iterable[str] = KERNELS, widths=None, log=None,
              nice: int = 0) -> Dict[str, float]:
    """Compile every listed kernel at each of `widths` (default: all of its
    `WIDTHS`) whose library is missing, one nvcc a library, all at once;
    with `nice`, each that many steps below this process's priority and at
    most as many at once as there are CPU cores. Returns {"name@width": seconds} of the builds that ran;
    raises with nvcc's output if any fails."""
    with _locked():
        return _build(targets(names, widths), log, nice)


def _build(todo_all, log=None, nice: int = 0) -> Dict[str, float]:
    """`build_all` of [(name, width)] for a caller that holds the lock."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    todo = [t for t in todo_all if not os.path.exists(library_path(*t))]
    nvcc = nvcc_path() if todo else None
    seconds, failed, running = {}, [], []
    slots = max(1, os.cpu_count() or 1) if nice else max(1, len(todo))

    def finish(entry):
        (name, width), t0, proc = entry
        text, _ = proc.communicate()
        key = f"{name}@{width}"
        seconds[key] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu -DKERNEL_WIDTH={width} failed ({proc.returncode}):\n"
                          f"{text}")
            return
        os.replace(library_path(name, width) + ".tmp", library_path(name, width))
        lines = [ln.strip() for ln in text.splitlines()
                 if "Used" in ln or "spill" in ln or "Compiling entry" in ln
                 or "arning" in ln]
        log(f"[build] {name}.cu at width {width} in {seconds[key]:.1f} s")
        for ln in lines:
            log(f"[build]   {ln}")

    for name, width in todo:
        if len(running) >= slots:
            finish(running.pop(0))
        out = library_path(name, width)
        # lowered by the `nice` command, not in the child before exec: the
        # caller may have other threads running
        cmd = (["nice", "-n", str(nice)] if nice else []) + [
            nvcc, *NVCC_FLAGS, f"-DKERNEL_WIDTH={width}", "-o", out + ".tmp",
            os.path.join(CSRC, f"{name}.cu")]
        running.append(((name, width), time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for entry in running:
        finish(entry)
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


def check_width(name: str, width: int, what: str) -> None:
    """Raise ValueError, naming the widths taken, unless `name` is built for
    `width`."""
    if width not in WIDTHS[name]:
        raise ValueError(f"{what}: the kernel takes widths {', '.join(map(str, WIDTHS[name]))}, "
                         f"got {width}")


def load(name: str, width: int) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu` at `width`, built at first use, with
    the argument and result types of its entry points set."""
    key = f"{name}@{width}"
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    path = library_path(name, width)
    if not os.path.exists(path):
        with _locked():
            _build(targets([name], [width]))
    with _loaded_lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(path)
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
            lib.kernel_error_string.argtypes = [_I]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _loaded[key] = lib
    return lib


def host_library_path(source: str, compiler: str) -> str:
    """`_build/lib<stem>_<hash>.so` of a host C++ source: the hash of the
    compiler, the flags and the source."""
    h = hashlib.sha256(" ".join([compiler, *CXX_FLAGS]).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def load_host(source: str, signatures) -> ctypes.CDLL:
    """The host library of the C++ file `source`, compiled at first use with
    `CXX` and `CXX_FLAGS`, with `signatures` ({name: (argtypes, restype)})
    set. Raises RuntimeError, with the compiler's output, when the compiler
    fails or cannot run."""
    path = host_library_path(source, CXX)
    lib = _loaded.get(path)
    if lib is not None:
        return lib
    with _locked(_host_lock, ".host.lock"):  # not held up by a kernel build
        lib = _loaded.get(path)
        if lib is None:
            if not os.path.exists(path):
                cmd = [CXX, *CXX_FLAGS, "-o", path + ".tmp", source]
                try:
                    proc = subprocess.run(cmd, capture_output=True, text=True)
                except OSError as e:
                    raise RuntimeError(f"{' '.join(cmd)}: the compiler cannot run: {e}") from e
                if proc.returncode != 0:
                    raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(path + ".tmp", path)
            lib = ctypes.CDLL(path)
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
            _loaded[path] = lib
    return lib


def int_array(values) -> "ctypes.Array":
    return (ctypes.c_int * len(values))(*[int(v) for v in values])


def check(err: int, what: str, lib: ctypes.CDLL) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} {lib.kernel_error_string(err).decode()}")
