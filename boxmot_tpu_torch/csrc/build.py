"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use into ``build/torch_kernels/`` at the root of the checkout (a
directory ``.gitignore`` lists) as ``<name>-<hash>.so``, keyed by a hash of
the source and the flags, then loaded with ``ctypes``.  Nothing is built
when a module is imported, so the CPU tests import every module without
``nvcc``.  A failed build raises with nvcc's output.

Building and loading are safe across threads (the tuner runs trials in a
thread pool): each kernel has a lock around its build and load, so one
thread compiles it while the others wait for the library, and each thread's
temporary output has a name of its own.  ``count_launch`` adds to a
wrapper's launch counter under a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_SUBDIR = Path("build", "torch_kernels")  # under the root of the checkout
BUILD_DIR = CSRC.parents[1] / BUILD_SUBDIR
# -fmad=false: contracting `1 - iou*conf` (or any a*b + c) into an FMA
# changes the last bit, and the kernels must equal their plain twins.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCKS: dict[str, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()
_COUNT_LOCK = threading.Lock()
# nvcc/ptxas output and build seconds of the kernels built in this process
BUILD_LOG: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _lock(name: str) -> threading.Lock:
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(name, threading.Lock())


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the hashed library exists."""
    out = library_path(name)
    if out.exists():
        return out
    with _lock(name):
        return out if out.exists() else _compile(name, out)


def _compile(name: str, out: Path) -> Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # unique to the process and the thread: another process may build the
    # same kernel into the same directory
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    BUILD_LOG[name] = (seconds, proc.stdout + proc.stderr)
    return out


def entry(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, built and loaded
    on first use, with its ``argtypes`` declared and an int return.

    Every library also exports ``bmt_cuda_error_string(int)``, which
    ``check_launch`` reads.
    """
    lib = _LOADED.get(name)
    if lib is not None and getattr(lib, symbol).argtypes is not None:
        return getattr(lib, symbol)
    path = build(name)
    with _lock(name):
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            lib.bmt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.bmt_cuda_error_string.restype = ctypes.c_char_p
            _LOADED[name] = lib
        fn = getattr(lib, symbol)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
    return fn


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``; a plain ``+= 1`` is not atomic across
    threads."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def check_launch(name: str, symbol: str, rc: int) -> None:
    """Raise for a non-zero cudaError_t returned by a kernel's C entry point."""
    if rc != 0:
        msg = _LOADED[name].bmt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{symbol}: CUDA launch failed: cudaError_t {rc} ({msg})")
