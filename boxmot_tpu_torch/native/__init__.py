"""The native C++ tracker cores of the repo's ``native/cpp``, loaded with
ctypes (counterpart of ``boxmot_tpu/native/__init__.py``).

Both packages share one build: the library is built with cmake into
``native/cpp/build/`` under the same cross-process ``fcntl`` lock as the
JAX package's, and rebuilt when a source is newer than it.  The port links
it with ``--exclude-libs,ALL``, so that a static libstdc++ (which a
compiler named by ``CXX`` may link in) stays private to the library.  The cores are
host code in both packages.  Where the JAX helper returns ``None`` on a
failed build and leaves its callers to fall back, the port raises with
cmake's output: a ``:cpp`` tracker never falls back to the device tracker.
Setting ``BOXMOT_TPU_NO_NATIVE`` disables the library in both packages.

The JAX module's cache IO, frame packing, MOT writing and JV helpers are not
here: the port's cache IO is the numpy path the JAX package falls back to.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parents[2]
_CPP_DIR = _REPO_ROOT / "native" / "cpp"
_BUILD_DIR = _CPP_DIR / "build"
_LIB = None
_LOCK = threading.Lock()


def _sources_mtime() -> float:
    """Newest mtime across the C++ sources (stale-build detection)."""
    newest = 0.0
    for pattern in ("src/*.cpp", "src/*.hpp", "CMakeLists.txt"):
        for p in _CPP_DIR.glob(pattern):
            newest = max(newest, p.stat().st_mtime)
    return newest


def _fresh(lib: Path) -> bool:
    return lib.exists() and lib.stat().st_mtime >= _sources_mtime()


def _build_library() -> Path:
    lib = _BUILD_DIR / "libboxmot_native.so"
    if _fresh(lib):
        return lib
    if not (_CPP_DIR / "CMakeLists.txt").exists():
        raise RuntimeError(f"the native sources are not in this checkout ({_CPP_DIR})")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # cross-process build lock
        if _fresh(lib):
            return lib
        # --exclude-libs: a compiler that links libstdc++ statically (the card
        # machine's CXX does) would otherwise export its copy's symbols, which
        # the process's own libstdc++ (torch's) interposes: the ReID
        # runtime's iostreams then crash in its constructor
        for cmd in (["cmake", "-S", str(_CPP_DIR), "-B", str(_BUILD_DIR),
                     "-DCMAKE_SHARED_LINKER_FLAGS=-Wl,--exclude-libs,ALL"],
                    ["cmake", "--build", str(_BUILD_DIR), "--config", "Release", "-j"]):
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError as exc:
                raise RuntimeError(f"building the native library needs cmake: {exc}") from None
            if proc.returncode != 0:
                raise RuntimeError(f"building the native library failed (exit "
                                   f"{proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
    if not lib.exists():
        raise RuntimeError(f"cmake finished without building {lib}")
    return lib


def get_library():
    """The native library, built on first use; raises where it cannot be
    built or loaded, or is disabled."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            if os.environ.get("BOXMOT_TPU_NO_NATIVE"):
                raise RuntimeError("the native library is disabled (BOXMOT_TPU_NO_NATIVE is set)")
            lib = ctypes.CDLL(str(_build_library()))
            lib.bmt_version.restype = ctypes.c_char_p
            lib.bmt_last_error.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB
