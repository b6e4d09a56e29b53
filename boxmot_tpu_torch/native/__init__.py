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

The JAX module's helpers over the same library are here with its
signatures: ``read_npy``, ``write_npy`` and ``append_npy`` (float32 2-D
``.npy`` files), ``pack_frames_native`` (ragged rows into padded frames),
``write_mot_native`` (MOT rows) and ``lapjv_native`` (the JV solver with
lapjv's cost limit).  Where the library cannot be built they raise, as
``get_library`` does, instead of returning ``None`` or writing with numpy;
``native_available`` says whether it can be.  ``lapjv_native`` returns
``None`` where the solver reports an error, as in JAX.  The port's cache IO
is the numpy path the JAX package falls back to.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

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
            _host_helper_types(lib)
            _LIB = lib
        return _LIB


def _host_helper_types(lib) -> None:
    """The argument types of the cache-IO, packing, MOT and JV entry points
    (``boxmot_tpu/native/__init__.py::get_library``)."""
    f32p, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
    lib.bmt_read_npy_f32.argtypes = [ctypes.c_char_p, ctypes.POINTER(f32p),
                                     ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.bmt_write_npy_f32.argtypes = [ctypes.c_char_p, f32p, i64, i64]
    lib.bmt_append_npy_f32.argtypes = lib.bmt_write_npy_f32.argtypes
    lib.bmt_pack_frames_f32.argtypes = [f32p, i64, i64, i64, i64, ctypes.c_int, f32p]
    lib.bmt_write_mot.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), i64]
    lib.bmt_lapjv.argtypes = [ctypes.POINTER(ctypes.c_double), i64, i64, ctypes.c_double,
                              ctypes.POINTER(ctypes.c_int32)]
    lib.bmt_free.argtypes, lib.bmt_free.restype = [ctypes.c_void_p], None


def native_available() -> bool:
    """Whether the native library can be built and loaded here."""
    try:
        get_library()
    except RuntimeError:
        return False
    return True


def _f32p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_npy(path) -> np.ndarray:
    """A float32 2-D ``.npy`` file, read by the library."""
    lib = get_library()
    data = ctypes.POINTER(ctypes.c_float)()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.bmt_read_npy_f32(str(path).encode(), ctypes.byref(data), ctypes.byref(rows),
                              ctypes.byref(cols))
    if rc != 0:
        raise IOError(lib.bmt_last_error().decode())
    try:
        return np.ctypeslib.as_array(data, shape=(rows.value, cols.value)).copy()
    finally:
        lib.bmt_free(data)


def _write(fn, path, arr: np.ndarray) -> None:
    lib = get_library()
    arr = np.ascontiguousarray(arr, np.float32)
    rc = getattr(lib, fn)(str(path).encode(), _f32p(arr), arr.shape[0], arr.shape[1])
    if rc != 0:
        raise IOError(lib.bmt_last_error().decode())


def write_npy(path, arr: np.ndarray) -> None:
    """Write (N, C) ``arr`` as a float32 ``.npy`` file."""
    _write("bmt_write_npy_f32", path, arr)


def append_npy(path, arr: np.ndarray) -> None:
    """Append the rows of (N, C) ``arr`` to a float32 ``.npy`` file."""
    _write("bmt_append_npy_f32", path, arr)


def pack_frames_native(rows: np.ndarray, n_frames: int, max_dets: int, box_cols: int = 4):
    """(N, 1+box+2) [frame, box..., conf, cls] rows -> (F, D, box+3) padded."""
    lib = get_library()
    rows = np.ascontiguousarray(rows, np.float32)
    out = np.empty((n_frames, max_dets, box_cols + 3), np.float32)
    rc = lib.bmt_pack_frames_f32(_f32p(rows), rows.shape[0], rows.shape[1], n_frames, max_dets,
                                 box_cols, _f32p(out))
    if rc != 0:
        raise ValueError(lib.bmt_last_error().decode())
    return out


def write_mot_native(path, rows: np.ndarray) -> bool:
    """Write (N, 9) MOT rows to ``path``; True, as JAX's where it wrote."""
    lib = get_library()
    rows = np.ascontiguousarray(rows, np.float64).reshape(-1, 9)
    rc = lib.bmt_write_mot(str(path).encode(), rows.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                           rows.shape[0])
    if rc != 0:
        raise IOError(lib.bmt_last_error().decode())
    return True


def lapjv_native(cost: np.ndarray, limit: float) -> np.ndarray | None:
    """Exact JV assignment with cost-limit semantics (bmt_lapjv): r2c (n,)
    int32 with -1 for unassigned, or None where the solver reports an
    error."""
    lib = get_library()
    cost = np.ascontiguousarray(cost, np.float64)
    n, m = cost.shape
    r2c = np.full(n, -1, np.int32)
    if n == 0:
        return r2c
    rc = lib.bmt_lapjv(cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, m, float(limit),
                       r2c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return None if rc != 0 else r2c
