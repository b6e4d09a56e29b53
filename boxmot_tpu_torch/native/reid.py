"""The native (C++) ReID runtime: weight export and the ctypes backend
(counterpart of ``boxmot_tpu/native/reid.py``).

``native/cpp``'s hand-coded OSNet and LMBN (``src/reid_net.hpp``) compute
crops and embeddings on the host from ``manifest.txt`` + ``weights.bin``.
``export_native_reid`` writes those files from the port's model (or from
Flax variables) exactly as the JAX package writes them from its own: the
Flax tree (``reid/exporters.py::flax_variables``, HWIO kernels), batch
norms folded into ``a = scale / sqrt(var + eps)``, ``b = bias - mean * a``
in float64 with eps 1e-5, instance norms kept, tensors in sorted order.
``CppReID`` loads the library through the port's ``native.get_library()``,
which raises where it cannot be built; the JAX helper returns ``None``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from boxmot_tpu_torch.models.osnet import AIN_BLOCKS, OSNET_VARIANTS
from boxmot_tpu_torch.native import get_library

_BN_EPS = 1e-5
OS_BLOCKS = (("os", "os"), ("os", "os"), ("os", "os"))
LMBN_NAMES = ("lmbn_n", "lmbn_ain_n")
LMBN_CHANNELS = (64, 256, 384, 512)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def _header(model_name: str, crop_hw) -> list[str]:
    if model_name in LMBN_NAMES:
        return ["bmtnn 1", "arch lmbn", f"channels {','.join(map(str, LMBN_CHANNELS))}",
                "blocks 2,2,2",  # osnet x1_0 trunk layout (unused by lmbn fwd)
                "feature_dim 3584", f"ain {int(model_name == 'lmbn_ain_n')}", "conv1_in 0",
                "ibn 0", f"crop {crop_hw[0]} {crop_hw[1]}"]
    ain = model_name.startswith("osnet_ain")
    return ["bmtnn 1", "arch osnet",
            f"channels {','.join(map(str, OSNET_VARIANTS[model_name][0]))}", "blocks 2,2,2",
            "feature_dim 512",
            "block_types " + ";".join(",".join(b) for b in (AIN_BLOCKS if ain else OS_BLOCKS)),
            f"conv1_in {int(ain)}", f"ibn {int(model_name.startswith('osnet_ibn'))}",
            f"crop {crop_hw[0]} {crop_hw[1]}"]


def export_native_reid(model_name: str, model_or_variables, out_dir: Path | str,
                       crop_hw=(256, 128)) -> Path:
    """Write ``manifest.txt`` + ``weights.bin`` for the C++ runtime from the
    port's ``model`` of ``model_name`` (or Flax ``{"params", "batch_stats"}``
    of numpy arrays).  The OSNet family and LMBN (lmbn_n, lmbn_ain_n) are
    supported; any other name raises."""
    if model_name not in OSNET_VARIANTS and model_name not in LMBN_NAMES:
        raise ValueError("native ReID export supports the OSNet and LMBN families, "
                         f"not {model_name!r}")
    variables = model_or_variables
    if isinstance(variables, torch.nn.Module):
        from boxmot_tpu_torch.reid.exporters import flax_variables  # noqa: PLC0415

        variables = flax_variables(variables, model_name)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    params = _flatten(variables.get("params", {}))
    stats = _flatten(variables.get("batch_stats", {}))

    tensors: dict[str, np.ndarray] = {}
    bn_prefixes = {name[:-len("/mean")] for name in stats if name.endswith("/mean")}
    for prefix in bn_prefixes:
        mean = stats[f"{prefix}/mean"].astype(np.float64)
        var = stats[f"{prefix}/var"].astype(np.float64)
        # BNNeck batch norms have no bias (0)
        scale = params.get(f"{prefix}/scale", np.ones_like(mean)).astype(np.float64)
        bias = params.get(f"{prefix}/bias", np.zeros_like(mean)).astype(np.float64)
        a = scale / np.sqrt(var + _BN_EPS)
        tensors[f"{prefix}/a"] = a.astype(np.float32)
        tensors[f"{prefix}/b"] = (bias - mean * a).astype(np.float32)
    for name, arr in params.items():
        prefix, _, leaf = name.rpartition("/")
        if prefix in bn_prefixes and leaf in ("scale", "bias"):
            continue  # folded above
        tensors[name] = arr.astype(np.float32)

    blob = bytearray()
    lines = _header(model_name, crop_hw)
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name], np.float32)
        offset = len(blob) // 4
        blob.extend(arr.tobytes())
        shape = ",".join(map(str, arr.shape)) if arr.ndim else "1"
        lines.append(f"tensor {name} {shape} {offset}")
    (out_dir / "weights.bin").write_bytes(bytes(blob))
    (out_dir / "manifest.txt").write_text("\n".join(lines) + "\n")
    return out_dir / "manifest.txt"


_BOUND = set()


def _bind(lib) -> None:
    if id(lib) in _BOUND:
        return
    lib.bmt_reid_create.restype = ctypes.c_void_p
    lib.bmt_reid_create.argtypes = [ctypes.c_char_p]
    lib.bmt_reid_destroy.argtypes = [ctypes.c_void_p]
    lib.bmt_reid_feature_dim.argtypes = [ctypes.c_void_p]
    lib.bmt_reid_compute.restype = ctypes.c_int
    lib.bmt_reid_compute.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    lib.bmt_reid_last_error.restype = ctypes.c_char_p
    _BOUND.add(id(lib))


class CppReID:
    """ctypes ReID backend with the reference ``get_features`` contract: (N,
    4) xyxy boxes and a (H, W, 3) uint8 BGR frame -> (N, F) L2-normalized
    float32 embeddings, on the host."""

    def __init__(self, manifest: Path | str):
        lib = get_library()
        _bind(lib)
        self._lib = lib
        self._handle = lib.bmt_reid_create(str(manifest).encode())
        if not self._handle:
            raise RuntimeError(lib.bmt_reid_last_error().decode())
        self.feature_dim = lib.bmt_reid_feature_dim(self._handle)
        self.model_name = "osnet(native)"

    def get_features(self, xyxys: np.ndarray, img: np.ndarray) -> np.ndarray:
        xyxys = np.ascontiguousarray(np.asarray(xyxys, np.float32)[:, :4])
        n = len(xyxys)
        if n == 0:
            return np.zeros((0, self.feature_dim), np.float32)
        img = np.ascontiguousarray(img, np.uint8)
        out = np.empty((n, self.feature_dim), np.float32)
        rc = self._lib.bmt_reid_compute(
            self._handle, img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), img.shape[0],
            img.shape[1], xyxys.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise RuntimeError(self._lib.bmt_reid_last_error().decode())
        return out

    def __call__(self, xyxys, img):
        return self.get_features(xyxys, img)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.bmt_reid_destroy(handle)
            self._handle = None
