"""Runtime backends for exported ReID artifacts and the suffix dispatch
(counterpart of ``boxmot_tpu/reid/backends.py``).

- a model name, a torchreid ``.pt`` / ``.pth`` or a Flax ``.msgpack``
  checkpoint -> the port's ``ReID`` on ``device``;
- ``.tflite``                  -> ``TFLiteReID`` (the TFLite interpreter);
- a SavedModel directory       -> ``SavedModelReID`` (TensorFlow);
- ``manifest.txt`` (or its directory) -> ``native.reid.CppReID``, the C++
  OSNet / LMBN runtime on the host.

The TensorFlow backends cut their crops with the port's ``extract_crops``
on ``device`` (kernel K5 on the card, one launch a chunk of 256 crops),
read them back once a call as NHWC float32 and run the interpreter on the
host, so their embeddings are the device path's crops through another
runtime: L2-normalized float32, interchangeable with ``ReID``'s.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from boxmot_tpu_torch.ops.crops import as_frame, extract_crops
from boxmot_tpu_torch.reid.core import CHUNK, ReID
from boxmot_tpu_torch.utils.device import resolve_device


def _crops_np(xyxys: np.ndarray, img, crop_hw, device) -> np.ndarray:
    """Standardized (N, H, W, 3) float32 RGB crops of a BGR frame, cut on
    ``device`` and read back once."""
    boxes = torch.as_tensor(np.asarray(xyxys, np.float32))
    is_obb = boxes.dim() == 2 and boxes.shape[1] >= 5
    boxes = boxes[:, :5 if is_obb else 4].to(device).contiguous()
    frame = as_frame(img, device)
    crops = torch.cat([extract_crops(frame, boxes[i:i + CHUNK], tuple(crop_hw), is_obb)
                       for i in range(0, len(boxes), CHUNK)])
    return crops.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def _l2norm(feats: np.ndarray) -> np.ndarray:
    feats = np.asarray(feats, np.float32)
    norm = np.linalg.norm(feats, axis=-1, keepdims=True)
    return feats / np.maximum(norm, 1e-12)


class TFLiteReID:
    """TFLite interpreter runtime.  The exporters write a batch-1 signature;
    the interpreter's input is resized to a call's batch where the model
    allows it, else crops run one at a time."""

    def __init__(self, weights: str | Path, crop_hw=(256, 128), model_name: str | None = None,
                 device="cuda"):
        from boxmot_tpu_torch.onnxlite.tf_function import tensorflow  # noqa: PLC0415

        self.device = resolve_device(device)
        self.weights = Path(weights)
        self.model_name = model_name or self.weights.stem
        self.crop_hw = crop_hw
        self._interp = tensorflow().lite.Interpreter(model_path=str(self.weights))
        self._interp.allocate_tensors()
        self._inp = self._interp.get_input_details()[0]
        self._out = self._interp.get_output_details()[0]
        self._batch_resizable = True
        self._native_shape = tuple(self._inp["shape"])
        self.feature_dim = int(self._out["shape"][-1])

    def _resize(self, shape: tuple) -> None:
        self._interp.resize_tensor_input(self._inp["index"], shape)
        self._interp.allocate_tensors()
        self._inp = self._interp.get_input_details()[0]
        self._out = self._interp.get_output_details()[0]

    def _invoke(self, batch: np.ndarray) -> np.ndarray:
        if self._batch_resizable and tuple(self._inp["shape"]) != batch.shape:
            try:
                self._resize(batch.shape)
            except Exception:
                # fixed-batch model: restore the exported shape and loop per
                # crop (restoring the original shape always succeeds)
                self._batch_resizable = False
                self._resize(self._native_shape)
        if tuple(self._inp["shape"]) != batch.shape:
            if tuple(self._inp["shape"][1:]) != batch.shape[1:]:
                raise ValueError(
                    f"crop shape {batch.shape[1:]} does not match the tflite model input "
                    f"{tuple(self._inp['shape'][1:])}; pass the crop_hw the model was "
                    "exported with")
            return np.concatenate([self._invoke(batch[i:i + 1]) for i in range(len(batch))])
        self._interp.set_tensor(self._inp["index"], batch.astype(np.float32))
        self._interp.invoke()
        return np.array(self._interp.get_tensor(self._out["index"]))

    def get_features(self, xyxys, img) -> np.ndarray:
        xyxys = np.asarray(xyxys, np.float32)
        if len(xyxys) == 0:
            return np.zeros((0, self.feature_dim), np.float32)
        return _l2norm(self._invoke(_crops_np(xyxys, img, self.crop_hw, self.device)))

    __call__ = get_features


class SavedModelReID:
    """TensorFlow SavedModel runtime (the exported signature is batch 1)."""

    def __init__(self, weights: str | Path, crop_hw=(256, 128), model_name: str | None = None,
                 device="cuda"):
        from boxmot_tpu_torch.onnxlite.tf_function import tensorflow  # noqa: PLC0415

        self.device = resolve_device(device)
        self.weights = Path(weights)
        self.model_name = model_name or self.weights.name
        self.crop_hw = crop_hw
        self._module = tensorflow().saved_model.load(str(self.weights))
        probe = np.zeros((1, *crop_hw, 3), np.float32)
        self.feature_dim = int(np.asarray(self._module.fwd(probe)).shape[-1])

    def get_features(self, xyxys, img) -> np.ndarray:
        xyxys = np.asarray(xyxys, np.float32)
        if len(xyxys) == 0:
            return np.zeros((0, self.feature_dim), np.float32)
        crops = _crops_np(xyxys, img, self.crop_hw, self.device)
        return _l2norm(np.concatenate([np.asarray(self._module.fwd(crops[i:i + 1]))
                                       for i in range(len(crops))]))

    __call__ = get_features


def create_reid(weights=None, **kwargs):
    """Suffix-dispatched ReID construction, as the JAX ``create_reid``: a
    model name (None: ``osnet_x0_25``), a torchreid ``.pt`` / ``.pth``, a
    Flax ``.msgpack``, a ``.tflite`` artifact, a SavedModel directory or a
    native ``manifest.txt`` (or its directory).  ``kwargs`` go to the
    backend (``device`` the card unless the caller asks for the CPU; the C++
    runtime is host code and takes none)."""
    if weights is None:
        return ReID(**kwargs)
    p = Path(str(weights))
    suffix = p.suffix.lower()
    if suffix == ".tflite":
        kwargs.pop("half", None)
        kwargs.pop("preprocess_name", None)
        return TFLiteReID(p, **kwargs)
    if p.is_dir() and (p / "saved_model.pb").exists():
        kwargs.pop("half", None)
        kwargs.pop("preprocess_name", None)
        return SavedModelReID(p, **kwargs)
    if p.name == "manifest.txt" or (p.is_dir() and (p / "manifest.txt").exists()):
        from boxmot_tpu_torch.native.reid import CppReID  # noqa: PLC0415

        return CppReID(p if p.name == "manifest.txt" else p / "manifest.txt")
    return ReID(weights=weights, **kwargs)
