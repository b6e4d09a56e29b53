"""Suffix-dispatched ReID construction (counterpart of
``boxmot_tpu/reid/backends.py::create_reid``).

A model name or a torchreid ``.pt`` / ``.pth`` checkpoint goes to the
port's ``ReID``.  The JAX package's other runtimes are not ported, and each
raises ``NotImplementedError`` naming its ROADMAP item: a flax ``.msgpack``
checkpoint (it needs flax's serialization), a ``.tflite`` artifact, a
TensorFlow SavedModel directory and the native C++ runtime's
``manifest.txt``.  None of those runtimes is on the card's machine.
"""

from __future__ import annotations

from pathlib import Path

from boxmot_tpu_torch.reid.core import ReID


def create_reid(weights=None, **kwargs) -> ReID:
    """The ReID facade for ``weights`` (a model name, a torchreid checkpoint
    or None for the default ``osnet_x0_25``); ``kwargs`` go to ``ReID``
    (``device`` the card unless the caller asks for the CPU)."""
    if weights is None:
        return ReID(**kwargs)
    p = Path(str(weights))
    if p.suffix.lower() == ".msgpack":
        raise NotImplementedError("flax .msgpack checkpoints need flax's serialization: ROADMAP "
                                  "Queue A item 22")
    if p.suffix.lower() == ".tflite":
        raise NotImplementedError("the TFLite runtime is not ported: ROADMAP Queue A item 22")
    if p.is_dir() and (p / "saved_model.pb").exists():
        raise NotImplementedError("the TensorFlow SavedModel runtime is not ported: ROADMAP "
                                  "Queue A item 22")
    if p.name == "manifest.txt" or (p.is_dir() and (p / "manifest.txt").exists()):
        raise NotImplementedError("the native C++ OSNet runtime is not ported: ROADMAP Queue A "
                                  "item 22")
    return ReID(weights=weights, **kwargs)
