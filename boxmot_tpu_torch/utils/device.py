"""Explicit device resolution and the tracker precision guard.

Counterpart of ``boxmot_tpu/utils/misc.py::select_device`` and
``boxmot_tpu/ops/precision.py``.  Every public entry point of the port
takes a ``device`` argument, ``"cuda"`` unless the caller asks for the
CPU, and resolves it here; nothing falls back from a requested CUDA device
to the CPU, so without a card the default raises.
"""

from __future__ import annotations

import numpy as np
import torch


def set_tracker_precision() -> None:
    """Keep float32 products in full float32.

    Tracker steps compare costs and Mahalanobis forms against thin
    thresholds (match_thresh 0.9, the duplicate IoU distance 0.15); TF32
    keeps about three decimal digits and would change associations.  The
    port's tracker math is elementwise, but the guard is set explicitly so
    that no product that a later slice adds can silently drop to TF32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: str | torch.device) -> torch.device:
    """Resolve ``"cpu"``, ``"cuda"`` or ``"cuda:N"`` to a ``torch.device``.

    Raises when CUDA is requested and absent, or the index is out of
    range.  Also sets the precision guard.
    """
    try:
        dev = torch.device(device)
    except RuntimeError as e:
        raise ValueError(f"unsupported device {str(device)!r}: use 'cpu' or 'cuda[:N]'") from e
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False"
            )
        count = torch.cuda.device_count()
        if dev.index is not None and dev.index >= count:
            raise ValueError(f"device index {dev.index} out of range ({count} cards)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cpu' or 'cuda[:N]'")
    set_tracker_precision()
    return dev


def as_tensor_on(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor: on ``device`` where one is named; else a
    tensor stays where it lies and a host array goes to the card."""
    if torch.is_tensor(x):
        return x.to(dtype) if device is None else x.to(resolve_device(device), dtype)
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(dtype)
    return t.to(resolve_device("cuda" if device is None else device))
