# Frozen copy of boxmot_tpu_torch/ops/nms.py at commit 78364f93b578: the plain
# (twin) path only, on every device; no kernel, no tracker shell.
"""Greedy NMS (kernel K6 and its plain twin) and the YOLOX head decode.

Counterpart of ``boxmot_tpu/ops/nms.py`` (``nms``, ``batched_class_nms``,
``yolox_decode``).  The JAX ``nms`` is a ``lax.while_loop`` over the dense
N x N IoU matrix; eager PyTorch would read that loop's condition on the host
at every step, so on a CUDA tensor ``nms`` launches ``csrc/nms.cu`` once: a
block selects the top-scored candidates tier by tier, sorts them in shared
memory and scans them in order against the kept boxes, and the kept indices
stay on the card.  On a CPU tensor it runs ``nms_plain``, the JAX loop
replayed in plain PyTorch (argmax over the alive scores, the kept box's IoU
row, masks).  The twin takes the kept box's row of ``iou_batch(boxes,
boxes)`` as it is needed: the same values, in the same float operations,
without the N x N matrix (2.2 GB at YOLOX's 23,625 anchors).

A score is alive when it is at least ``FLT_MIN``: NaN, zero, negative and
subnormal scores are never kept (XLA flushes subnormals to zero on the TPU
and the CPU, so the JAX loop reads a subnormal score as 0).  ``iou_thresh``
is compared as float32, as the JAX loop compares its float32 IoUs with a
Python float.  ``yolox_decode`` is plain PyTorch (elementwise); its ``exp``
is evaluated in float64 and rounded once (``geometry.exact``), so the card
and the CPU decode the same raw head to the same boxes.
"""

from __future__ import annotations


import torch

from portbench.reference.frozen.ops.geometry import exact
from portbench.reference.frozen.ops.iou import iou_batch

CLASS_OFFSET = 4096.0  # batched_class_nms's coordinate offset a class (nms.py:51-57)
MIN_ALIVE = torch.finfo(torch.float32).tiny  # FLT_MIN: a smaller score is flushed to 0


def _check(boxes: torch.Tensor, scores: torch.Tensor, max_out: int) -> None:
    if boxes.dim() != 2 or boxes.shape[1] != 4:
        raise ValueError(f"nms: boxes must be (N, 4), got {tuple(boxes.shape)}")
    if scores.shape != (boxes.shape[0],):
        raise ValueError(f"nms: scores must be ({boxes.shape[0]},), got {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms: boxes and scores must be float32, got {boxes.dtype}, "
                        f"{scores.dtype}")
    if scores.device != boxes.device:
        raise ValueError(f"nms: scores are on {scores.device}, boxes on {boxes.device}")
    if max_out < 0:
        raise ValueError(f"nms: max_out must be >= 0, got {max_out}")


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float, max_out: int = 128):
    """The twin of K6: the JAX loop in plain PyTorch.  boxes (N, 4) xyxy,
    scores (N,) (an entry is a candidate only if its score is >= FLT_MIN) ->
    (keep_idx (max_out,) int32 padded with -1, keep_mask (max_out,) bool)."""
    _check(boxes, scores, max_out)
    dev = boxes.device
    keep = torch.full((max_out,), -1, dtype=torch.int32, device=dev)
    alive = scores >= MIN_ALIVE
    neg_inf = torch.full_like(scores, -torch.inf)
    thresh = torch.tensor(iou_thresh, dtype=torch.float32, device=dev)
    index = torch.arange(boxes.shape[0], device=dev)
    n = 0
    while n < max_out and bool(alive.any()):
        masked = torch.where(alive, scores, neg_inf)
        best = int(torch.argmax(masked))
        keep[n] = best
        n += 1
        suppress = iou_batch(boxes[best:best + 1], boxes)[0] > thresh
        alive = alive & ~suppress & (index != best)
    return keep, torch.arange(max_out, device=dev) < n


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float, max_out: int = 128):
    """Greedy NMS as ``nms_plain`` on every device."""
    _check(boxes, scores, max_out)
    return nms_plain(boxes, scores, iou_thresh, max_out)


nms.launches = 0


def _grid(img_hw, strides, device):
    """The anchors' (x, y) grid and stride, (N, 2) and (N, 1) float32, each
    level's cells row by row, the stride-8 level first."""
    grids, stride = [], []
    for s in strides:
        h, w = img_hw[0] // s, img_hw[1] // s
        ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                                indexing="ij")
        grids.append(torch.stack([xs, ys], dim=-1).reshape(-1, 2))
        stride.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(grids).to(torch.float32), torch.cat(stride)


def yolox_decode(raw: torch.Tensor, strides=(8, 16, 32), img_hw=(640, 640)):
    """Raw YOLOX head (..., N_anchors, 5 + C) -> (boxes (..., N, 4) absolute
    xyxy, obj (..., N), cls (..., N, C)), the sigmoid scores."""
    grid, stride = _grid(img_hw, strides, raw.device)
    xy = (raw[..., :2] + grid) * stride
    wh = exact(torch.exp, raw[..., 2:4]) * stride
    half = wh / 2
    boxes = torch.cat([xy - half, xy + half], dim=-1)
    return boxes, torch.sigmoid(raw[..., 4]), torch.sigmoid(raw[..., 5:])
