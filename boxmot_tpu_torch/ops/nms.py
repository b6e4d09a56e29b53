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

import ctypes

import torch

from boxmot_tpu_torch.csrc import build
from boxmot_tpu_torch.ops.geometry import exact
from boxmot_tpu_torch.ops.iou import iou_batch

CLASS_OFFSET = 4096.0  # batched_class_nms's coordinate offset a class (nms.py:51-57)
MIN_ALIVE = torch.finfo(torch.float32).tiny  # FLT_MIN: a smaller score is flushed to 0
_P = ctypes.c_void_p
_I = ctypes.c_int


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


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float, max_out: int = 128,
        counts: torch.Tensor | None = None):
    """Greedy NMS as ``nms_plain``; kernel K6 (one launch, no host sync) on a
    CUDA tensor.  ``counts``, a (1,) int64 tensor on the card, gets the number
    of IoUs the kernel evaluated added to it (for the record); the twin
    ignores it."""
    _check(boxes, scores, max_out)
    dev = boxes.device
    if dev.type == "cpu":
        return nms_plain(boxes, scores, iou_thresh, max_out)
    if dev.type != "cuda":
        raise ValueError(f"nms: unsupported device {dev}")
    if counts is not None and (counts.dtype != torch.int64 or counts.device != dev
                               or counts.numel() != 1):
        raise ValueError("nms: counts must be a (1,) int64 tensor on the boxes' card")
    boxes, scores = boxes.contiguous(), scores.contiguous()
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()  # the kernel reads a box as one float4
    if scores.data_ptr() % 16:
        scores = scores.clone()  # and four scores as one float4
    keep_idx = torch.empty((max_out,), dtype=torch.int32, device=dev)
    keep_mask = torch.empty((max_out,), dtype=torch.bool, device=dev)
    if max_out == 0:
        return keep_idx, keep_mask
    fn = build.entry("nms", "bmt_nms", [_P, _P, _I, ctypes.c_float, _I, _P, _P, _P, _P])
    with torch.cuda.device(dev):
        rc = fn(boxes.data_ptr(), scores.data_ptr(), boxes.shape[0], iou_thresh, max_out,
                keep_idx.data_ptr(), keep_mask.data_ptr(),
                None if counts is None else counts.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("nms", "bmt_nms", rc)
    build.count_launch(nms)
    return keep_idx, keep_mask


nms.launches = 0


def batched_class_nms(boxes, scores, classes, iou_thresh, max_out: int = 128):
    """Per-class NMS by the coordinate offset (torchvision batched_nms
    semantics): boxes of different classes never suppress each other."""
    offset = classes.to(torch.float32)[:, None] * CLASS_OFFSET
    return nms(boxes + offset, scores, iou_thresh, max_out)


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
