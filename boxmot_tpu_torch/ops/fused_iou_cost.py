"""Fused pairwise IoU + fused-score cost: kernel K1 and its plain twin.

``fused_iou_cost`` is the counterpart of the TPU kernel
``boxmot_tpu/ops/pallas_kernels.py::_fused_iou_cost_pallas`` (B1).  On a
CUDA tensor it launches the hand-written kernel ``csrc/iou_cost.cu``; on a
CPU tensor it runs ``fused_iou_cost_plain``, the same arithmetic in plain
PyTorch.  The tracker step calls it for the association IoU and cost and
for the duplicate-suppression IoU.
"""

from __future__ import annotations

import ctypes

import torch

from boxmot_tpu_torch.csrc import build

_P = ctypes.c_void_p


def fused_iou_cost_plain(trk: torch.Tensor, det: torch.Tensor, conf: torch.Tensor):
    """(S, K, 4), (S, D, 4) xyxy and (S, D) conf -> (iou, 1 - iou*conf), both (S, K, D).

    Same operation order as the TPU kernel, union clamped at 1e-9.
    """
    t = trk[:, :, None, :]
    d = det[:, None, :, :]
    xx1 = torch.maximum(t[..., 0], d[..., 0])
    yy1 = torch.maximum(t[..., 1], d[..., 1])
    xx2 = torch.minimum(t[..., 2], d[..., 2])
    yy2 = torch.minimum(t[..., 3], d[..., 3])
    inter = torch.clamp_min(xx2 - xx1, 0.0) * torch.clamp_min(yy2 - yy1, 0.0)
    area_t = (trk[..., 2] - trk[..., 0]) * (trk[..., 3] - trk[..., 1])
    area_d = (det[..., 2] - det[..., 0]) * (det[..., 3] - det[..., 1])
    iou = inter / torch.clamp_min(area_t[:, :, None] + area_d[:, None, :] - inter, 1e-9)
    return iou, 1.0 - iou * conf[:, None, :]


def _check(trk: torch.Tensor, det: torch.Tensor, conf: torch.Tensor) -> None:
    for name, t in (("trk", trk), ("det", det), ("conf", conf)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_iou_cost: {name} must be float32, got {t.dtype}")
        if t.device != trk.device:
            raise ValueError(f"fused_iou_cost: {name} is on {t.device}, trk on {trk.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_iou_cost: {name} must be contiguous")
    if trk.dim() != 3 or trk.shape[2] != 4:
        raise ValueError(f"fused_iou_cost: trk must be (S, K, 4), got {tuple(trk.shape)}")
    S, _, _ = trk.shape
    if det.dim() != 3 or det.shape[0] != S or det.shape[2] != 4:
        raise ValueError(f"fused_iou_cost: det must be (S, D, 4), got {tuple(det.shape)}")
    if tuple(conf.shape) != tuple(det.shape[:2]):
        raise ValueError(f"fused_iou_cost: conf must be (S, D), got {tuple(conf.shape)}")


def fused_iou_cost(trk: torch.Tensor, det: torch.Tensor, conf: torch.Tensor):
    """(iou, cost) as ``fused_iou_cost_plain``; kernel K1 on a CUDA tensor."""
    _check(trk, det, conf)
    if trk.device.type == "cpu":
        return fused_iou_cost_plain(trk, det, conf)
    if trk.device.type != "cuda":
        raise ValueError(f"fused_iou_cost: unsupported device {trk.device}")
    if any(t.data_ptr() % 16 for t in (trk, det)):
        raise ValueError("fused_iou_cost: box tensors must be 16-byte aligned")
    S, K, _ = trk.shape
    D = det.shape[1]
    fn = build.entry("iou_cost", "bmt_iou_cost", [_P] * 5 + [ctypes.c_int] * 3 + [_P])
    with torch.cuda.device(trk.device):
        iou = torch.empty((S, K, D), dtype=torch.float32, device=trk.device)
        cost = torch.empty_like(iou)
        stream = torch.cuda.current_stream(trk.device).cuda_stream
        rc = fn(trk.data_ptr(), det.data_ptr(), conf.data_ptr(), iou.data_ptr(),
                cost.data_ptr(), S, K, D, stream)
    build.check_launch("iou_cost", "bmt_iou_cost", rc)
    fused_iou_cost.launches += 1
    return iou, cost


fused_iou_cost.launches = 0
