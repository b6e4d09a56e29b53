"""Fused pairwise IoU + fused-score cost: kernel K1 and its plain twin.

``fused_iou_cost`` is the counterpart of the TPU kernel
``boxmot_tpu/ops/pallas_kernels.py::_fused_iou_cost_pallas`` (B1).  On a
CUDA tensor it launches the hand-written kernel ``csrc/iou_cost.cu``; on a
CPU tensor it runs ``fused_iou_cost_plain``, the same arithmetic in plain
PyTorch.  The tracker steps call it for the association IoU and cost, and
in its IoU-only mode (no ``conf``) for ByteTrack's duplicate-suppression IoU
and OC-SORT's association IoU.

The union clamp ``eps`` is an argument.  Its default, 1e-9, is the TPU
kernel's; the tracker steps pass ``IOU_BATCH_EPS`` (1e-12), the clamp of
``iou_batch``, which the JAX tracker steps use: the two clamps give other
IoUs on boxes whose union is below 1e-9.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from boxmot_tpu_torch.csrc import build

_P = ctypes.c_void_p
_I = ctypes.c_int
THREADS = 512  # the most threads a block of K1 has
TPU_KERNEL_EPS = 1e-9  # the TPU kernel's union clamp
IOU_BATCH_EPS = 1e-12  # iou_batch's union clamp, which the tracker steps use


class Launch(NamedTuple):
    """K1's launch: grid (row_blocks, S), block (quads, lanes)."""

    rows: int  # TK, the track rows of one problem a block covers
    row_blocks: int  # ceil(K / TK)
    quads: int  # threads across a row, each owning 4 consecutive detections
    lanes: int  # rows in flight: a thread walks rows lane, lane + lanes, ...
    vec: bool  # float4 loads and stores: every row starts 16-byte aligned (D % 4 == 0)


@functools.lru_cache(maxsize=256)
def launch_geometry(S: int, K: int, D: int, sms: int) -> Launch:
    """K1's launch for S problems of K x D on a card with ``sms`` SMs.

    Each problem gets about sms // S blocks of whole rows, so the S * ceil(K
    / TK) blocks fill the card about once; a block has ceil(D / 4) threads
    across a row (at most ``THREADS``) and as many rows in flight as keep it
    within ``THREADS`` threads.
    """
    rows = -(-K // max(1, min(K, sms // S)))
    quads = min(-(-D // 4), THREADS)
    return Launch(rows, -(-K // rows), quads, max(1, min(rows, THREADS // quads)), D % 4 == 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_iou_cost_plain(trk: torch.Tensor, det: torch.Tensor, conf: torch.Tensor | None = None,
                         eps: float = TPU_KERNEL_EPS):
    """(S, K, 4), (S, D, 4) xyxy and (S, D) conf -> (iou, 1 - iou*conf), both
    (S, K, D); (iou, None) without conf.

    Same operation order as the TPU kernel, union clamped at ``eps``.
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
    iou = inter / torch.clamp_min(area_t[:, :, None] + area_d[:, None, :] - inter, eps)
    return iou, None if conf is None else 1.0 - iou * conf[:, None, :]


def _check(trk: torch.Tensor, det: torch.Tensor, conf: torch.Tensor | None, eps: float):
    """One pass over the arguments; returns (S, K, D)."""
    if not eps > 0.0:
        raise ValueError(f"fused_iou_cost: eps must be > 0, got {eps}")
    if trk.dim() != 3 or trk.shape[2] != 4:
        raise ValueError(f"fused_iou_cost: trk must be (S, K, 4), got {tuple(trk.shape)}")
    S, K, _ = trk.shape
    if det.dim() != 3 or det.shape[0] != S or det.shape[2] != 4:
        raise ValueError(f"fused_iou_cost: det must be (S, D, 4), got {tuple(det.shape)}")
    D = det.shape[1]
    if conf is not None and tuple(conf.shape) != (S, D):
        raise ValueError(f"fused_iou_cost: conf must be (S, D), got {tuple(conf.shape)}")
    for name, t in (("trk", trk), ("det", det), ("conf", conf)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"fused_iou_cost: {name} must be float32, got {t.dtype}")
        if t.device != trk.device:
            raise ValueError(f"fused_iou_cost: {name} is on {t.device}, trk on {trk.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_iou_cost: {name} must be contiguous")
    return S, K, D


def fused_iou_cost(trk: torch.Tensor, det: torch.Tensor, conf: torch.Tensor | None = None,
                   eps: float = TPU_KERNEL_EPS):
    """(iou, cost) as ``fused_iou_cost_plain``, (iou, None) without conf;
    kernel K1 on a CUDA tensor."""
    S, K, D = _check(trk, det, conf, eps)
    dev = trk.device
    if dev.type == "cpu":
        return fused_iou_cost_plain(trk, det, conf, eps)
    if dev.type != "cuda":
        raise ValueError(f"fused_iou_cost: unsupported device {dev}")
    if trk.data_ptr() % 16 or det.data_ptr() % 16:
        raise ValueError("fused_iou_cost: box tensors must be 16-byte aligned")
    iou = torch.empty((S, K, D), dtype=torch.float32, device=dev)
    cost = None if conf is None else torch.empty_like(iou)
    if iou.numel() == 0:
        return iou, cost
    g = launch_geometry(S, K, D, _sm_count(dev.index))
    vec = g.vec and (conf is None or conf.data_ptr() % 16 == 0)
    fn = build.entry("iou_cost", "bmt_iou_cost", [_P] * 5 + [_I] * 8 + [ctypes.c_float, _P])
    with torch.cuda.device(dev):
        rc = fn(trk.data_ptr(), det.data_ptr(), None if conf is None else conf.data_ptr(),
                iou.data_ptr(), None if cost is None else cost.data_ptr(), S, K, D, *g[:4], vec,
                eps, torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("iou_cost", "bmt_iou_cost", rc)
    build.count_launch(fused_iou_cost)
    return iou, cost


fused_iou_cost.launches = 0


def empty_launch(device: torch.device, blocks: int = 1, threads: int = 32) -> None:
    """Launch an empty kernel of ``blocks`` x ``threads`` from K1's library,
    through the same ctypes path, on ``device``'s current stream: for
    measuring the card's launch floor."""
    fn = build.entry("iou_cost", "bmt_empty", [_I, _I, _P])
    with torch.cuda.device(device):
        rc = fn(blocks, threads, torch.cuda.current_stream(device).cuda_stream)
    build.check_launch("iou_cost", "bmt_empty", rc)
