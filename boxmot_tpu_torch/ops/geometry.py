"""Box conversions on the last axis (counterpart of boxmot_tpu/ops/geometry.py).

Same operation order as the JAX functions.  Only the conversions the
ported trackers use are ported: XYAH for ByteTrack, XYWH for BoT-SORT, XYSR
for OC-SORT and DeepOCSORT, corners for oriented boxes.

``cos``, ``sin``, ``log`` and ``sqrt`` go through ``exact``: evaluated in
float64 and rounded to float32, they give the correctly rounded float32
result on the CPU and on the card alike (PyTorch's float32 CPU ``sqrt`` is
not correctly rounded, and its float32 ``cos``, ``sin`` and ``log`` differ
from the card's in the last bit), so a CPU run and a CUDA run of the port
give the same bits.
"""

from __future__ import annotations

import math

import torch


def exact(fn, x: torch.Tensor) -> torch.Tensor:
    """fn (a torch math function) of float32 x, correctly rounded: computed
    in float64 and rounded once, on any device."""
    return fn(x.double()).to(x.dtype)


def xyxy2xyah(x: torch.Tensor) -> torch.Tensor:
    """(x1,y1,x2,y2) -> (cx,cy,a=w/h,h)."""
    x1, y1, x2, y2 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    w = x2 - x1
    h = y2 - y1
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, w / h, h], dim=-1)


def xyah2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx,cy,a,h) -> (x1,y1,x2,y2); a = w/h."""
    cx, cy, a, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    w = a * h
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(x1,y1,x2,y2) -> (cx,cy,w,h), BoT-SORT's measurement."""
    x1, y1, x2, y2 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx,cy,w,h) -> (x1,y1,x2,y2)."""
    cx, cy, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def xyxy2xysr(x: torch.Tensor) -> torch.Tensor:
    """(x1,y1,x2,y2) -> (cx,cy,s=area,r=w/(h+1e-6)), OC-SORT's measurement."""
    x1, y1, x2, y2 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    w = x2 - x1
    h = y2 - y1
    return torch.stack([x1 + w / 2.0, y1 + h / 2.0, w * h, w / (h + 1e-6)], dim=-1)


def xysr2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx,cy,s,r) -> (x1,y1,x2,y2); w = sqrt(s*r), h = s/w."""
    cx, cy, s, r = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    w = exact(torch.sqrt, torch.clamp_min(s * r, 0.0))
    h = s / torch.clamp_min(w, 1e-12)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def obb2xysr(b: torch.Tensor) -> torch.Tensor:
    """(cx,cy,w,h,theta) -> (cx,cy,s=w*h,r=w/h,theta), OC-SORT's OBB measurement."""
    w = torch.clamp_min(b[..., 2], 1e-6)
    h = torch.clamp_min(b[..., 3], 1e-6)
    return torch.stack([b[..., 0], b[..., 1], w * h, w / h, b[..., 4]], dim=-1)


def xysr2obb(x: torch.Tensor) -> torch.Tensor:
    """(cx,cy,s,r,theta,...) state -> (cx,cy,w,h,theta)."""
    w = exact(torch.sqrt, torch.clamp_min(x[..., 2] * x[..., 3], 1e-12))
    h = x[..., 2] / torch.clamp_min(w, 1e-6)
    return torch.stack([x[..., 0], x[..., 1], w, h, x[..., 4]], dim=-1)


def obb_corners(xywha: torch.Tensor) -> torch.Tensor:
    """(cx,cy,w,h,angle_rad) -> 4 corners (..., 4, 2), in cv2.boxPoints order."""
    cx, cy, w, h, a = (xywha[..., i] for i in range(5))
    ca, sa = exact(torch.cos, a), exact(torch.sin, a)
    hw, hh = w / 2.0, h / 2.0
    lx = torch.stack([-hw, -hw, hw, hw], dim=-1)
    ly = torch.stack([hh, -hh, -hh, hh], dim=-1)
    px = cx[..., None] + lx * ca[..., None] - ly * sa[..., None]
    py = cy[..., None] + lx * sa[..., None] + ly * ca[..., None]
    return torch.stack([px, py], dim=-1)


def obb2xyxy(xywha: torch.Tensor) -> torch.Tensor:
    """Enclosing axis-aligned box of a rotated box."""
    corners = obb_corners(xywha)
    return torch.cat([corners.amin(dim=-2), corners.amax(dim=-2)], dim=-1)


def wrap_angle(angle: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]: float (floor) modulo, as ``jnp.remainder``."""
    return torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi
