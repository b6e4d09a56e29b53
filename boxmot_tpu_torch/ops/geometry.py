"""Box conversions on the last axis (counterpart of boxmot_tpu/ops/geometry.py).

Same operation order as the JAX functions.  Only the conversions the
ported trackers use are ported.

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
