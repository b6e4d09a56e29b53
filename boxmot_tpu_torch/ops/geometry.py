"""Box conversions on the last axis (counterpart of boxmot_tpu/ops/geometry.py).

Same operation order as the JAX functions, so results are bit-equal on
the CPU.  Only the conversions the ByteTrack AABB slice uses are ported.
"""

from __future__ import annotations

import math

import torch


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


def wrap_angle(angle: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]: float (floor) modulo, as ``jnp.remainder``."""
    return torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi
