"""Pairwise rotated-box IoU: kernel K3 and its plain twin.

``rotated_iou`` is the counterpart of the TPU kernel
``boxmot_tpu/ops/pallas_rotated_iou.py::_rotated_iou_pallas_padded`` (B2)
and of the jnp clip ``boxmot_tpu/ops/rotated_iou.py::iou_batch_obb``,
which the JAX tracker steps run at tracker sizes.  On a CUDA tensor it
launches the hand-written kernel ``csrc/rotated_iou.cu``; on a CPU tensor
it runs ``rotated_iou_plain``.

The twin is the jnp clip, batched over a leading S: each pair is centred
on the mean of the two boxes' (cx, cy), and four Sutherland-Hodgman
half-plane clips run over duplicate-padded vertex slots (4 -> 8 -> 16 ->
32 -> 64) with a cyclic forward fill.  It differs from the jnp clip only
in the order of two sums: the clip polygon's winding sum and the shoelace
sum are added slot by slot, in slot order, so that the kernel, which
keeps a compact vertex list instead of padded slots, can add the same
nonzero terms in the same order (see the kernel's source note).

Both take the corners from the caller (``obb_corners`` by default), so a
comparison of the kernel with the twin tests the clip and not the trig.
"""

from __future__ import annotations

import ctypes

import torch

from boxmot_tpu_torch.csrc import build
from boxmot_tpu_torch.ops.geometry import obb_corners

_P = ctypes.c_void_p


def _forward_fill(x, y, valid):
    """Invalid slots take the previous valid slot's vertex, cyclically:
    leading invalid slots take the last valid one (slot 0's if none is)."""
    L = valid.shape[-1]
    slots = torch.arange(L, device=valid.device)
    last = torch.where(valid, slots, -1).cummax(dim=-1).values
    last = torch.where(last < 0, last[..., -1:].clamp_min(0), last)
    return torch.gather(x, -1, last), torch.gather(y, -1, last)


def _clip_halfplane(x, y, nonempty, p1x, p1y, p2x, p2y, orient):
    """Clip the padded closed polygons (..., L) by the half-plane left of
    p1 -> p2 (times orient); returns (..., 2L) slots and the new nonempty."""
    dx = (p2x - p1x)[..., None]
    dy = (p2y - p1y)[..., None]
    side = (dx * (y - p1y[..., None]) - dy * (x - p1x[..., None])) * orient[..., None]
    inside = side >= 0.0
    nx, ny = torch.roll(x, -1, -1), torch.roll(y, -1, -1)
    n_inside, n_side = torch.roll(inside, -1, -1), torch.roll(side, -1, -1)
    denom = side - n_side
    t = side / torch.where(torch.abs(denom) < 1e-30, 1e-30, denom)
    cx = x + t * (nx - x)
    cy = y + t * (ny - y)
    # slot 2i: the crossing of edge i, slot 2i + 1: its end vertex if inside
    shape = x.shape[:-1] + (2 * x.shape[-1],)
    out_x = torch.stack([cx, nx], dim=-1).reshape(shape)
    out_y = torch.stack([cy, ny], dim=-1).reshape(shape)
    valid = torch.stack([inside != n_inside, n_inside], dim=-1).reshape(shape) & nonempty[..., None]
    out_x, out_y = _forward_fill(out_x, out_y, valid)
    return out_x, out_y, nonempty & valid.any(dim=-1)


def _sum_slots(terms):
    """Sum over the last axis, one slot at a time, in slot order."""
    acc = torch.zeros_like(terms[..., 0])
    for s in range(terms.shape[-1]):
        acc = acc + terms[..., s]
    return acc


def rotated_iou_plain(obbs1, obbs2, c1=None, c2=None):
    """(S, N, 5) x (S, M, 5) xywha -> (S, N, M) rotated IoU.

    c1, c2: the boxes' corners (S, N, 4, 2) and (S, M, 4, 2); computed with
    ``obb_corners`` when not given.
    """
    c1 = obb_corners(obbs1) if c1 is None else c1
    c2 = obb_corners(obbs2) if c2 is None else c2
    offx = (obbs1[:, :, None, 0] + obbs2[:, None, :, 0]) / 2.0  # (S, N, M)
    offy = (obbs1[:, :, None, 1] + obbs2[:, None, :, 1]) / 2.0
    x = c1[:, :, None, :, 0] - offx[..., None]  # (S, N, M, 4)
    y = c1[:, :, None, :, 1] - offy[..., None]
    nonempty = torch.ones(offx.shape, dtype=torch.bool, device=offx.device)

    # winding of the clip polygon: sign of its signed area
    n2 = torch.roll(c2, -1, -2)
    signed2 = 0.5 * _sum_slots(c2[..., 0] * n2[..., 1] - n2[..., 0] * c2[..., 1])
    orient = torch.where(signed2 >= 0, 1.0, -1.0)[:, None, :].expand_as(offx)

    ex = c2[:, None, :, :, 0] - offx[..., None]  # (S, N, M, 4)
    ey = c2[:, None, :, :, 1] - offy[..., None]
    for k in range(4):
        kn = (k + 1) % 4
        x, y, nonempty = _clip_halfplane(x, y, nonempty, ex[..., k], ey[..., k],
                                         ex[..., kn], ey[..., kn], orient)

    area = 0.5 * torch.abs(_sum_slots(x * torch.roll(y, -1, -1) - torch.roll(x, -1, -1) * y))
    inter = torch.where(nonempty, area, 0.0)
    a1 = obbs1[..., 2] * obbs1[..., 3]
    a2 = obbs2[..., 2] * obbs2[..., 3]
    union = a1[:, :, None] + a2[:, None, :] - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, 1e-12), 0.0)


def _check_boxes(obbs1, obbs2) -> None:
    if obbs1.dim() != 3 or obbs1.shape[2] != 5:
        raise ValueError(f"rotated_iou: obbs1 must be (S, N, 5), got {tuple(obbs1.shape)}")
    S = obbs1.shape[0]
    if obbs2.dim() != 3 or obbs2.shape[0] != S or obbs2.shape[2] != 5:
        raise ValueError(f"rotated_iou: obbs2 must be (S, M, 5), got {tuple(obbs2.shape)}")


def _check(obbs1, obbs2, c1, c2) -> None:
    for name, t in (("obbs1", obbs1), ("obbs2", obbs2), ("c1", c1), ("c2", c2)):
        if t.dtype != torch.float32:
            raise TypeError(f"rotated_iou: {name} must be float32, got {t.dtype}")
        if t.device != obbs1.device:
            raise ValueError(f"rotated_iou: {name} is on {t.device}, obbs1 on {obbs1.device}")
        if not t.is_contiguous():
            raise ValueError(f"rotated_iou: {name} must be contiguous")
    for name, c, b in (("c1", c1, obbs1), ("c2", c2, obbs2)):
        if tuple(c.shape) != tuple(b.shape[:2]) + (4, 2):
            raise ValueError(f"rotated_iou: {name} must be {tuple(b.shape[:2]) + (4, 2)}, "
                             f"got {tuple(c.shape)}")


def _launch(obbs1, obbs2, c1, c2, ops=None, slow=None):
    S, N, _ = obbs1.shape
    M = obbs2.shape[1]
    fn = build.entry("rotated_iou", "bmt_rotated_iou", [_P] * 7 + [ctypes.c_int] * 3 + [_P])
    with torch.cuda.device(obbs1.device):
        out = torch.empty((S, N, M), dtype=torch.float32, device=obbs1.device)
        stream = torch.cuda.current_stream(obbs1.device).cuda_stream
        rc = fn(obbs1.data_ptr(), c1.data_ptr(), obbs2.data_ptr(), c2.data_ptr(), out.data_ptr(),
                None if ops is None else ops.data_ptr(), None if slow is None else slow.data_ptr(),
                S, N, M, stream)
    build.check_launch("rotated_iou", "bmt_rotated_iou", rc)
    return out


def _check_card(obbs1, c1, c2) -> None:
    if obbs1.device.type != "cuda":
        raise ValueError(f"rotated_iou: unsupported device {obbs1.device}")
    if any(t.data_ptr() % 16 for t in (c1, c2)):
        raise ValueError("rotated_iou: corner tensors must be 16-byte aligned")


def rotated_iou(obbs1, obbs2, c1=None, c2=None):
    """(S, N, M) IoU as ``rotated_iou_plain``; kernel K3 on a CUDA tensor."""
    _check_boxes(obbs1, obbs2)
    c1 = obb_corners(obbs1).contiguous() if c1 is None else c1
    c2 = obb_corners(obbs2).contiguous() if c2 is None else c2
    _check(obbs1, obbs2, c1, c2)
    if obbs1.device.type == "cpu":
        return rotated_iou_plain(obbs1, obbs2, c1, c2)
    _check_card(obbs1, c1, c2)
    out = _launch(obbs1, obbs2, c1, c2)
    build.count_launch(rotated_iou)
    return out


def rotated_iou_counted(obbs1, obbs2, c1, c2):
    """K3's counting instantiation, for measurement only (CUDA tensors):
    (iou, ops, slow) with each pair's arithmetic operations ops (S, N, M)
    int32, those of the clip walk and its centring and quotient (the reject
    test left out), and the number of pairs that overflowed the fast path
    (8 vertices) and took the slow path.  It walks every pair, the rejected
    ones too, so its iou equalling ``rotated_iou``'s also checks the reject
    test; the tracker steps never call this, so it does not count launches."""
    _check_boxes(obbs1, obbs2)
    _check(obbs1, obbs2, c1, c2)
    _check_card(obbs1, c1, c2)
    S, N, _ = obbs1.shape
    ops = torch.empty((S, N, obbs2.shape[1]), dtype=torch.int32, device=obbs1.device)
    slow = torch.zeros(1, dtype=torch.int32, device=obbs1.device)
    out = _launch(obbs1, obbs2, c1, c2, ops, slow)
    return out, ops, int(slow)


rotated_iou.launches = 0
