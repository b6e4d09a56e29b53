"""The operations and bytes that the inputs of a kernel call need, whatever
the kernel's design: each input byte read once, each output byte written
once, and the operations the algorithm needs on these inputs.  Copied from
the counts ``chip_smoke.py`` holds the port's kernels to (``k4_bound``,
``k5_bound``, ``k6_work``, ``k6_bound``); K5's frame bytes are the pixels
that the crops' bilinear taps reach, not the whole frame.
"""

from __future__ import annotations

import numpy as np

from portbench.peaks import bound_ms

K5_OPS_PER_PIXEL = 2 + 4 + 6 + 12 + 2 + 3 * 15  # an axis-aligned crop's output pixel
K6_OPS_PER_IOU = 9 + 6 + 3 + 2
F32_TINY = float(np.finfo(np.float32).tiny)  # K6's least alive score
MAX_ORU = 32  # the longest replay K4 runs (``ops/oru.py``)


def _taps(lo: np.ndarray, hi: np.ndarray, n_out: int, size: int) -> np.ndarray:
    """The pixel indices that the clamped-bilinear taps of ``n_out`` samples
    between ``lo`` and ``hi`` reach on an axis of ``size`` pixels."""
    g = (np.arange(n_out, dtype=np.float32) + 0.5) * np.float32((hi - lo) / n_out) + (lo - 0.5)
    c0 = np.floor(np.clip(g, 0.0, size - 1.0)).astype(np.int64)
    return np.unique(np.concatenate([c0, np.minimum(c0 + 1, size - 1)]))


def k5_bound(frame_hw, boxes: np.ndarray, out_hw=(256, 128), out_bytes: int = 4):
    """(least ms, by) of one K5 call of axis-aligned (N, 4) xyxy ``boxes`` on a
    (H, W, 3) uint8 frame: the frame's pixels that some crop's taps reach
    read once, the boxes read once, the crops written once, against the
    counted operations of every output pixel."""
    H, W = frame_hw
    oh, ow = out_hw
    reached = np.zeros((H, W), bool)
    for x1, y1, x2, y2 in np.asarray(boxes, np.float32):
        reached[np.ix_(_taps(y1, y2, oh, H), _taps(x1, x2, ow, W))] = True
    n = len(boxes)
    pixels = n * oh * ow
    n_bytes = int(reached.sum()) * 3 + n * 16 + pixels * 3 * out_bytes
    return bound_ms(n_bytes, pixels * K5_OPS_PER_PIXEL)


def k6_work(scores: np.ndarray, keep_idx: np.ndarray, max_out: int) -> tuple[int, int]:
    """(candidates examined, IoUs) that the sorted definition of greedy NMS
    needs for these inputs, from the reference's result: the alive
    candidates (score >= FLT_MIN) in order (score descending, index
    ascending) are examined up to the max_out-th kept box, or all of them; a
    kept one needs its IoU with every box kept before it, a suppressed one
    at least one."""
    s = np.asarray(scores, np.float32)
    idx = np.nonzero(s >= F32_TINY)[0]
    order = idx[np.lexsort((idx, -s[idx].astype(np.float64)))]
    pos = np.full(len(s), -1)
    pos[order] = np.arange(len(order))
    kept = keep_idx[keep_idx >= 0]
    if len(kept) == max_out:
        examined = int(pos[kept[-1]]) + 1 if len(kept) else 0
    else:
        examined = len(order)
    return examined, len(kept) * (len(kept) - 1) // 2 + examined - len(kept)


def k6_bound(n: int, max_out: int, examined: int, ious: int):
    """(least ms, by): every score read once (N x 4 bytes), the examined
    candidates' boxes read once (x 16), the kept indices and mask written
    once (max_out x 5), and the sorted definition's IoUs."""
    return bound_ms(n * 4 + examined * 16 + max_out * 5, ious * K6_OPS_PER_IOU)


def _k4_predict_ops(dx: int) -> int:
    """Operations of one predict as K4 does them (``chip_smoke.py``)."""
    vel = 3 if dx == 7 else 4
    return vel + 2 * vel * dx + dx * dx + 2


def _k4_update_ops(dx: int, dz: int, kind: str) -> int:
    """Operations of one interpolated measurement and masked Joseph-form
    update as K4 does them (``chip_smoke.py``)."""
    ops = dz * dz
    ops += sum(2 * j + 1 for i in range(dz) for j in range(i + 1))
    ops += sum(1 + sum(2 * (i - j) + 1 for j in range(i)) for i in range(dz))
    ops += dz * dz * (2 * dz - 1) + dx * dz * (2 * dz - 1)
    ops += dz + dx * (2 * dz - 1) + dx + 2
    ops += dx * dz + 2 * dx * dx * (2 * dx - 1)
    ops += dx * dz + dx * dx * (2 * dz - 1) + dx * dx
    ops += 14
    if kind == "xysr_obb":
        ops += 6 + 4 * 12 + 3 + 1
    elif kind == "xyscr":
        ops += 2
    return ops


def k4_bound(dx: int, dz: int, kind: str, rejoin: np.ndarray, gap: np.ndarray):
    """(least ms, by) of one K4 call over (S, K) slots: every slot's mean and
    covariance read and written once, a rejoining slot's two measurements
    and gap read, the rejoin flags read and ``replayed`` read and written;
    against each rejoining slot's min(gap, MAX_ORU) updates and the predicts
    between them."""
    S, K = rejoin.shape
    n_bytes = S * K * (1 + 8 * (dx + dx * dx)) + int(rejoin.sum()) * 4 * (2 * dz + 1) + 8 * S
    n = np.minimum(np.where(rejoin, gap, 0), MAX_ORU).astype(np.int64)
    slots, updates = int((n > 0).sum()), int(n.sum())
    return bound_ms(n_bytes, updates * _k4_update_ops(dx, dz, kind)
                    + (updates - slots) * _k4_predict_ops(dx))
