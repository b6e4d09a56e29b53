"""The masked auction assignment in plain NumPy: the operations of
``frozen/ops/lap.py::masked_assignment_plain`` (the port's twin of kernel
K2) in the same order and in float32, so that it gives the twin's bits.
The twin's loop reads a flag each iteration; in PyTorch every iteration of
a small problem costs some hundred microseconds of dispatch, and an
appearance tracker's full assignments over tied costs run a thousand
iterations and more, so the reference solves them here.

A problem that the auction leaves at its iteration cap has no answer from
it (the program's replay path refuses such a solve); ``exact`` gives the
reference's answer there, the maximum-weight matching that the auction
approximates, by SciPy's ``linear_sum_assignment``."""

from __future__ import annotations

import numpy as np

F32 = np.float32
NEG = F32(-np.inf)


def solve(cost: np.ndarray, row_mask: np.ndarray, col_mask: np.ndarray, thresh,
          max_iters: int = 4000):
    """(r2c (S, R) int32, capped (S,) int32, work (S, 2) int32) of S problems:
    cost (S, R, C) float32, masks (S, R) / (S, C) bool, ``thresh`` a float
    or an (S,) float32 array; pairs with cost >= thresh never match."""
    S, R, C = cost.shape
    work = np.zeros((S, 2), np.int32)
    valid = row_mask[:, :, None] & col_mask[:, None, :]
    th = thresh[:, None, None].astype(F32) if isinstance(thresh, np.ndarray) else F32(thresh)
    w = (th - cost).astype(F32)
    w = np.where(valid & (w > 0), w, NEG).astype(F32)
    w_max = np.where(np.isfinite(w), w, F32(0.0)).max(axis=(1, 2)) if w.size else np.zeros(S, F32)
    eps = (np.maximum(w_max, F32(1e-2)) * F32(1e-4)).astype(F32)[:, None]
    col_ids = np.arange(C)
    cols = np.broadcast_to(col_ids, (S, C))
    ar = np.arange(S)[:, None]
    prices = np.zeros((S, C), F32)
    owner = np.full((S, C), -1, np.int64)
    r2c = np.full((S, R + 1), -1, np.int64)
    r2c[:, :R][~row_mask] = -2
    rows = r2c[:, :R]
    unassigned = rows == -1
    it = 0
    while it < max_iters and unassigned.any():
        work[:, 0] += unassigned.any(axis=1)
        work[:, 1] += unassigned.sum(axis=1).astype(np.int32)
        v = w - prices[:, None, :]
        jstar = v.argmax(axis=2)
        b1 = np.take_along_axis(v, jstar[..., None], 2)[..., 0]
        is_j = col_ids == jstar[..., None]
        b2 = np.where(is_j, NEG, v).max(axis=2)
        second = np.maximum(np.nan_to_num(b2, nan=0.0, posinf=0.0, neginf=0.0), F32(0.0))
        retire = unassigned & (b1 < 0)
        rows[retire] = -3
        bidding = unassigned ^ retire
        bid = np.take_along_axis(prices, jstar, 1) + (b1 - second) + eps
        bids_rc = np.where(is_j & bidding[..., None], bid[..., None], NEG)
        col_best = bids_rc.max(axis=1)
        col_winner = bids_rc.argmax(axis=1)
        has_bid = col_best > NEG
        r2c[ar, np.where(has_bid & (owner >= 0), owner, R)] = -1
        r2c[ar, np.where(has_bid, col_winner, R)] = cols
        prices = np.where(has_bid, col_best, prices)
        owner = np.where(has_bid, col_winner, owner)
        unassigned = rows == -1
        it += 1
    capped = unassigned.any(axis=1).astype(np.int32)
    return np.where(rows >= 0, rows, -1).astype(np.int32), capped, work


def exact(cost: np.ndarray, row_mask: np.ndarray, col_mask: np.ndarray, thresh) -> np.ndarray:
    """r2c (R,) int32 of one problem: the matching of the valid pairs with
    ``cost < thresh`` that maximizes the summed ``thresh - cost``, -1 for
    an unmatched row."""
    from scipy.optimize import linear_sum_assignment

    w = np.float64(thresh) - cost.astype(np.float64)
    w = np.where(row_mask[:, None] & col_mask[None, :] & (w > 0), w, 0.0)
    r2c = np.full(cost.shape[0], -1, np.int32)
    rows, cols = linear_sum_assignment(w, maximize=True)
    keep = w[rows, cols] > 0
    r2c[rows[keep]] = cols[keep]
    return r2c
