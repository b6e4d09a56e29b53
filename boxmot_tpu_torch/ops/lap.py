"""Masked auction assignment: kernel K2 and its plain twin.

Counterpart of ``boxmot_tpu/ops/lap.py::masked_assignment`` (lapjv
``cost_limit`` semantics solved as a max-weight partial matching by a
single-round epsilon auction; see that module for the derivation).  On a
CUDA tensor ``masked_assignment`` launches ``csrc/auction.cu``, one thread
block per problem, so the data-dependent loop never returns to the host.
On a CPU tensor it runs ``masked_assignment_plain``: the same operations
as the JAX solver, batched over S, as a Python ``while`` (over the rows
valid in some problem: the others cannot change the result).  A finished
problem does no-op iterations there, as under JAX's batched while_loop.
The twin takes a row's best value and its column, and a column's best bid
and its row, from one ``max`` each (the first of equal maxima, as JAX's
``argmax``), and keeps r2c with one spare column that the "drop" scatters
write into, so that an iteration dispatches as few operations as it can.

Both return ``r2c`` (S, R) int32 (matched column or -1) and add 1 to
``capped[s]`` for each problem that stopped at ``max_iters`` with rows
still unassigned, so a caller can refuse a truncated solve.  ``thresh`` is
a float for every problem, or an (S,) float32 tensor of one per problem
(SFSORT's dynamic first-pass threshold).  An optional ``work`` (S, 2)
int32 tensor receives each problem's iterations and pending rows scanned
(summed over its iterations): the work these inputs needed, from which a
caller counts the kernel's bound.

``linear_assignment`` and ``linear_assignment_np`` are the JAX module's host
wrappers with its signatures (matches, unmatched rows, unmatched columns as
numpy): the first pads the cost to JAX's power-of-two buckets and solves it
with ``masked_assignment`` on ``device`` (kernel K2 on the card; at most
``MAX_ROWS`` x ``MAX_COLS``), the second is the exact oracle, the native JV
solver where the repo's library builds and scipy elsewhere, as in JAX.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from boxmot_tpu_torch.csrc import build
from boxmot_tpu_torch.utils.device import resolve_device

MAX_ROWS = 256  # rows one thread block holds: one thread each
MAX_COLS = 512  # columns one thread block holds
# the most dynamic shared memory the kernel is given for the weights; the
# wrapper picks its path by this (uses_shared_weights) and passes the choice
SHARED_W_BYTES = 200 * 1024
_P = ctypes.c_void_p
_NEG = float("-inf")


def masked_assignment_plain(cost, row_mask, col_mask, thresh, capped,
                            max_iters: int = 4000, work=None):
    """Plain PyTorch twin of the kernel; see the module docstring.  Its
    tensors skip autograd's bookkeeping (``inference_mode``), the larger part
    of a small operation's time on the CPU."""
    with torch.inference_mode():
        S, R, C = cost.shape
        valid = row_mask[:, :, None] & col_mask[:, None, :]
        w = (thresh[:, None, None] if torch.is_tensor(thresh) else thresh) - cost
        w = torch.where(valid & (w > 0), w, _NEG)
        col_ids = torch.arange(C, device=cost.device)
        w_max = torch.where(torch.isfinite(w), w, 0.0).amax(dim=(1, 2))
        eps = (torch.clamp_min(w_max, 1e-2) * 1e-4)[:, None]

        prices = torch.zeros((S, C), dtype=cost.dtype, device=cost.device)
        owner = torch.full((S, C), -1, dtype=torch.int64, device=cost.device)
        # r2c with a spare column R: scatters of "no row" land there ("drop" mode)
        r2c = torch.full((S, R + 1), -1, dtype=torch.int64, device=cost.device)
        r2c[:, :R].masked_fill_(~row_mask, -2)
        rows = r2c[:, :R]  # a view
        cols = col_ids.expand(S, C)
        unassigned = rows == -1
        it = 0
        while it < max_iters and bool(unassigned.any()):
            if work is not None:
                work[:, 0] += unassigned.any(dim=1).to(work.dtype)
                work[:, 1] += unassigned.sum(dim=1).to(work.dtype)
            v = w - prices[:, None, :]
            b1, jstar = v.max(dim=2)
            is_j = col_ids == jstar[..., None]
            b2 = torch.where(is_j, _NEG, v).amax(dim=2)
            # non-finite b2 -> 0 (JAX's where(isfinite(b2), b2, 0)), then the dummy's 0
            second = torch.nan_to_num(b2, nan=0.0, posinf=0.0, neginf=0.0).clamp_min_(0.0)
            retire = unassigned & (b1 < 0)
            rows.masked_fill_(retire, -3)
            bidding = unassigned ^ retire  # retire lies within unassigned
            bid = torch.gather(prices, 1, jstar) + (b1 - second) + eps

            bids_rc = torch.where(is_j & bidding[..., None], bid[..., None], _NEG)
            col_best, col_winner = bids_rc.max(dim=1)
            has_bid = col_best > _NEG

            r2c.scatter_(1, torch.where(has_bid & (owner >= 0), owner, R), -1)  # dethrone
            r2c.scatter_(1, torch.where(has_bid, col_winner, R), cols)  # install winners
            prices = torch.where(has_bid, col_best, prices)
            owner = torch.where(has_bid, col_winner, owner)
            unassigned = rows == -1
            it += 1
        capped += unassigned.any(dim=1).to(capped.dtype)
        r2c = torch.where(rows >= 0, rows, -1).to(torch.int32)
    return r2c.clone()  # a normal tensor again


def _check(cost, row_mask, col_mask, thresh, capped, work) -> None:
    if cost.dim() != 3 or cost.dtype != torch.float32:
        raise ValueError(f"masked_assignment: cost must be (S, R, C) float32, got "
                         f"{tuple(cost.shape)} {cost.dtype}")
    S, R, C = cost.shape
    if R > MAX_ROWS or C > MAX_COLS:
        raise ValueError(f"masked_assignment: R={R}, C={C}; at most {MAX_ROWS} rows "
                         f"and {MAX_COLS} columns")
    tensors = [
        ("row_mask", row_mask, (S, R), torch.bool),
        ("col_mask", col_mask, (S, C), torch.bool),
        ("capped", capped, (S,), torch.int32),
    ]
    if torch.is_tensor(thresh):
        tensors.append(("thresh", thresh, (S,), torch.float32))
    if work is not None:
        tensors.append(("work", work, (S, 2), torch.int32))
    for name, t, shape, dtype in tensors:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"masked_assignment: {name} must be {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != cost.device:
            raise ValueError(f"masked_assignment: {name} is on {t.device}, cost on {cost.device}")
    if not all(t.is_contiguous() for _, t, _, _ in tensors) or not cost.is_contiguous():
        raise ValueError("masked_assignment: inputs must be contiguous")


def masked_assignment(cost, row_mask, col_mask, thresh, capped,
                      max_iters: int = 4000, work=None):
    """Solve S masked assignments: cost (S, R, C), masks (S, R)/(S, C).

    Pairs with cost >= thresh never match.  Returns r2c (S, R) int32 and
    adds to ``capped`` (S,) int32 in place; kernel K2 on a CUDA tensor.
    ``work``, when given, is zeroed and filled as the module docstring says.
    """
    _check(cost, row_mask, col_mask, thresh, capped, work)
    if work is not None:
        work.zero_()
    if cost.device.type == "cpu":
        return _plain_on_valid_rows(cost, row_mask, col_mask, thresh, capped, max_iters, work)
    if cost.device.type != "cuda":
        raise ValueError(f"masked_assignment: unsupported device {cost.device}")
    S, R, C = cost.shape
    fn = build.entry("auction", "bmt_auction",
                     [_P] * 6 + [ctypes.c_float, _P] + [ctypes.c_int] * 5 + [_P])
    per_problem = torch.is_tensor(thresh)
    with torch.cuda.device(cost.device):
        r2c = torch.empty((S, R), dtype=torch.int32, device=cost.device)
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        rc = fn(cost.data_ptr(), row_mask.data_ptr(), col_mask.data_ptr(), r2c.data_ptr(),
                capped.data_ptr(), thresh.data_ptr() if per_problem else None,
                0.0 if per_problem else float(thresh),
                None if work is None else work.data_ptr(), S, R, C, max_iters,
                int(uses_shared_weights(R, C)), stream)
    build.check_launch("auction", "bmt_auction", rc)
    build.count_launch(masked_assignment)
    return r2c


def _plain_on_valid_rows(cost, row_mask, col_mask, thresh, capped, max_iters, work):
    """The twin over the rows that are valid in some problem only.  A row
    valid in none never bids and never owns a column, and the twin's argmax
    keeps the order of the rows it is given, so r2c, ``capped`` and ``work``
    are the same bit for bit; on the CPU the twin's time grows with its rows
    (a tracker's capacity, where few slots are live)."""
    rows = row_mask.any(dim=0).nonzero()[:, 0]
    if len(rows) == cost.shape[1]:
        return masked_assignment_plain(cost, row_mask, col_mask, thresh, capped, max_iters, work)
    r2c = torch.full(row_mask.shape, -1, dtype=torch.int32)
    if len(rows):
        r2c[:, rows] = masked_assignment_plain(cost[:, rows], row_mask[:, rows], col_mask, thresh,
                                               capped, max_iters, work)
    return r2c


def uses_shared_weights(R: int, C: int) -> bool:
    """Whether kernel K2 keeps the (R, C) weights in shared memory for a
    problem of this shape (else it reads the cost from global memory)."""
    return R * C * 4 <= SHARED_W_BYTES


masked_assignment.launches = 0


def _split(r2c: np.ndarray, m: int):
    """r2c (n,) -> (matches (K, 2), unmatched rows, unmatched columns)."""
    n = len(r2c)
    matches = np.array([[r, r2c[r]] for r in range(n) if r2c[r] >= 0], dtype=int).reshape(-1, 2)
    unmatched_rows = np.array([r for r in range(n) if r2c[r] < 0], dtype=int)
    matched_cols = set(matches[:, 1].tolist())
    unmatched_cols = np.array([c for c in range(m) if c not in matched_cols], dtype=int)
    return matches, unmatched_rows, unmatched_cols


def linear_assignment_np(cost: np.ndarray, thresh: float):
    """Exact host-side oracle of the reference ``linear_assignment`` (lapjv
    with ``cost_limit``): the native JV solver, or scipy on the augmented
    (n + m) x (n + m) matrix.  Returns (matches (K, 2), unmatched_rows,
    unmatched_cols)."""
    from boxmot_tpu_torch.native import lapjv_native, native_available

    cost = np.asarray(cost, dtype=np.float64)
    n, m = cost.shape
    if cost.size == 0:
        return np.empty((0, 2), dtype=int), np.arange(n), np.arange(m)
    limit = float(thresh)
    native = lapjv_native(cost, limit) if native_available() else None
    if native is not None:
        row_to_col = native.astype(int)
    else:
        from scipy.optimize import linear_sum_assignment

        big = np.full((n + m, n + m), limit / 2.0, dtype=np.float64)
        big[n:, m:] = 0.0
        big[:n, :m] = cost
        rows, cols = linear_sum_assignment(big)
        row_to_col = np.full(n, -1, dtype=int)
        for r, c in zip(rows, cols):
            if r < n and c < m:
                row_to_col[r] = c
    return _split(row_to_col, m)


def linear_assignment(cost, thresh: float, device="cuda"):
    """The reference ``linear_assignment`` on ``device``: the (n, m) cost
    padded to power-of-two buckets (at least 8, as JAX's jit cache keys)
    and solved by ``masked_assignment``; returns (matches, unmatched_rows,
    unmatched_cols) as numpy.  A solve stopped at its iteration cap returns
    its partial assignment, as JAX's does."""
    cost = np.asarray(cost)
    n, m = cost.shape
    if cost.size == 0:
        return np.empty((0, 2), dtype=int), np.arange(n), np.arange(m)
    dev = resolve_device(device)
    R = max(8, 1 << (n - 1).bit_length())
    C = max(8, 1 << (m - 1).bit_length())
    padded = np.zeros((1, R, C), np.float32)
    padded[0, :n, :m] = cost
    rows = (torch.arange(R, device=dev) < n)[None]
    cols = (torch.arange(C, device=dev) < m)[None]
    capped = torch.zeros(1, dtype=torch.int32, device=dev)
    r2c = masked_assignment(torch.from_numpy(padded).to(dev), rows, cols, float(thresh), capped)
    return _split(r2c[0, :n].cpu().numpy(), m)
