"""Masked auction assignment: kernel K2 and its plain twin.

Counterpart of ``boxmot_tpu/ops/lap.py::masked_assignment`` (lapjv
``cost_limit`` semantics solved as a max-weight partial matching by a
single-round epsilon auction; see that module for the derivation).  On a
CUDA tensor ``masked_assignment`` launches ``csrc/auction.cu``, one thread
block per problem, so the data-dependent loop never returns to the host.
On a CPU tensor it runs ``masked_assignment_plain``: the same operations
as the JAX solver, batched over S, as a Python ``while``.  A finished
problem does no-op iterations there, as under JAX's batched while_loop.

Both return ``r2c`` (S, R) int32 (matched column or -1) and add 1 to
``capped[s]`` for each problem that stopped at ``max_iters`` with rows
still unassigned, so a caller can refuse a truncated solve.  ``thresh`` is
a float for every problem, or an (S,) float32 tensor of one per problem
(SFSORT's dynamic first-pass threshold).
"""

from __future__ import annotations

import ctypes

import torch

from boxmot_tpu_torch.csrc import build

MAX_ROWS = 256  # rows one thread block holds: one thread each
MAX_COLS = 512  # columns one thread block holds: two per thread
_P = ctypes.c_void_p
_NEG = float("-inf")


def masked_assignment_plain(cost, row_mask, col_mask, thresh, capped,
                            max_iters: int = 4000):
    """Plain PyTorch twin of the kernel; see the module docstring."""
    S, R, C = cost.shape
    valid = row_mask[:, :, None] & col_mask[:, None, :]
    w = (thresh[:, None, None] if torch.is_tensor(thresh) else thresh) - cost
    w = torch.where(valid & (w > 0), w, _NEG)
    col_ids = torch.arange(C, device=cost.device)
    w_max = torch.where(torch.isfinite(w), w, 0.0).amax(dim=(1, 2))
    eps = (torch.clamp_min(w_max, 1e-2) * 1e-4)[:, None]

    prices = torch.zeros((S, C), dtype=cost.dtype, device=cost.device)
    owner = torch.full((S, C), -1, dtype=torch.int64, device=cost.device)
    r2c = torch.where(row_mask, -1, -2).to(torch.int64)
    drop = torch.zeros((S, 1), dtype=torch.int64, device=cost.device)
    it = 0
    while it < max_iters and bool((r2c == -1).any()):
        unassigned = r2c == -1
        v = w - prices[:, None, :]
        b1 = v.amax(dim=2)
        jstar = v.argmax(dim=2)
        b2 = torch.where(col_ids == jstar[..., None], _NEG, v).amax(dim=2)
        second = torch.clamp_min(torch.where(torch.isfinite(b2), b2, 0.0), 0.0)
        retire = unassigned & (b1 < 0)
        r2c = torch.where(retire, -3, r2c)
        bidding = unassigned & ~retire
        bid = torch.gather(prices, 1, jstar) + (b1 - second) + eps

        onehot = (col_ids == jstar[..., None]) & bidding[..., None]
        bids_rc = torch.where(onehot, bid[..., None], _NEG)
        col_best = bids_rc.amax(dim=1)
        col_winner = bids_rc.argmax(dim=1)
        has_bid = col_best > _NEG

        # scatter into one spare slot (index R) that is cut off: "drop" mode
        deth = torch.where(has_bid & (owner >= 0), owner, R)
        r2c = torch.cat([r2c, drop], 1).scatter(1, deth, -1)[:, :R]
        win = torch.where(has_bid, col_winner, R)
        r2c = torch.cat([r2c, drop], 1).scatter(1, win, col_ids.expand(S, C))[:, :R]
        prices = torch.where(has_bid, col_best, prices)
        owner = torch.where(has_bid, col_winner, owner)
        it += 1
    capped += (r2c == -1).any(dim=1).to(capped.dtype)
    return torch.where(r2c >= 0, r2c, -1).to(torch.int32)


def _check(cost, row_mask, col_mask, thresh, capped) -> None:
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
    for name, t, shape, dtype in tensors:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"masked_assignment: {name} must be {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != cost.device:
            raise ValueError(f"masked_assignment: {name} is on {t.device}, cost on {cost.device}")
    if not all(t.is_contiguous() for _, t, _, _ in tensors) or not cost.is_contiguous():
        raise ValueError("masked_assignment: inputs must be contiguous")


def masked_assignment(cost, row_mask, col_mask, thresh, capped,
                      max_iters: int = 4000):
    """Solve S masked assignments: cost (S, R, C), masks (S, R)/(S, C).

    Pairs with cost >= thresh never match.  Returns r2c (S, R) int32 and
    adds to ``capped`` (S,) int32 in place; kernel K2 on a CUDA tensor.
    """
    _check(cost, row_mask, col_mask, thresh, capped)
    if cost.device.type == "cpu":
        return masked_assignment_plain(cost, row_mask, col_mask, thresh, capped, max_iters)
    if cost.device.type != "cuda":
        raise ValueError(f"masked_assignment: unsupported device {cost.device}")
    S, R, C = cost.shape
    fn = build.entry("auction", "bmt_auction", [_P] * 7 + [ctypes.c_int] * 4 + [_P])
    with torch.cuda.device(cost.device):
        if not torch.is_tensor(thresh):
            thresh = torch.full((S,), thresh, dtype=torch.float32, device=cost.device)
        w_scratch = torch.empty((S, C, R), dtype=torch.float32, device=cost.device)
        r2c = torch.empty((S, R), dtype=torch.int32, device=cost.device)
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        rc = fn(cost.data_ptr(), row_mask.data_ptr(), col_mask.data_ptr(), w_scratch.data_ptr(),
                r2c.data_ptr(), capped.data_ptr(), thresh.data_ptr(), S, R, C, max_iters, stream)
    build.check_launch("auction", "bmt_auction", rc)
    masked_assignment.launches += 1
    return r2c


masked_assignment.launches = 0
