# Frozen copy of boxmot_tpu_torch/ops/lap.py at commit 78364f93b578: the plain
# (twin) path only, on every device; no kernel, no tracker shell.
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


import numpy as np
import torch

from portbench.reference import auction


MAX_ROWS = 256  # rows one thread block holds: one thread each
MAX_COLS = 512  # columns one thread block holds
# the most dynamic shared memory the kernel is given for the weights; the
# wrapper picks its path by this (uses_shared_weights) and passes the choice
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
    """The twin's assignment over the rows and columns valid in some
    problem (a row or column valid in none never bids and never wins, as
    ``_plain_on_valid_rows`` says of rows), solved on the host by the NumPy
    port of ``masked_assignment_plain`` (``portbench/reference/auction.py``):
    its loop reads a flag an iteration, a wait for the card on every one if
    it ran there; a problem left at the iteration cap gets the exact
    matching instead (``auction.exact``), still counted in ``capped``.  r2c,
    ``capped`` and ``work`` on the device of ``cost``."""
    _check(cost, row_mask, col_mask, thresh, capped, work)
    S, R, C = cost.shape
    rows = row_mask.any(dim=0).nonzero()[:, 0].cpu()
    cols = col_mask.any(dim=0).nonzero()[:, 0].cpu()
    r2c = torch.full((S, R), -1, dtype=torch.int32)
    got = torch.zeros((S, 2), dtype=torch.int32)
    if len(rows) and len(cols):
        th = thresh.cpu().numpy() if torch.is_tensor(thresh) else float(thresh)
        args = (cost.cpu()[:, rows][:, :, cols].numpy(), row_mask.cpu()[:, rows].numpy(),
                col_mask.cpu()[:, cols].numpy())
        sub, cap, got_np = auction.solve(*args, th, max_iters)
        for s in np.nonzero(cap)[0]:
            sub[s] = auction.exact(*(a[s] for a in args), th[s] if np.ndim(th) else th)
        sub = torch.from_numpy(sub).long()
        r2c[:, rows] = torch.where(sub >= 0, cols[sub.clamp_min(0)], -1).to(torch.int32)
        capped += torch.from_numpy(cap).to(capped.device)
        got = torch.from_numpy(got_np)
    elif len(rows):  # no column: every valid row retires in the first iteration
        pending = row_mask.cpu()
        got = torch.stack([pending.any(dim=1), pending.sum(dim=1)], 1).to(torch.int32)
    if work is not None:
        work.copy_(got)
    return r2c.to(cost.device)


masked_assignment.launches = 0


