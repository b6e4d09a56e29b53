"""The port's masked auction (boxmot_tpu_torch.ops.lap) against the JAX solver.

The plain twin keeps the JAX formulation exactly (one eps round, implicit
dummy per row, the same tie rules), so its row-to-column result must be
identical to ``boxmot_tpu.ops.lap.masked_assignment`` on every problem,
and to the exact ``linear_assignment_np`` oracle where the optimum has no
ties.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxmot_tpu.ops.lap import linear_assignment_np
from boxmot_tpu.ops.lap import masked_assignment as jax_masked_assignment
from boxmot_tpu_torch.ops.lap import MAX_COLS, MAX_ROWS, masked_assignment, masked_assignment_plain
from chip_smoke import NONFINITE, nonfinite_costs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def _problem(kind, S, R, C, seed):
    """Cost (S, R, C) and masks; 'sparse' mimics an IoU cost (most pairs at
    1.0), 'ties' quantises to eighths so many bids tie exactly."""
    rng = np.random.default_rng(seed)
    if kind == "sparse":
        near = rng.uniform(size=(S, R, C)) < 8.0 / C
        cost = np.where(near, rng.uniform(0, 1, (S, R, C)), 1.0)
    elif kind == "ties":
        near = rng.uniform(size=(S, R, C)) < 8.0 / C
        cost = np.where(near, np.round(rng.uniform(0, 1, (S, R, C)) * 8) / 8, 1.0)
    else:
        cost = rng.uniform(0, 1, (S, R, C))
    row_mask = rng.uniform(size=(S, R)) < 0.8
    col_mask = rng.uniform(size=(S, C)) < 0.8
    if kind == "masked":
        row_mask[0] = False  # one all-masked problem
        col_mask[1, 1:] = False  # one single-column problem
    return cost.astype(np.float32), row_mask, col_mask


def _jax_r2c(cost, row_mask, col_mask, thresh):
    return np.stack([
        np.asarray(jax_masked_assignment(jnp.asarray(c), jnp.asarray(r), jnp.asarray(m), thresh))
        for c, r, m in zip(cost, row_mask, col_mask)
    ])


@pytest.mark.parametrize(
    "kind, R, C, thresh",
    [
        ("dense", 40, 24, 0.8),
        ("dense", 96, 64, 0.5),
        ("ties", 96, 64, 0.9),
        ("ties", 256, 256, 0.7),
        ("sparse", 256, 128, 0.9),
        ("sparse", 256, 256, 0.8),
        ("masked", 64, 48, 0.8),
    ],
)
def test_twin_r2c_identical_to_jax(kind, R, C, thresh):
    S = 3
    cost, rm, cm = _problem(kind, S, R, C, seed=R * C + int(thresh * 10))
    capped = torch.zeros(S, dtype=torch.int32)
    got = masked_assignment(torch.from_numpy(cost), torch.from_numpy(rm), torch.from_numpy(cm),
                            thresh, capped).numpy()
    np.testing.assert_array_equal(got, _jax_r2c(cost, rm, cm, thresh))
    assert got.dtype == np.int32
    assert capped.tolist() == [0] * S


@pytest.mark.parametrize("label", list(NONFINITE))
def test_twin_r2c_identical_to_jax_on_nonfinite_costs(label):
    """NaN and +inf costs never match; a -inf cost is an infinite weight and
    runs the auction to its cap, where the twin returns JAX's partial
    assignment."""
    cost, rm, cm = nonfinite_costs(np.random.default_rng(len(label)), NONFINITE[label])
    capped = torch.zeros(cost.shape[0], dtype=torch.int32)
    got = masked_assignment(torch.from_numpy(cost), torch.from_numpy(rm), torch.from_numpy(cm),
                            0.8, capped).numpy()
    np.testing.assert_array_equal(got, _jax_r2c(cost, rm, cm, 0.8))
    assert (capped > 0).any() == ("-inf" in label)


@pytest.mark.parametrize("R, C", [(12, 9), (30, 30), (60, 25)])
def test_twin_matches_exact_oracle_without_ties(R, C):
    rng = np.random.default_rng(R + C)
    cost = rng.uniform(0, 1, (1, R, C)).astype(np.float32)
    thresh = 0.7
    got = masked_assignment_plain(torch.from_numpy(cost), torch.ones(1, R, dtype=torch.bool),
                                  torch.ones(1, C, dtype=torch.bool), thresh,
                                  torch.zeros(1, dtype=torch.int32))[0].numpy()
    matches, _, _ = linear_assignment_np(cost[0], thresh)
    want = np.full(R, -1)
    want[matches[:, 0]] = matches[:, 1]
    np.testing.assert_array_equal(got, want)


def test_iteration_cap_is_counted():
    cost, rm, cm = _problem("dense", 2, 40, 24, seed=5)
    capped = torch.ones(2, dtype=torch.int32)
    masked_assignment(torch.from_numpy(cost), torch.from_numpy(rm), torch.from_numpy(cm),
                      0.8, capped, max_iters=3)
    assert capped.tolist() == [2, 2]  # added to what was there


def test_wrapper_guards():
    S, R, C = 1, 4, 3
    ok = dict(cost=torch.zeros(S, R, C), row_mask=torch.ones(S, R, dtype=torch.bool),
              col_mask=torch.ones(S, C, dtype=torch.bool), capped=torch.zeros(S, dtype=torch.int32))
    before = masked_assignment.launches
    masked_assignment(thresh=0.5, **ok)
    assert masked_assignment.launches == before  # a CPU tensor never reaches the kernel
    too_many_rows = dict(ok, cost=torch.zeros(S, MAX_ROWS + 1, C),
                         row_mask=torch.ones(S, MAX_ROWS + 1, dtype=torch.bool))
    too_many_cols = dict(ok, cost=torch.zeros(S, R, MAX_COLS + 1),
                         col_mask=torch.ones(S, MAX_COLS + 1, dtype=torch.bool))
    for too_big in (too_many_rows, too_many_cols):
        with pytest.raises(ValueError, match="at most"):
            masked_assignment(thresh=0.5, **too_big)
    masked_assignment(thresh=0.5, **dict(ok, cost=torch.zeros(S, R, MAX_COLS),
                                         col_mask=torch.ones(S, MAX_COLS, dtype=torch.bool)))
    with pytest.raises(ValueError, match="capped"):
        masked_assignment(thresh=0.5, **dict(ok, capped=torch.zeros(S, dtype=torch.int64)))
    with pytest.raises(ValueError, match="float32"):
        masked_assignment(thresh=0.5, **dict(ok, cost=ok["cost"].double()))


# ---------------------------------------------------------------------------
# Kernel K2's rounds (csrc/auction.cu), modelled on the CPU in float32 numpy
# ---------------------------------------------------------------------------

_F32 = np.float32
_NO_ARG = 0x7FFFFFFF


def _bid_keys(bid, rows):
    """The kernel's 64-bit column keys: the bid's order-preserving bits in the
    high half, ~row in the low half."""
    u = bid.astype(_F32).view(np.uint32)
    u = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)
    return (u << np.uint64(32)) | (~rows.astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)


def _warp_scan(v, C):
    """(b1, arg, b2) of each row of v (n, C), as a warp computes them: lane l
    scans columns l, l + 32, ... with strict compares, then a shuffle
    butterfly merges the lanes, ties to the lowest column."""
    n = len(v)
    steps = -(-C // 32)
    lanes = np.arange(32)
    padded = np.full((n, steps * 32), -np.inf, _F32)
    padded[:, :C] = v
    padded = padded.reshape(n, steps, 32)
    b1 = np.full((n, 32), -np.inf, _F32)
    b2 = np.full((n, 32), -np.inf, _F32)
    arg = np.broadcast_to(np.where(lanes < C, lanes, _NO_ARG), (n, 32)).copy()
    for k in range(steps):
        x = padded[:, k]
        gt1 = x > b1
        gt2 = ~gt1 & (x > b2)
        b2 = np.where(gt1, b1, np.where(gt2, x, b2))
        b1 = np.where(gt1, x, b1)
        arg = np.where(gt1, k * 32 + lanes, arg)
    for off in (16, 8, 4, 2, 1):
        o1, o2, oa = b1[:, lanes ^ off], b2[:, lanes ^ off], arg[:, lanes ^ off]
        up, down = o1 > b1, o1 < b1
        b2 = np.where(up, np.maximum(o2, b1), np.where(down, np.maximum(b2, o1), b1))
        arg = np.where(up, oa, np.where(down, arg, np.minimum(arg, oa)))
        b1 = np.where(up, o1, b1)
    assert (b1 == b1[:, :1]).all() and (arg == arg[:, :1]).all()  # every lane agrees
    return b1[:, 0], arg[:, 0], b2[:, 0]


def _k2_model(cost, row_mask, col_mask, thresh, max_iters=4000):
    """One problem through the kernel's rounds; (r2c, capped, iterations,
    rows scanned)."""
    R, C = cost.shape
    w = _F32(thresh) - cost
    w = np.where(row_mask[:, None] & col_mask[None, :] & (w > 0), w, -np.inf).astype(_F32)
    finite = w[np.isfinite(w)]
    w_max = max(_F32(0), finite.max()) if finite.size else _F32(0)
    eps = max(w_max, _F32(1e-2)) * _F32(1e-4)
    prices = np.zeros(C, _F32)
    owner = np.full(C, -1)
    r2c = np.where(row_mask, -1, -2)
    it = scanned = 0
    while True:
        pending = np.flatnonzero(r2c == -1)
        if not len(pending) or it >= max_iters:
            break
        scanned += len(pending)
        b1, arg, b2 = _warp_scan(w[pending] - prices, C)
        second = np.maximum(np.where(np.isfinite(b2), b2, _F32(0)), _F32(0))
        retire = b1 < 0
        r2c[pending[retire]] = -3
        rows, arg, b1, second = pending[~retire], arg[~retire], b1[~retire], second[~retire]
        bid = (prices[arg] + (b1 - second)) + eps
        keys = np.zeros(C, np.uint64)
        np.maximum.at(keys, arg, _bid_keys(bid, rows))  # the shared-memory atomicMax
        bid_of = dict(zip(rows.tolist(), bid))
        for j in np.flatnonzero(keys):
            win = 0xFFFFFFFF - int(keys[j] & np.uint64(0xFFFFFFFF))  # ~row as uint32
            if owner[j] >= 0:
                r2c[owner[j]] = -1
            r2c[win], owner[j], prices[j] = j, win, bid_of[win]
        it += 1
    return np.where(r2c >= 0, r2c, -1), int(len(pending) > 0), it, scanned


@pytest.mark.parametrize(
    "kind, R, C, thresh",
    [
        ("dense", 40, 24, 0.8),
        ("dense", 96, 64, 0.5),
        ("dense", 256, 128, 0.8),
        ("ties", 96, 64, 0.9),
        ("ties", 256, 256, 0.7),
        ("ties", 256, 512, 0.8),
        ("sparse", 256, 128, 0.9),
        ("sparse", 256, 512, 0.8),
        ("masked", 64, 48, 0.8),
        ("masked", 256, 300, 0.8),
    ],
)
def test_k2_rounds_model_r2c_identical_to_twin(kind, R, C, thresh):
    """The kernel's rounds (warp scan with shuffle merge, packed-key column
    winners, one-pass dethrone and install) give the twin's r2c, capped
    flag, and per-problem iterations and rows scanned."""
    S = 2
    cost, rm, cm = _problem(kind, S, R, C, seed=R + C + int(thresh * 10))
    capped = torch.zeros(S, dtype=torch.int32)
    work = torch.zeros((S, 2), dtype=torch.int32)
    want = masked_assignment(torch.from_numpy(cost), torch.from_numpy(rm), torch.from_numpy(cm),
                             thresh, capped, work=work).numpy()
    for s in range(S):
        r2c, cap, it, scanned = _k2_model(cost[s], rm[s], cm[s], thresh)
        np.testing.assert_array_equal(r2c, want[s])
        assert [cap, it, scanned] == [int(capped[s])] + work[s].tolist()
    assert (want >= 0).sum() > 0


def test_k2_model_counts_the_cap_and_column_ties():
    """Equal bids on one column go to the lowest row; the cap is counted."""
    cost = np.full((3, 3), 0.25, _F32)  # every row bids the same on column 0
    rm, cm = np.ones(3, bool), np.ones(3, bool)
    r2c, cap, it, _ = _k2_model(cost, rm, cm, 0.8)
    want = masked_assignment_plain(torch.from_numpy(cost[None]), torch.from_numpy(rm[None]),
                                   torch.from_numpy(cm[None]), 0.8,
                                   torch.zeros(1, dtype=torch.int32))[0].numpy()
    np.testing.assert_array_equal(r2c, want)
    assert sorted(r2c) == [0, 1, 2] and cap == 0
    r2c, cap, it, _ = _k2_model(*(a[0] for a in _problem("dense", 1, 40, 24, seed=5)), 0.8,
                                max_iters=3)
    assert (cap, it) == (1, 3)
