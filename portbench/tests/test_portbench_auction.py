"""The reference's NumPy auction gives the bits of the port's twin of kernel
K2 (``masked_assignment_plain``, frozen): assignments, caps and work, on
random, tied, thresholded and gated problems."""

import numpy as np
import pytest
import torch

from portbench.reference import auction
from portbench.reference.frozen.ops.lap import masked_assignment_plain


def _problems(seed):
    rng = np.random.default_rng(seed)
    S, R, C = 3, int(rng.integers(1, 70)), int(rng.integers(1, 70))
    cost = rng.random((S, R, C)).astype(np.float32)
    kind = seed % 4
    if kind == 1:  # ties: gated-out pairs all at one cost, as a tracker's full assignment
        cost = np.where(rng.random((S, R, C)) < 0.7, np.float32(1.0), -cost).astype(np.float32)
    elif kind == 2:  # coarse values: many equal bids
        cost = (np.round(cost * 4) / 4).astype(np.float32)
    rm = rng.random((S, R)) < 0.8
    cm = rng.random((S, C)) < 0.8
    thresh = (rng.random(S).astype(np.float32) + 0.5) if kind == 3 else 0.8
    if kind == 1:
        thresh = np.float32(1.02)
    return cost, rm, cm, thresh


@pytest.mark.parametrize("seed", range(16))
def test_numpy_auction_is_the_twin(seed):
    cost, rm, cm, thresh = _problems(seed)
    capped = torch.zeros(3, dtype=torch.int32)
    work = torch.zeros(3, 2, dtype=torch.int32)
    th = torch.from_numpy(thresh) if isinstance(thresh, np.ndarray) else float(thresh)
    want = masked_assignment_plain(torch.from_numpy(cost), torch.from_numpy(rm),
                                   torch.from_numpy(cm), th, capped, 300, work)
    got, cap, got_work = auction.solve(cost, rm, cm, thresh, 300)
    assert np.array_equal(got, want.numpy())
    assert np.array_equal(cap, capped.numpy()) and np.array_equal(got_work, work.numpy())


@pytest.mark.parametrize("seed", range(16, 28))
def test_frozen_assignment_over_valid_rows_and_columns_is_the_twin(seed):
    """The reference's ``masked_assignment`` (rows and columns valid in no
    problem left out, the NumPy auction) gives the twin's bits on every row
    of a problem that the auction finishes, and a best matching (ties may
    pick another) on one that it leaves at the cap."""
    from portbench.reference.frozen.ops.lap import masked_assignment

    cost, rm, cm, thresh = _problems(seed)
    rm[:, ::3] = False  # rows and columns valid in no problem
    cm[:, 1::4] = False
    if seed % 5 == 0:
        cm[:] = False
    th = torch.from_numpy(thresh) if isinstance(thresh, np.ndarray) else float(thresh)
    runs = []
    for fn in (masked_assignment_plain, masked_assignment):
        capped = torch.zeros(3, dtype=torch.int32)
        work = torch.zeros(3, 2, dtype=torch.int32)
        r2c = fn(torch.from_numpy(cost), torch.from_numpy(rm), torch.from_numpy(cm), th, capped,
                 300, work)
        runs.append((r2c, capped, work))
    (a, ca, wa), (b, cb, wb) = runs
    assert torch.equal(ca, cb) and torch.equal(wa, wb)
    for s in range(3):
        if not ca[s]:
            assert torch.equal(a[s], b[s])
            continue
        t = np.float64(thresh[s] if isinstance(thresh, np.ndarray) else thresh)
        w = np.where(rm[s][:, None] & cm[s][None, :], t - cost[s], 0.0)
        got = [(r, c) for r, c in enumerate(b[s].tolist()) if c >= 0]
        assert len({c for _, c in got}) == len(got) and all(w[r, c] > 0 for r, c in got)
        best = auction.exact(cost[s], rm[s], cm[s], thresh[s] if np.ndim(thresh) else thresh)
        assert np.isclose(sum(w[r, c] for r, c in got),
                          sum(w[r, c] for r, c in enumerate(best) if c >= 0))


def test_exact_is_the_best_matching():
    """``auction.exact`` finds the largest summed ``thresh - cost`` over the
    valid pairs under the threshold, as a search of every matching does."""
    import itertools

    rng = np.random.default_rng(3)
    for _ in range(20):
        cost = rng.random((4, 3)).astype(np.float32)
        rm, cm = rng.random(4) < 0.8, rng.random(3) < 0.8
        w = np.where(rm[:, None] & cm[None, :] & (cost < 0.7), 0.7 - cost.astype(np.float64), 0)
        best = max(sum(w[r, c] for r, c in zip(rows, range(3)) if r is not None)
                   for rows in itertools.permutations([0, 1, 2, 3, None, None, None], 3))
        r2c = auction.exact(cost, rm, cm, 0.7)
        assert all(w[r, c] > 0 for r, c in enumerate(r2c) if c >= 0)
        assert np.isclose(sum(w[r, c] for r, c in enumerate(r2c) if c >= 0), best)


def test_gated_problem_with_no_positive_pair_keeps_nothing():
    """The reference's one change to the frozen OccluBoost step: a gated
    problem with no positive valid pair returns no match without the
    auction, as the auction's answer filtered to positive pairs does."""
    from portbench.reference.frozen.trackers import occluboost, ocsort

    rng = np.random.default_rng(9)
    sim = torch.from_numpy(np.where(rng.random((2, 40, 30)) < 0.5, 0.0,
                                    -rng.random((2, 40, 30))).astype(np.float32))
    rm, cm = torch.from_numpy(rng.random((2, 40)) < 0.9), torch.from_numpy(rng.random((2, 30)) < 0.9)
    capped = torch.zeros(2, dtype=torch.int32)
    r2c = ocsort._full_assignment((-sim).contiguous(), rm, cm, capped)
    c = torch.clamp(r2c, 0, 29).long()
    full = torch.where((r2c >= 0) & (torch.gather(sim, 2, c[..., None])[..., 0] > 0), r2c, -1)
    got = occluboost._gated_lsa_max(sim, rm, cm, torch.zeros(2, dtype=torch.int32))
    assert torch.equal(got, full) and bool((got == -1).all())
