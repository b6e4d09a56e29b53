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
