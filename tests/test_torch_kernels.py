"""The port's hand-written CUDA kernels against their plain PyTorch twins.

These tests need a CUDA card: a CUDA kernel has no CPU mode, so they skip
without one.  The file imports only torch, numpy and the port, so on a
machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_kernels.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from boxmot_tpu_torch.ops.fused_iou_cost import fused_iou_cost, fused_iou_cost_plain
from boxmot_tpu_torch.ops.lap import masked_assignment, masked_assignment_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _boxes(rng, S, n):
    b = np.zeros((S, n, 4), np.float32)
    b[..., :2] = rng.uniform(0, 1800, (S, n, 2))
    b[..., 2:] = b[..., :2] + rng.uniform(5, 200, (S, n, 2))
    b[:, 0::7] = 0.0  # empty slot
    b[:, 1::7] = [0.0, 0.0, 1.0, 1.0]  # padding detection
    b[:, 2::7, 2] = b[:, 2::7, 0]  # zero width
    return b


@pytest.mark.parametrize("S, K, D", [(8, 256, 128), (1, 1, 3), (3, 200, 77), (2, 256, 256)])
def test_fused_iou_cost_kernel_bit_equal_to_twin(card, S, K, D):
    rng = np.random.default_rng(K + D)
    trk, det = _boxes(rng, S, K), _boxes(rng, S, D)
    det[:, : D // 2] = trk[:, :1] + rng.uniform(-30, 30, (S, D // 2, 4))
    conf = rng.uniform(0.05, 1.0, (S, D)).astype(np.float32)
    args = [torch.from_numpy(a).to(card) for a in (trk, det, conf)]
    before = fused_iou_cost.launches
    iou, cost = fused_iou_cost(*args)
    ref_iou, ref_cost = fused_iou_cost_plain(*args)
    torch.cuda.synchronize()
    assert fused_iou_cost.launches == before + 1
    assert torch.equal(iou, ref_iou) and torch.equal(cost, ref_cost)


def _problem(rng, kind, S, R, C):
    if kind == "dense":
        cost = rng.uniform(0, 1, (S, R, C))
    else:
        near = rng.uniform(size=(S, R, C)) < 8.0 / C
        vals = rng.uniform(0, 1, (S, R, C))
        cost = np.where(near, np.round(vals * 8) / 8 if kind == "ties" else vals, 1.0)
    row_mask = rng.uniform(size=(S, R)) < 0.8
    col_mask = rng.uniform(size=(S, C)) < 0.8
    if kind == "masked":
        row_mask[0] = False
        col_mask[1, 1:] = False
    return cost.astype(np.float32), row_mask, col_mask


@pytest.mark.parametrize("kind", ["dense", "ties", "sparse", "masked"])
@pytest.mark.parametrize("R, C", [(256, 128), (256, 256), (7, 3)])
def test_auction_kernel_r2c_identical_to_twin(card, kind, R, C):
    rng = np.random.default_rng(R * C)
    cost, rm, cm = (torch.from_numpy(a).to(card) for a in _problem(rng, kind, 4, R, C))
    caps = [torch.zeros(4, dtype=torch.int32, device=card) for _ in range(2)]
    before = masked_assignment.launches
    got = masked_assignment(cost, rm, cm, 0.8, caps[0])
    want = masked_assignment_plain(cost, rm, cm, 0.8, caps[1])
    torch.cuda.synchronize()
    assert masked_assignment.launches == before + 1
    assert torch.equal(got, want) and torch.equal(caps[0], caps[1])


def test_auction_kernel_counts_the_iteration_cap(card):
    rng = np.random.default_rng(1)
    cost, rm, cm = (torch.from_numpy(a).to(card) for a in _problem(rng, "dense", 2, 40, 24))
    capped = torch.ones(2, dtype=torch.int32, device=card)
    masked_assignment(cost, rm, cm, 0.8, capped, max_iters=3)
    assert capped.tolist() == [2, 2]
