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
from boxmot_tpu_torch.ops.geometry import obb_corners
from boxmot_tpu_torch.ops.lap import masked_assignment, masked_assignment_plain, uses_shared_weights
from boxmot_tpu_torch.ops.rotated_iou import rotated_iou, rotated_iou_counted, rotated_iou_plain
from chip_smoke import crossed_quads

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


# (256, 128) and (100, 300) keep w in shared memory; (256, 256) and (256, 512)
# read the cost from global memory
AUCTION_SHAPES = [(256, 128), (256, 256), (7, 3), (256, 512), (100, 300)]


def test_auction_shapes_cover_both_paths():
    assert {uses_shared_weights(R, C) for R, C in AUCTION_SHAPES} == {True, False}
    assert uses_shared_weights(256, 128) and not uses_shared_weights(256, 512)


@pytest.mark.parametrize("kind", ["dense", "ties", "sparse", "masked"])
@pytest.mark.parametrize("R, C", AUCTION_SHAPES)
def test_auction_kernel_r2c_identical_to_twin(card, kind, R, C):
    rng = np.random.default_rng(R * C)
    cost, rm, cm = (torch.from_numpy(a).to(card) for a in _problem(rng, kind, 4, R, C))
    caps = [torch.zeros(4, dtype=torch.int32, device=card) for _ in range(2)]
    work = [torch.full((4, 2), 7, dtype=torch.int32, device=card) for _ in range(2)]
    before = masked_assignment.launches
    got = masked_assignment(cost, rm, cm, 0.8, caps[0], work=work[0])
    want = masked_assignment_plain(cost, rm, cm, 0.8, caps[1], work=work[1].zero_())
    torch.cuda.synchronize()
    assert masked_assignment.launches == before + 1
    assert torch.equal(got, want) and torch.equal(caps[0], caps[1])
    assert torch.equal(work[0], work[1]) and int(work[0][:, 0].max()) > 0


def test_auction_kernel_counts_the_iteration_cap(card):
    rng = np.random.default_rng(1)
    cost, rm, cm = (torch.from_numpy(a).to(card) for a in _problem(rng, "dense", 2, 40, 24))
    capped = torch.ones(2, dtype=torch.int32, device=card)
    masked_assignment(cost, rm, cm, 0.8, capped, max_iters=3)
    assert capped.tolist() == [2, 2]


def test_auction_kernel_per_problem_thresholds(card):
    rng = np.random.default_rng(2)
    cost, rm, cm = (torch.from_numpy(a).to(card) for a in _problem(rng, "sparse", 3, 64, 40))
    thresh = torch.tensor([0.3, 0.67, 0.9], device=card)
    caps = [torch.zeros(3, dtype=torch.int32, device=card) for _ in range(2)]
    got = masked_assignment(cost, rm, cm, thresh, caps[0])
    want = masked_assignment_plain(cost, rm, cm, thresh, caps[1])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _obbs(rng, S, n):
    """Rotated boxes near each other, with zero-area, padding, identical,
    sliver and quarter-turned boxes mixed in."""
    b = np.zeros((S, n, 5), np.float32)
    b[..., :2] = rng.uniform(0, 600, (S, n, 2))
    b[..., 2:4] = rng.uniform(2, 200, (S, n, 2))
    b[..., 4] = rng.uniform(-np.pi, np.pi, (S, n))
    b[:, 0::9] = 0.0  # empty slot
    b[:, 1::9] = [0.0, 0.0, 1.0, 1.0, 0.0]  # padding detection
    b[:, 2::9, 2] = 1e-3  # sliver
    b[:, 3::9, 4] = np.pi / 2
    return b


@pytest.mark.parametrize("S, N, M", [(8, 256, 128), (1, 1, 3), (2, 200, 77), (1, 130, 513)])
def test_rotated_iou_kernel_bit_equal_to_twin(card, S, N, M):
    rng = np.random.default_rng(N + M)
    a, b = _obbs(rng, S, N), _obbs(rng, S, M)
    k = min(N, M) // 2
    b[:, :k] = a[:, :k] + rng.normal(0, 3, (S, k, 5)).astype(np.float32)
    a, b = torch.from_numpy(a).to(card), torch.from_numpy(b).to(card)
    c1, c2 = obb_corners(a).contiguous(), obb_corners(b).contiguous()
    before = rotated_iou.launches
    got = rotated_iou(a, b, c1, c2)
    want = rotated_iou_plain(a, b, c1, c2)
    torch.cuda.synchronize()
    assert rotated_iou.launches == before + 1
    assert torch.equal(got, want)


def test_rotated_iou_kernel_slow_path_bit_equal_to_twin(card):
    """Crossed quadrilaterals overflow the register fast path; the pairs the
    kernel recomputes on its slow path keep the twin's bits, and the counting
    instantiation gives the timed kernel's output."""
    rng = np.random.default_rng(23)
    (a, c1), (b, c2) = crossed_quads(rng, 200), crossed_quads(rng, 300)
    a, b, c1, c2 = (torch.from_numpy(x)[None].to(card) for x in (a, b, c1, c2))
    got = rotated_iou(a, b, c1, c2)
    counted, ops, slow = rotated_iou_counted(a, b, c1, c2)
    want = rotated_iou_plain(a, b, c1, c2)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(counted, want)
    assert slow > 0 and int(ops.min()) > 0
