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

from boxmot_tpu_torch.detectors.yolo_lite import MAX_OUT, LiteYOLO
from boxmot_tpu_torch.ops.crops import extract_crops, extract_crops_plain, launch_crops
from boxmot_tpu_torch.ops.fused_iou_cost import IOU_BATCH_EPS, fused_iou_cost, fused_iou_cost_plain
from boxmot_tpu_torch.ops.geometry import exact, obb_corners
from boxmot_tpu_torch.ops.lap import masked_assignment, masked_assignment_plain, uses_shared_weights
from boxmot_tpu_torch.ops.nms import batched_class_nms, nms, nms_plain
from boxmot_tpu_torch.ops.oru import oru_replay, oru_replay_plain
from boxmot_tpu_torch.ops.rotated_iou import rotated_iou, rotated_iou_counted, rotated_iou_plain
from chip_smoke import (
    NONFINITE,
    ORU_EDGES,
    XYSCR_EDGES,
    _nonfinite_boxes,
    _tiny_boxes,
    crop_boxes,
    crop_edge_boxes,
    crop_frame,
    crossed_quads,
    lite_nms_inputs,
    nms_boxes,
    nms_edge_sets,
    nonfinite_costs,
    same_or_both_nan,
    oru_edge_inputs,
    oru_inputs,
)

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


# (1, 1, 3) and (3, 200, 77) take the scalar stores (D % 4 != 0)
@pytest.mark.parametrize("iou_only", [False, True], ids=["iou+cost", "iou-only"])
@pytest.mark.parametrize("S, K, D", [(8, 256, 128), (1, 1, 3), (3, 200, 77), (2, 256, 256),
                                     (2, 256, 512)])
def test_fused_iou_cost_kernel_bit_equal_to_twin(card, S, K, D, iou_only):
    rng = np.random.default_rng(K + D)
    trk, det = _boxes(rng, S, K), _boxes(rng, S, D)
    det[:, : D // 2] = trk[:, :1] + rng.uniform(-30, 30, (S, D // 2, 4))
    conf = rng.uniform(0.05, 1.0, (S, D)).astype(np.float32)
    args = [torch.from_numpy(a).to(card) for a in (trk, det, conf)]
    if iou_only:
        args[2] = None
    before = fused_iou_cost.launches
    iou, cost = fused_iou_cost(*args)
    ref_iou, ref_cost = fused_iou_cost_plain(*args)
    torch.cuda.synchronize()
    assert fused_iou_cost.launches == before + 1
    assert torch.equal(iou, ref_iou)
    assert (cost is None) if iou_only else torch.equal(cost, ref_cost)


def test_fused_iou_cost_kernel_unaligned_conf(card):
    """Confidences that start 4 bytes past a 16-byte boundary take the scalar
    loads and stores, bit-equal to the twin."""
    rng = np.random.default_rng(5)
    trk, det = (torch.from_numpy(_boxes(rng, 8, n)).to(card) for n in (256, 128))
    conf = torch.empty(8 * 128 + 1, device=card)[1:].view(8, 128)
    conf.copy_(torch.from_numpy(rng.uniform(0.05, 1.0, (8, 128)).astype(np.float32)))
    iou, cost = fused_iou_cost(trk, det, conf)
    ref_iou, ref_cost = fused_iou_cost_plain(trk, det, conf)
    torch.cuda.synchronize()
    assert conf.data_ptr() % 16 == 4
    assert torch.equal(iou, ref_iou) and torch.equal(cost, ref_cost)


@pytest.mark.parametrize("eps", [1e-9, IOU_BATCH_EPS], ids=["tpu-clamp", "iou-batch-clamp"])
def test_fused_iou_cost_kernel_union_clamp(card, eps):
    """On boxes whose unions lie below 1e-9 the two clamps give other IoUs;
    the kernel takes the clamp as an argument, bit-equal to the twin."""
    trk, det = (torch.from_numpy(a).to(card) for a in _tiny_boxes(2, 8, 12))
    conf = torch.full((2, 12), 0.5, device=card)
    for args in ((trk, det), (trk, det, conf)):
        got, want = fused_iou_cost(*args, eps=eps), fused_iou_cost_plain(*args, eps=eps)
        torch.cuda.synchronize()
        assert all(g is w or torch.equal(g, w) for g, w in zip(got, want))
    assert (float(got[0][0, 0, 0]) == 1.0) == (eps == IOU_BATCH_EPS)


@pytest.mark.parametrize("obb", [False, True], ids=["aabb", "obb"])
@pytest.mark.parametrize("S, K, p_rejoin, gap_max", [(8, 256, 1.0, 31), (3, 77, 0.5, 40),
                                                     (1, 1, 1.0, 31)])
def test_oru_kernel_bit_equal_to_twin_on_the_cpu(card, obb, S, K, p_rejoin, gap_max):
    """K4's replay equals its twin run on the CPU bit for bit: every slot
    rejoining with gaps 2-31, half of them with gaps past MAX_ORU, one slot."""
    rng = np.random.default_rng(S * K + obb)
    layout, tensors, rejoin, gap = oru_inputs(rng, S, K, obb, p_rejoin, gap_max)
    replayed = [torch.zeros(S, dtype=torch.int32, device=d) for d in (card, "cpu")]
    before = oru_replay.launches
    got = oru_replay(layout, *(t.to(card) for t in (*tensors, rejoin, gap)), replayed[0])
    want = oru_replay_plain(layout, *tensors, rejoin, gap, replayed[1])
    torch.cuda.synchronize()
    assert oru_replay.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert torch.equal(replayed[0].cpu(), replayed[1])
    assert int(replayed[1].sum()) == int(rejoin.sum())


@pytest.mark.parametrize("edge, obb", ORU_EDGES, ids=[f"{e}-{'obb' if o else 'aabb'}"
                                                     for e, o in ORU_EDGES])
def test_oru_kernel_edges_bit_equal_to_twin_on_the_cpu(card, edge, obb):
    """K4 on its edges, bit-equal to its twin on the CPU: no slot rejoining
    (every warp copies through), 5 x 13 slots (the last block part empty),
    gaps of exactly MAX_ORU and MAX_ORU + 1, and alignment candidates that
    tie (the first one wins, as jnp.argmin)."""
    rng = np.random.default_rng(len(edge) + obb)
    layout, tensors, rejoin, gap = oru_edge_inputs(rng, edge, obb)
    S = rejoin.shape[0]
    replayed = [torch.zeros(S, dtype=torch.int32, device=d) for d in (card, "cpu")]
    before = oru_replay.launches
    got = oru_replay(layout, *(t.to(card) for t in (*tensors, rejoin, gap)), replayed[0])
    want = oru_replay_plain(layout, *tensors, rejoin, gap, replayed[1])
    torch.cuda.synchronize()
    assert oru_replay.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert torch.equal(replayed[0].cpu(), replayed[1])
    if edge == "no slot rejoins":
        assert torch.equal(got[0].cpu(), tensors[0]) and torch.equal(got[1].cpu(), tensors[1])


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


@pytest.mark.parametrize("label", list(NONFINITE))
def test_auction_kernel_on_nonfinite_costs_identical_to_twin(card, label):
    """NaN, +inf and -inf costs: r2c and capped as the twin's, on both of
    K2's paths."""
    for seed, (R, C) in enumerate(((20, 16), (256, 512))):
        cost, rm, cm = (torch.from_numpy(a).to(card) for a in nonfinite_costs(
            np.random.default_rng(seed), NONFINITE[label], R=R, C=C))
        caps = [torch.zeros(2, dtype=torch.int32, device=card) for _ in range(2)]
        got = masked_assignment(cost, rm, cm, 0.8, caps[0])
        want = masked_assignment_plain(cost, rm, cm, 0.8, caps[1])
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(caps[0], caps[1])


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


def _recorded(card, tracker, module, name, obb=False):
    """The arguments of every ``name`` launch of 12 steps of ``tracker`` (the
    YAML thresholds, capacity 256) on the card: the appearance scene at the
    bench's detection bucket (embeddings and warps; 5 % of detections missed
    so that DeepOCSORT's and HybridSORT's tracks rejoin), or turning rotated
    boxes for OBB."""
    from boxmot_tpu_torch.engine.eval import build_replay_config
    from boxmot_tpu_torch.engine.replay import batch_replay, init_states, pack_frames
    from boxmot_tpu_torch.utils import measure
    from chip_smoke import appearance_batch, synthetic_obb_frames

    cfg = build_replay_config(tracker, capacity=256, **({"is_obb": True} if obb else {}))
    if obb:
        packed = [pack_frames(synthetic_obb_frames(12, 100, seed=s, miss=0.05), D=128, F=12,
                              det_cols=7)[0] for s in range(2)]
        batch, embs, warps = torch.from_numpy(np.stack(packed)).to(card), None, None
    else:
        batch, embs, warps = appearance_batch(2, 12, 100, 3, 0.05, card)
    with measure.record_calls(module, [name]) as rec:
        batch_replay(cfg, init_states(cfg, 2, card), batch, None, embs, warps)
    return rec[name]


@pytest.mark.parametrize("obb", [False, True], ids=["aabb-k1", "obb-k3"])
def test_iou_kernels_on_botsort_steps_bit_equal_to_twin(card, obb):
    """K1 (both of its modes) and K3 at the inputs BoT-SORT's steps give them."""
    from boxmot_tpu_torch.trackers import botsort

    name = "rotated_iou" if obb else "fused_iou_cost"
    calls = _recorded(card, "botsort", botsort, name, obb)
    assert len(calls) == 24  # association and duplicate suppression, every step
    for args, kwargs in calls:
        if obb:
            a, b = args[0], args[1]
            c1, c2 = (args[2], args[3]) if len(args) > 2 else (obb_corners(a).contiguous(),
                                                                obb_corners(b).contiguous())
            got, want = rotated_iou(a, b, c1, c2), rotated_iou_plain(a, b, c1, c2)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        else:
            got, want = fused_iou_cost(*args, **kwargs), fused_iou_cost_plain(*args, **kwargs)
            torch.cuda.synchronize()
            assert all(g is w or torch.equal(g, w) for g, w in zip(got, want))


def test_oru_kernel_on_deepocsort_steps_bit_equal_to_twin_on_the_cpu(card):
    """K4 at the inputs DeepOCSORT's steps give it (the warped frozen state
    included), against its twin run on the CPU."""
    from boxmot_tpu_torch.trackers import deepocsort

    calls = _recorded(card, "deepocsort", deepocsort, "oru_replay")
    rejoined = 0
    for args, _ in calls:
        layout, tensors, rejoin, gap, replayed = args[0], args[1:7], args[7], args[8], args[9]
        got = oru_replay(layout, *tensors, rejoin, gap, replayed.clone())
        want = oru_replay_plain(layout, *(t.cpu() for t in (*tensors, rejoin, gap)),
                                replayed.cpu().clone())
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        rejoined += int(rejoin.sum())
    assert len(calls) == 12 and rejoined > 0


@pytest.mark.parametrize("obb", [False, True], ids=["aabb-k1", "obb-k3"])
def test_iou_kernels_on_occluboost_steps_bit_equal_to_twin(card, obb):
    """K1 (IoU-only) and K3 at the inputs OccluBoost's steps give them (the
    YAML tier with appearance): the association IoU and the duplicate
    suppression's, and for oriented boxes the tracks x detections IoU of the
    recovery and second passes."""
    from boxmot_tpu_torch.trackers import boosttrack, occluboost

    name = "rotated_iou" if obb else "fused_iou_cost"
    calls = _recorded(card, "occluboost", occluboost if obb else boosttrack, name, obb)
    assert len(calls) == (36 if obb else 24)
    for args, kwargs in calls:
        if obb:
            got, want = rotated_iou(*args), rotated_iou_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        else:
            got, want = fused_iou_cost(*args, **kwargs), fused_iou_cost_plain(*args, **kwargs)
            torch.cuda.synchronize()
            assert got[1] is None and torch.equal(got[0], want[0])


@pytest.mark.parametrize("S, K, p_rejoin, gap_max", [(8, 256, 1.0, 31), (3, 77, 0.5, 40),
                                                     (1, 1, 1.0, 31)])
def test_oru_kernel_xyscr_bit_equal_to_twin_on_the_cpu(card, S, K, p_rejoin, gap_max):
    """K4's XYSCR instance (HybridSORT's ORU) equals its twin run on the CPU
    bit for bit: every slot rejoining with gaps 2-31, half of them with gaps
    past MAX_ORU, one slot."""
    rng = np.random.default_rng(S * K + 2)
    layout, tensors, rejoin, gap = oru_inputs(rng, S, K, "xyscr", p_rejoin, gap_max)
    replayed = [torch.zeros(S, dtype=torch.int32, device=d) for d in (card, "cpu")]
    before = oru_replay.launches
    got = oru_replay(layout, *(t.to(card) for t in (*tensors, rejoin, gap)), replayed[0])
    want = oru_replay_plain(layout, *tensors, rejoin, gap, replayed[1])
    torch.cuda.synchronize()
    assert oru_replay.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert torch.equal(replayed[0].cpu(), replayed[1])


@pytest.mark.parametrize("edge", [e for e, _ in XYSCR_EDGES])
def test_oru_kernel_xyscr_edges_bit_equal_to_twin_on_the_cpu(card, edge):
    """K4's XYSCR instance on its edges: no slot rejoining, 5 x 13 slots,
    gaps of exactly MAX_ORU and MAX_ORU + 1."""
    rng = np.random.default_rng(len(edge) + 2)
    layout, tensors, rejoin, gap = oru_edge_inputs(rng, edge, "xyscr")
    replayed = [torch.zeros(rejoin.shape[0], dtype=torch.int32, device=d) for d in (card, "cpu")]
    got = oru_replay(layout, *(t.to(card) for t in (*tensors, rejoin, gap)), replayed[0])
    want = oru_replay_plain(layout, *tensors, rejoin, gap, replayed[1])
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert torch.equal(replayed[0].cpu(), replayed[1])


def test_oru_kernel_on_hybridsort_steps_bit_equal_to_twin_on_the_cpu(card):
    """K4's XYSCR instance at the inputs HybridSORT's steps give it (the YAML
    tier with appearance), against its twin run on the CPU."""
    from boxmot_tpu_torch.trackers import hybridsort

    calls = _recorded(card, "hybridsort", hybridsort, "oru_replay")
    rejoined = 0
    for args, _ in calls:
        layout, tensors, rejoin, gap, replayed = args[0], args[1:7], args[7], args[8], args[9]
        assert layout.name == "xyscr"
        got = oru_replay(layout, *tensors, rejoin, gap, replayed.clone())
        want = oru_replay_plain(layout, *(t.cpu() for t in (*tensors, rejoin, gap)),
                                replayed.cpu().clone())
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        rejoined += int(rejoin.sum())
    assert len(calls) == 12 and rejoined > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("obb", [False, True], ids=["aabb", "obb"])
@pytest.mark.parametrize("n, hw", [(64, (256, 128)), (3, (7, 5)), (300, (64, 32)),
                                   (256, (256, 128)), (16, (384, 128))])
def test_crops_kernel_bit_equal_to_twin(card, n, hw, obb, dtype):
    """K5 against its twin on the card and on the CPU: a textured 1080p frame,
    boxes past every edge, sub-pixel, unit padding boxes, angles of +-pi/2 and
    +-pi; ragged crop sizes (7 x 5: scalar stores), more crops than one
    facade chunk, 256 crops and (384, 128) outputs."""
    rng = np.random.default_rng(n + obb)
    frame = torch.from_numpy(crop_frame(n)).to(card)
    boxes = torch.from_numpy(crop_boxes(rng, n, obb)).to(card)
    got = extract_crops(frame, boxes, hw, obb, dtype)
    want = extract_crops_plain(frame, boxes, hw, obb, dtype)
    cpu = extract_crops_plain(frame.cpu(), boxes.cpu(), hw, obb, dtype)
    torch.cuda.synchronize()
    assert got.shape == (n, 3, *hw) and got.dtype == dtype
    assert torch.equal(got, want) and torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("obb", [False, True], ids=["aabb", "obb"])
def test_crops_kernel_edge_boxes_and_unaligned_output(card, obb, dtype):
    """One-pixel boxes at the frame's corners and last pixels, boxes partly
    outside it, on a frame view whose start is not 4-byte aligned; and the
    kernel writing into an output view whose start is not 16-byte aligned
    (the wrapper allocates its own, so ``launch_crops`` hands the view)."""
    frame = torch.from_numpy(crop_frame(5)).to(card)
    boxes = torch.from_numpy(crop_edge_boxes(obb)).to(card)
    for f in (frame, torch.cat([frame.new_zeros(1), frame.flatten()])[1:].view(frame.shape)):
        want = extract_crops_plain(f, boxes, (256, 128), obb, dtype)
        assert torch.equal(extract_crops(f, boxes, (256, 128), obb, dtype), want)
    assert f.data_ptr() % 4 != 0
    cols = 5 if obb else 4
    trig = (torch.stack([exact(torch.cos, boxes[:, 4]), exact(torch.sin, boxes[:, 4])]).contiguous()
            if obb else None)
    buf = torch.zeros(want.numel() + 1, dtype=dtype, device=card)
    out = buf[1:].view(want.shape)
    assert out.data_ptr() % 16 != 0
    launch_crops(frame, boxes[:, :cols].contiguous(), trig, out)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_crops_kernel_takes_an_empty_batch_and_counts_launches(card):
    frame = torch.from_numpy(crop_frame(0)).to(card)
    before = extract_crops.launches
    assert extract_crops(frame, torch.zeros((0, 4), device=card), (8, 4)).shape == (0, 3, 8, 4)
    assert extract_crops.launches == before
    extract_crops(frame, torch.tensor([[0.0, 0, 10, 10]], device=card), (8, 4))
    assert extract_crops.launches == before + 1


def test_reid_facade_on_the_card_equals_the_cpu(card, tmp_path):
    """The facade on the card (K5 and cuDNN, TF32 off) against the CPU port,
    fp32 features within 1e-4; bf16 at cosine >= 0.99 to fp32."""
    from boxmot_tpu_torch.reid import ReID
    from chip_smoke import reid_checkpoint

    weights = reid_checkpoint(tmp_path, "osnet_x0_25")
    img = crop_frame(7)
    boxes = crop_boxes(np.random.default_rng(7), 20, False)[8:]
    got = ReID(weights=weights, device=card).get_features(boxes, img)
    want = ReID(weights=weights, device="cpu").get_features(boxes, img)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    half = ReID(weights=weights, device=card, half=True).get_features(boxes, img)
    assert (half * got).sum(axis=1).min() >= 0.99


K6_SETS = nms_edge_sets(np.random.default_rng(7))


@pytest.mark.parametrize("case", K6_SETS, ids=[c[0] for c in K6_SETS])
def test_nms_kernel_bit_equal_to_twin_on_edge_sets(card, case):
    _, boxes, scores, classes, thresh, max_out = case
    b, s = torch.from_numpy(boxes).to(card), torch.from_numpy(scores).to(card)
    if classes is None:
        got = nms(b, s, thresh, max_out)
        want = nms_plain(b.cpu(), s.cpu(), thresh, max_out)
    else:
        c = torch.from_numpy(classes)
        got = batched_class_nms(b, s, c.to(card), thresh, max_out)
        want = batched_class_nms(b.cpu(), s.cpu(), c, thresh, max_out)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("max_out", [64, 256])
def test_nms_kernel_bit_equal_to_twin_at_yolox_width(card, max_out):
    """N = 23,625, the anchors of YOLOX at (800, 1440)."""
    boxes, scores = nms_boxes(np.random.default_rng(max_out), 23625)
    scores[::3] = -1.0  # below the detector's conf
    b, s = torch.from_numpy(boxes).to(card), torch.from_numpy(scores).to(card)
    counts = torch.zeros(1, dtype=torch.int64, device=card)
    got = nms(b, s, 0.7, max_out, counts=counts)
    want = nms_plain(b, s, 0.7, max_out)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].sum()) == max_out and int(counts) > 0


@pytest.mark.parametrize("variant", [{}, {"conf": 1.5}, {"agnostic": True}, {"classes": [1]}],
                         ids=["class-aware", "every-score-below-conf", "agnostic", "classes"])
def test_nms_kernel_bit_equal_to_twin_at_yololite_shape(card, variant):
    """The yololite predictor's NMS input on the card (256 anchors, max_out
    64, the class offset 512): K6 against its twin, and one kernel launch a
    predict call."""
    model = LiteYOLO("yololite-seg.pt", device=card)
    img = crop_frame(11)
    boxes, masked = lite_nms_inputs(model, img, **variant)
    assert boxes.shape == (256, 4) and boxes.device.type == "cuda"
    got, want = nms(boxes, masked, 0.7, MAX_OUT), nms_plain(boxes, masked, 0.7, MAX_OUT)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (int(got[1].sum()) == 0) == ("conf" in variant)
    before = nms.launches
    model(img, conf=0.05)
    assert nms.launches == before + 1


@pytest.mark.parametrize("iou_only", [False, True], ids=["iou+cost", "iou-only"])
def test_fused_iou_cost_kernel_keeps_nan_as_the_twin(card, iou_only):
    """NaN and infinite coordinates: the kernel's NaN IoUs are the twin's."""
    trk, det = _nonfinite_boxes(np.random.default_rng(4), 2, 64, 77)
    args = [torch.from_numpy(trk).to(card), torch.from_numpy(det).to(card)]
    if not iou_only:
        args.append(torch.from_numpy(np.random.default_rng(5).uniform(
            0.1, 1, (2, 77)).astype(np.float32)).to(card))
    got, want = fused_iou_cost(*args, eps=1e-12), fused_iou_cost_plain(*args, eps=1e-12)
    torch.cuda.synchronize()
    assert bool(torch.isnan(want[0]).any())
    for g, w in zip(got, want):
        assert g is w or same_or_both_nan(g, w)
