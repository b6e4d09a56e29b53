#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (boxmot_tpu_torch) once on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device report: torch's card name and nvidia-smi's name and power limit;
  2. build the three hand-written kernels from csrc/, one nvcc each, in
     parallel;
  3. each kernel against its plain PyTorch twin on the card, at the main
     paths' shapes and at ragged / tie-heavy / masked / degenerate ones: K2
     on both of its paths (w in shared memory, cost read from global memory),
     K3 also on crossed quadrilaterals that overflow its fast path;
     then each kernel timed on the inputs of one recorded bench step: its
     device time per launch (torch.profiler), its wrapper's time (CUDA
     events around one call), its twin's, and its bound counted from the
     work those inputs need; the OBB Kalman bank's bits on the card against
     the CPU;
  4. AABB evals: run_eval for ByteTrack and SFSORT on MOT17-mini and
     synth-long, held to the pinned HOTA/MOTA/IDF1, with their MOT rows
     held against the same evals on the CPU;
  5. OBB evals: run_eval_obb for ByteTrack and SFSORT on mmot-mini, held to
     the JAX package's values, with their tracks held against the CPU's;
  6. the live API: 50 frames of MOT17-04-FRCNN, the mmot-mini frames as
     (N, 7) detections, and frames of 300 detections, each against the same
     tracker on the CPU;
  7. replay throughput, AABB and OBB, at the bench shape (8 sequences x 256
     frames x 100 detections, D = 128, capacity 256), timed with CUDA events.
Every path of phases 4-7 runs with the launch counters set to 0 just before
it and read just after; each eval's frame loop runs under
torch.cuda.set_sync_debug_mode("error"), and where a step's launches are
fixed (ByteTrack: 2 IoU launches to 3 auctions; SFSORT: 1 rotated IoU to 2
auctions in OBB mode) the counts must keep that ratio, so no step fell back
to a twin.  The line before the last is {"kernels": [...]}, with each
kernel's launches summed over those paths; the last line is
{"ok": true, "device": {...}}.  Without a CUDA card it exits non-zero before
printing any result.
"""

from __future__ import annotations

import concurrent.futures
import configparser
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import boxmot_tpu_torch
from boxmot_tpu_torch.csrc import build
from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.eval_obb import mmot_obb_dets
from boxmot_tpu_torch.engine.replay import (
    batch_replay,
    init_states,
    pack_frames,
    replay_sequences_outputs,
)
from boxmot_tpu_torch.motion import kalman
from boxmot_tpu_torch.ops.fused_iou_cost import fused_iou_cost, fused_iou_cost_plain
from boxmot_tpu_torch.ops.geometry import obb_corners
from boxmot_tpu_torch.ops.lap import masked_assignment, masked_assignment_plain, uses_shared_weights
from boxmot_tpu_torch.ops.rotated_iou import rotated_iou, rotated_iou_counted, rotated_iou_plain
from boxmot_tpu_torch.trackers import bytetrack
from boxmot_tpu_torch.trackers.bytetrack import ByteTrackConfig
from boxmot_tpu_torch.utils import measure

ROOT = Path(__file__).resolve().parent
ASSETS = ROOT / "assets"
ROOTS = {"mot17_mini": ASSETS / "MOT17-mini" / "train", "synth_long": ASSETS / "synth-long" / "train"}
MMOT_ROOT = ASSETS / "mmot-mini" / "train"
LIVE_SEQ = ROOTS["mot17_mini"] / "MOT17-04-FRCNN"
# the ByteTrack and SFSORT pins of tests/test_pinned_metrics.py (a CPU test holds them equal)
PINNED = {
    ("mot17_mini", "bytetrack"): {"HOTA": 0.649859, "MOTA": 0.495283, "IDF1": 0.662461},
    ("mot17_mini", "sfsort"): {"HOTA": 0.654495, "MOTA": 0.497642, "IDF1": 0.664567},
    ("synth_long", "bytetrack"): {"HOTA": 0.952785, "MOTA": 0.996300, "IDF1": 0.968698},
    ("synth_long", "sfsort"): {"HOTA": 0.898791, "MOTA": 0.980762, "IDF1": 0.916468},
}
# the JAX package's run_eval_obb on mmot-mini (a CPU test holds them equal)
OBB_EVAL = {
    "bytetrack": {"HOTA": 0.604123, "MOTA": 0.662654, "IDF1": 0.671799},
    "sfsort": {"HOTA": 0.898815, "MOTA": 0.942670, "IDF1": 0.924151},
}
ATOL = 1e-4
K1_ATOL = 1e-6
# the port evaluates cos/sin/log/sqrt in float64 and rounds once, so a cuda
# run and a CPU run agree to the bit unless a float64 result lands within an
# ulp of a float32 rounding boundary; OBB boxes are held within 1e-2 px
OBB_BOX_TOL = 1e-2
# bench shape (bench.py): sequences x frames x detections, det bucket, capacity
N_SEQS, N_FRAMES, N_DETS, D_BENCH, CAPACITY = 8, 256, 100, 128, 256
KERNELS = {  # counter name -> (wrapper, source, the TPU kernel or JAX function it replaces)
    "fused_iou_cost": (fused_iou_cost, "iou_cost", "boxmot_tpu/ops/pallas_kernels.py:59"),
    "masked_assignment": (masked_assignment, "auction", "boxmot_tpu/ops/lap.py:37"),
    "rotated_iou": (rotated_iou, "rotated_iou", "boxmot_tpu/ops/pallas_rotated_iou.py:136"),
}
LAUNCHES = {name: 0 for name in KERNELS}  # summed over the driven paths


def synthetic_frames(n_frames, n_dets, seed=0):
    """Random-walk boxes on a 1080x1920 frame, as bench.py makes them."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, [1820, 880], (n_dets, 2))
    vel = rng.uniform(-3, 3, (n_dets, 2))
    size = rng.uniform(40, 120, (n_dets, 2))
    frames = []
    for f in range(n_frames):
        p = np.clip(pos + vel * f, 0, [1820, 980])
        conf = rng.uniform(0.5, 0.99, n_dets)
        frames.append(np.concatenate(
            [p, p + size, conf[:, None], np.zeros((n_dets, 1))], axis=1).astype(np.float32))
    return frames


def synthetic_obb_frames(n_frames, n_dets, seed=0, miss=0.05):
    """Random-walk rotated boxes [cx, cy, w, h, theta, conf, cls] on a
    1080x1920 frame: turning boxes with jittered centres, a spread of
    confidences (both ByteTrack passes, SFSORT's intermediate pass) and a
    share ``miss`` of the boxes missed in each frame."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([60, 60], [1860, 1020], (n_dets, 2))
    vel = rng.uniform(-3, 3, (n_dets, 2))
    size = rng.uniform(20, 120, (n_dets, 2))
    theta = rng.uniform(-np.pi, np.pi, n_dets)
    omega = rng.uniform(-0.03, 0.03, n_dets)
    frames = []
    for f in range(n_frames):
        p = np.clip(pos + vel * f + rng.normal(0, 1, (n_dets, 2)), 0, [1920, 1080])
        th = np.remainder(theta + omega * f + np.pi, 2 * np.pi) - np.pi
        conf = rng.uniform(0.2, 0.99, n_dets)
        keep = rng.uniform(size=n_dets) >= miss
        frames.append(np.concatenate([p, size, th[:, None], conf[:, None],
                                      np.zeros((n_dets, 1))], axis=1)[keep].astype(np.float32))
    return frames


def _boxes(rng, S, n):
    """Track/detection-like xyxy boxes with the step's edge cases mixed in."""
    b = np.zeros((S, n, 4), np.float32)
    b[..., :2] = rng.uniform(0, 1800, (S, n, 2))
    b[..., 2:] = b[..., :2] + rng.uniform(5, 200, (S, n, 2))
    b[:, 0::9] = 0.0  # empty slot
    b[:, 1::9] = [0.0, 0.0, 1.0, 1.0]  # padding detection
    b[:, 2::9, 2] = b[:, 2::9, 0]  # zero width
    return b


def k1_bound(S, K, D):
    """K1's least time: boxes and confidences read once, two (S, K, D)
    outputs written once; 15 operations a pair and 3 a box (its area)."""
    return measure.bound_ms(S * (16 * K + 20 * D) + 8 * S * K * D, 15 * S * K * D + 3 * S * (K + D))


def check_k1(rng, step_calls):
    worst = 0.0
    for S, K, D in ((8, 256, 128), (1, 1, 3), (2, 200, 77)):
        trk = _boxes(rng, S, K)
        det = _boxes(rng, S, D)
        det[:, : D // 2] = trk[:, :1] + rng.uniform(-30, 30, (S, D // 2, 4))
        conf = rng.uniform(0.05, 1.0, (S, D)).astype(np.float32)
        args = [torch.from_numpy(a).cuda() for a in (trk, det, conf)]
        iou, cost = fused_iou_cost(*args)
        ref_iou, ref_cost = fused_iou_cost_plain(*args)
        torch.cuda.synchronize()
        err = max(float((iou - ref_iou).abs().max()), float((cost - ref_cost).abs().max()))
        if not err <= K1_ATOL:
            raise AssertionError(f"K1 at S={S} K={K} D={D}: max abs err {err} > {K1_ATOL}")
        worst = max(worst, err)
        print(f"K1 S={S} K={K} D={D}: max abs err {err:.3g}, bit-equal "
              f"{torch.equal(iou, ref_iou) and torch.equal(cost, ref_cost)}")
    # times on the AABB bench step's own inputs (its two launches)
    rows = []
    for args, _ in step_calls["aabb"]["fused_iou_cost"]:
        S, K, D = args[0].shape[0], args[0].shape[1], args[1].shape[1]
        row = (measure.device_ms(lambda: fused_iou_cost(*args), "iou_cost_kernel"),
               measure.event_ms(lambda: fused_iou_cost(*args)),
               measure.event_ms(lambda: fused_iou_cost_plain(*args)), *k1_bound(S, K, D))
        print(f"K1 bench step (S, K, D) = {(S, K, D)}: device {row[0]:.5f} ms a launch, wrapper "
              f"{row[1]:.5f} ms, plain {row[2]:.5f} ms, bound {row[3]:.5f} ms ({row[4]})")
        rows.append(row)
    return timing(worst, rows)


def timing(worst, rows):
    """A kernel's entry of the kernels line, from its rows of (device ms,
    wrapper ms, plain ms, bound ms, bound_by) at the main path's launches:
    the mean per launch."""
    mean = [statistics.fmean(r[k] for r in rows) for k in range(4)]
    by = max(set(r[4] for r in rows), key=[r[4] for r in rows].count)
    return {"max_abs_err": worst, "ms": mean[0], "wrapper_ms": mean[1], "plain_ms": mean[2],
            "bound_ms": mean[3], "bound_by": by}


def _problem(rng, kind, S=8, R=256, C=128):
    if kind == "dense":
        cost = rng.uniform(0, 1, (S, R, C))
    else:  # IoU-like: most pairs at cost 1; "ties" quantises to eighths
        near = rng.uniform(size=(S, R, C)) < 8.0 / C
        vals = rng.uniform(0, 1, (S, R, C))
        cost = np.where(near, np.round(vals * 8) / 8 if kind == "ties" else vals, 1.0)
    row_mask = rng.uniform(size=(S, R)) < 0.8
    col_mask = rng.uniform(size=(S, C)) < 0.8
    if kind == "masked":
        row_mask[: S // 2] = False  # all-masked problems
        col_mask[S // 2:, 1:] = False  # single-column problems
    return [torch.from_numpy(a).cuda() for a in (cost.astype(np.float32), row_mask, col_mask)]


def k2_bound(cost, row_mask, work):
    """K2's least time for these inputs.  The answer depends on the cost only
    in rows the row mask keeps (a problem with none is all -1 from the mask
    alone), so the bytes are the row masks read and r2c written once, and,
    for a problem with a valid row, its column mask and the cost of its
    valid rows read once; 3 operations a valid row's pair to form w and its
    maximum, and for every pending row of every iteration (``work``,
    counted by the kernel) 3 a column (the net value and the two compares)
    and 4 for the bid."""
    S, R, C = cost.shape
    rows = int(row_mask.sum())
    active = int(row_mask.any(dim=1).sum())
    scanned = int(work[:, 1].sum())
    return measure.bound_ms(5 * S * R + active * C + 4 * rows * C,
                            3 * rows * C + scanned * (3 * C + 4))


def _k2_same(label, cost, rm, cm, thresh):
    S = cost.shape[0]
    caps = [torch.zeros(S, dtype=torch.int32, device="cuda") for _ in range(2)]
    works = [torch.zeros((S, 2), dtype=torch.int32, device="cuda") for _ in range(2)]
    got = masked_assignment(cost, rm, cm, thresh, caps[0], work=works[0])
    want = masked_assignment_plain(cost, rm, cm, thresh, caps[1], work=works[1])
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(caps[0], caps[1])
            and torch.equal(works[0], works[1])):
        raise AssertionError(f"K2 {label}: r2c, capped or work differs from the twin in "
                             f"{int((got != want).sum())} rows")
    path = "shared" if uses_shared_weights(*cost.shape[1:]) else "global"
    print(f"K2 {label} ({path} w): r2c and capped identical, {int((got >= 0).sum())} matches, "
          f"capped {caps[0].tolist()}, iterations {works[0][:, 0].tolist()}")


def check_k2(rng, step_calls):
    """r2c and capped against the twin on both paths: w in shared memory
    (256 x 128, the bench's) and the cost read from global memory (256 x 512,
    a live frame of up to 512 detections)."""
    for S, R, C in ((8, 256, 128), (2, 256, 512)):
        for kind in ("dense", "ties", "masked", "iou-like"):
            _k2_same(f"S={S} {R}x{C} {kind}", *_problem(rng, kind, S=S, R=R, C=C), 0.8)
        # per-problem thresholds (SFSORT's dynamic first pass)
        thresh = torch.linspace(0.3, 0.9, S, device="cuda")
        _k2_same(f"S={S} {R}x{C} per-problem thresholds",
                 *_problem(rng, "iou-like", S=S, R=R, C=C), thresh)
    rows = []
    for label in ("aabb", "obb"):
        for args, kwargs in step_calls[label]["masked_assignment"]:
            cost = args[0]
            work = torch.zeros((cost.shape[0], 2), dtype=torch.int32, device="cuda")
            masked_assignment(*args, **kwargs, work=work)
            row = (measure.device_ms(lambda: masked_assignment(*args, **kwargs), "auction_kernel"),
                   measure.event_ms(lambda: masked_assignment(*args, **kwargs)),
                   measure.event_ms(lambda: masked_assignment_plain(*args, **kwargs), reps=5,
                                    warmup=1), *k2_bound(cost, args[1], work))
            print(f"K2 {label} bench step {tuple(cost.shape)}: device {row[0]:.5f} ms a launch, "
                  f"wrapper {row[1]:.5f} ms, plain {row[2]:.5f} ms, bound {row[3]:.6f} ms "
                  f"({row[4]}); iterations {work[:, 0].tolist()}, rows scanned "
                  f"{work[:, 1].tolist()}")
            if label == "aabb":
                rows.append(row)
    return timing(0.0, rows)


def _obbs(rng, S, n, span=(1920, 1080), wmax=200.0):
    """Rotated boxes [cx, cy, w, h, theta] (S, n, 5)."""
    b = np.zeros((S, n, 5), np.float32)
    b[..., 0] = rng.uniform(0, span[0], (S, n))
    b[..., 1] = rng.uniform(0, span[1], (S, n))
    b[..., 2:4] = rng.uniform(2, wmax, (S, n, 2))
    b[..., 4] = rng.uniform(-np.pi, np.pi, (S, n))
    return b


def _track_like(rng, S, N, M):
    """Tracks (S, N, 5) and detections (S, M, 5) on a 600 px field, half of
    the detections near a track, with the step's edge cases: empty slots
    (zero area), unit padding boxes, slivers and angles at +-pi/2."""
    a, b = _obbs(rng, S, N, (600, 600)), _obbs(rng, S, M, (600, 600))
    k = min(N, M) // 2
    b[:, :k] = a[:, :k] + rng.normal(0, 3, (S, k, 5)).astype(np.float32)
    for x in (a, b):
        x[:, 0::9] = 0.0
        x[:, 1::9] = [0.0, 0.0, 1.0, 1.0, 0.0]
        x[:, 2::9, 2] = 1e-3
        x[:, 3::9, 4] = np.pi / 2 * np.sign(x[:, 3::9, 4] + 1e-9) - 1e-7
    return a, b


def _degenerate(rng):
    """One problem of the hard cases: identical boxes, quarter turns of
    half-size boxes, slivers across a box, zero-area and point boxes, unit
    padding boxes, boxes sharing centre and angle, angles near +-pi/2 and
    far disjoint boxes."""
    a, b = _obbs(rng, 1, 64, (400, 400)), _obbs(rng, 1, 80, (400, 400))
    b[0, :32] = a[0, :32] + rng.normal(0, 3, (32, 5)).astype(np.float32)
    b[0, 32:40] = a[0, 32:40]
    b[0, 40:44] = a[0, 40:44]
    b[0, 40:44, 2] *= 0.5
    b[0, 40:44, 4] += np.pi / 2
    b[0, 44] = [0, 0, 1, 1, 0]
    b[0, 45] = [a[0, 0, 0], a[0, 0, 1], 1e-3, 300, 1.0]
    b[0, 46:50, 4] = np.pi / 2 * rng.choice([-1, 1], 4) + rng.normal(0, 1e-6, 4)
    b[0, 50:54, :2] = a[0, 50:54, :2]
    b[0, 50:54, 4] = a[0, 50:54, 4]
    b[0, 54] = [1e5, 1e5, 10, 10, 0.3]
    b[0, 55] = 0.0
    a[0, 44] = 0.0
    a[0, 45, 2] = 0.0
    a[0, 46] = [0, 0, 1, 1, 0]
    return a, b


def crossed_quads(rng, n, size=4.0):
    """Boxes (n, 5) whose corners (n, 4, 2) are drawn at random around the
    centre, so that most quadrilaterals cross themselves, as rounding can bend
    a near-collinear sliver's corners across each other.  A half-plane then
    cuts such a list in more than two places, and now and then a stage emits
    more than K3's fast path holds (8 vertices): the slow path's set."""
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = rng.normal(0, 1, (n, 2))
    b[:, 2:4] = size
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    c = b[:, None, :2] + rng.normal(0, 1, (n, 4, 2))
    return b, c.astype(np.float32)


def _twin_in_row_chunks(a, b, c1, c2, rows=256):
    """The twin over row chunks, so its (rows, M, 64) slot temporaries fit."""
    return torch.cat([rotated_iou_plain(a[:, i:i + rows], b, c1[:, i:i + rows], c2)
                      for i in range(0, a.shape[1], rows)], dim=1)


def k3_bound(a, b, ops):
    """K3's least time for these inputs: 13 floats read once per box, one IoU
    written once per pair; the operations are those the counting
    instantiation added up for each pair (its centring, clip walk and
    quotient, not the kernel's reject test), plus 1 a box (its area) and 17
    a clip box (its winding)."""
    S, N, M = ops.shape
    return measure.bound_ms(52 * S * (N + M) + 4 * S * N * M,
                            int(ops.sum(dtype=torch.int64)) + S * (N + 18 * M))


def check_k3(rng, step_calls):
    """K3 against its twin, both given the same corners (computed once on the
    card), so the comparison tests the clip and not the trig; bit-equal on
    every set, the crossed quadrilaterals' slow path included."""
    cases = [("tracker", *_track_like(rng, 8, 256, 128)), ("ragged", *_track_like(rng, 1, 1, 3)),
             ("ragged", *_track_like(rng, 2, 200, 77)), ("degenerate", *_degenerate(rng)),
             ("4096^2", _obbs(rng, 1, 4096), _obbs(rng, 1, 4096))]
    (qa, ca), (qb, cb) = crossed_quads(rng, 256), crossed_quads(rng, 256)
    cases.append(("crossed (overflow)", qa[None], qb[None], ca[None], cb[None]))
    timed = {}
    for kind, a, b, *corners in cases:
        a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        c1, c2 = ([torch.from_numpy(c).cuda() for c in corners] if corners
                  else [obb_corners(x).contiguous() for x in (a, b)])
        got = rotated_iou(a, b, c1, c2)
        counted, ops, slow = rotated_iou_counted(a, b, c1, c2)
        big = a.shape[1] * b.shape[1] > 1 << 20
        want = (_twin_in_row_chunks if big else rotated_iou_plain)(a, b, c1, c2)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(counted, want)):
            err = float((got - want).abs().max())
            raise AssertionError(f"K3 {kind} {tuple(got.shape)}: not bit-equal to the twin "
                                 f"(max abs err {err})")
        print(f"K3 {kind} S,N,M={tuple(got.shape)}: bit-equal to the twin, pairs on the slow "
              f"path: {slow}, pairs with IoU > 0.05: {int((got > 0.05).sum())}")
        if kind.startswith("crossed") and slow == 0:
            raise AssertionError("K3: the crossed quadrilaterals never took the slow path")
        if kind == "degenerate":
            self_iou = torch.diagonal(rotated_iou(a, a, c1, c1)[0])
            if not ((self_iou[:44] > 0.999).all() and float(got[0, 0, 54]) == 0.0):
                raise AssertionError("K3: self-IoU <= 0.999 or a disjoint pair > 0")
        if kind == "4096^2":
            timed[kind] = (a, b, c1, c2, ops)
    # the OBB bench step's own inputs (its two launches), with their corners
    for args, _ in step_calls["obb"]["rotated_iou"]:
        a, b = args[0], args[1]
        c1, c2 = (obb_corners(x).contiguous() for x in (a, b))
        timed[f"bench step {tuple(a.shape[:2])} x {b.shape[1]}"] = (
            a, b, c1, c2, rotated_iou_counted(a, b, c1, c2)[1])
    rows = []
    for kind, (a, b, c1, c2, ops) in timed.items():
        big = kind == "4096^2"
        twin = _twin_in_row_chunks if big else rotated_iou_plain
        row = (measure.device_ms(lambda: rotated_iou(a, b, c1, c2), "rotated_iou_kernel",
                                 reps=5 if big else 20),
               measure.event_ms(lambda: rotated_iou(a, b, c1, c2), reps=5 if big else 50),
               measure.event_ms(lambda: twin(a, b, c1, c2), reps=3 if big else 20, warmup=1),
               *k3_bound(a, b, ops))
        print(f"K3 {kind}: device {row[0]:.5f} ms a launch, wrapper {row[1]:.5f} ms, plain "
              f"{row[2]:.4f} ms, bound {row[3]:.5f} ms ({row[4]}), "
              f"{int(ops.sum(dtype=torch.int64))} operations counted")
        if not big:
            rows.append(row)
    return timing(0.0, rows)


def bench_step_calls():
    """The arguments of every kernel launch of one steady bench step (frame
    64 of 256), AABB and OBB ByteTrack at the bench shape, recorded so that
    phase 3 times each kernel on the inputs the main path gives it."""
    calls = {}
    for label, cfg, frames_fn, cols, names in (
            ("aabb", ByteTrackConfig(capacity=CAPACITY), synthetic_frames, 6,
             ("fused_iou_cost", "masked_assignment")),
            ("obb", ByteTrackConfig(capacity=CAPACITY, is_obb=True),
             lambda n, d, seed: synthetic_obb_frames(n, d, seed=seed, miss=0.0), 7,
             ("rotated_iou", "masked_assignment"))):
        packed = [pack_frames(frames_fn(65, N_DETS, seed=100 + s), D=D_BENCH, F=65,
                              det_cols=cols)[0] for s in range(N_SEQS)]
        batch = torch.from_numpy(np.stack(packed)).cuda()
        states, _, _ = batch_replay(cfg, init_states(cfg, N_SEQS, "cuda"), batch[:, :64])
        with measure.record_calls(bytetrack, names) as rec:
            batch_replay(cfg, states, batch[:, 64:])
        calls[label] = rec
        print(f"bench step {label}: " + ", ".join(
            f"{n} x {len(v)} {[tuple(a[0].shape) for a, _ in v]}" for n, v in rec.items()))
    return calls


def check_kalman_obb(rng):
    """The OBB Kalman bank (unrolled 5x5 Cholesky, Joseph update, angle
    alignment) gives the same bits on the card as on the CPU."""
    layout = kalman.make_xywh_layout(True)
    z = torch.from_numpy(_obbs(rng, 8, 256))
    mean, cov = kalman.initiate(layout, z)
    mask = torch.from_numpy(rng.uniform(size=(8, 256)) < 0.8)
    meas = torch.from_numpy(_obbs(rng, 8, 256) * np.float32(0.01)) + z
    out = {}
    for dev in ("cpu", "cuda"):
        m, c, k, zz = (t.to(dev) for t in (mean, cov, mask, meas))
        m, c = kalman.predict(layout, m, c, k)
        sinv = kalman.inv_psd_small(c[..., :5, :5] + torch.eye(5, device=dev))
        m, c = kalman.update(layout, m, c, kalman.align_obb_to_ref(zz, m[..., :5]), k)
        out[dev] = [t.cpu() for t in (sinv, m, c)]
    same = [torch.equal(x, y) for x, y in zip(out["cpu"], out["cuda"])]
    print(f"OBB Kalman bank cuda vs cpu, bit-equal: inverse {same[0]}, mean {same[1]}, cov {same[2]}")
    if not all(same):
        raise AssertionError("the OBB Kalman bank differs between the card and the CPU")


def drive(label, fn, ratio, sync_free=True):
    """Drive one path with every launch counter at 0; ``ratio`` gives the
    fixed launches per step of the kernels the path must run (others must
    not run at all).  A ``sync_free`` path runs under
    set_sync_debug_mode("error"), so any host sync in it raises."""
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
    torch.cuda.set_sync_debug_mode("error" if sync_free else 0)
    try:
        result = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = {name: wrapper.launches for name, (wrapper, _, _) in KERNELS.items()}
    print(f"launches in {label}: {counts}")
    steps = {counts[k] / w for k, w in ratio.items()}
    if min(counts[k] for k in ratio) <= 0 or len(steps) != 1:
        raise AssertionError(f"{label}: launches {counts} are not {ratio} per step")
    if any(counts[k] for k in counts if k not in ratio):
        raise AssertionError(f"{label}: a kernel outside the path launched: {counts}")
    for k, v in counts.items():
        LAUNCHES[k] += v
    return result


def _mot_rows(out_dir: Path) -> dict:
    """{sequence: rows} of the files an eval wrote to ``out_dir``."""
    return {p.stem: np.loadtxt(p, delimiter=",", ndmin=2) for p in sorted(out_dir.glob("*.txt"))}


def check_sync_mode_is_live():
    """A host sync under set_sync_debug_mode("error") must raise here."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.zeros(1, device="cuda").item()
    except RuntimeError:
        pass
    else:
        raise AssertionError("set_sync_debug_mode('error') let a host sync through")
    finally:
        torch.cuda.set_sync_debug_mode(0)


def run_aabb_evals():
    """Phase 4: run_eval for ByteTrack and SFSORT on both fixtures."""
    ratios = {"bytetrack": {"fused_iou_cost": 2, "masked_assignment": 3},
              "sfsort": {"masked_assignment": 2}}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        for (name, tracker), want in sorted(PINNED.items()):
            t0 = time.perf_counter()
            res = drive(f"run_eval {tracker} {name}", lambda: boxmot_tpu_torch.run_eval(
                ROOTS[name], tracker, device="cuda", output_dir=out / "cuda" / tracker / name),
                ratios[tracker])
            seconds = time.perf_counter() - t0
            got = {k: float(res["combined"][k]) for k in ("HOTA", "MOTA", "IDF1")}
            print(f"eval {tracker} {name} on cuda: {got} in {seconds:.3f} s (pins {want})")
            for k, v in want.items():
                if not abs(got[k] - v) <= ATOL:
                    raise AssertionError(f"{tracker} {name} {k} = {got[k]} misses the pin {v}")
            # the card's MOT rows against the same eval on the CPU
            cpu_dir = out / "cpu" / tracker / name
            boxmot_tpu_torch.run_eval(ROOTS[name], tracker, device="cpu", output_dir=cpu_dir)
            gpu, cpu = _mot_rows(out / "cuda" / tracker / name), _mot_rows(cpu_dir)
            if gpu.keys() != cpu.keys() or not gpu:
                raise AssertionError(f"{name}: cuda wrote {sorted(gpu)}, cpu wrote {sorted(cpu)}")
            for seq, g in gpu.items():
                c = cpu[seq]
                keys = [0, 1, 6, 7, 8]  # frame, id, conf, cls, det_ind
                if g.shape != c.shape or not np.array_equal(g[:, keys], c[:, keys]):
                    raise AssertionError(f"{tracker} {seq}: MOT rows differ between cuda and cpu")
                box = float(np.abs(g[:, 2:6] - c[:, 2:6]).max(initial=0.0))
                if not (np.isfinite(g).all() and box <= 1.0):  # boxes are whole pixels
                    raise AssertionError(f"{seq}: MOT boxes differ by {box} px between cuda and cpu")
                print(f"{tracker} {seq} rows cuda vs cpu: {len(g)} rows, all equal: "
                      f"{np.array_equal(g, c)}")


def run_obb_evals():
    """Phase 5: run_eval_obb for ByteTrack and SFSORT on mmot-mini."""
    ratios = {"bytetrack": {"rotated_iou": 2, "masked_assignment": 3},
              "sfsort": {"rotated_iou": 1, "masked_assignment": 2}}
    dets = mmot_obb_dets(MMOT_ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        for tracker, want in OBB_EVAL.items():
            out = {d: Path(tmp) / tracker / d for d in ("cuda", "cpu")}
            t0 = time.perf_counter()
            res = drive(f"run_eval_obb {tracker}", lambda: boxmot_tpu_torch.run_eval_obb(
                MMOT_ROOT, tracker, device="cuda", output_dir=out["cuda"]), ratios[tracker])
            seconds = time.perf_counter() - t0
            got = {k: float(res["combined"][k]) for k in ("HOTA", "MOTA", "IDF1")}
            print(f"eval_obb {tracker} mmot-mini on cuda: {got} in {seconds:.3f} s (JAX {want})")
            for k, v in want.items():
                if not abs(got[k] - v) <= ATOL:
                    raise AssertionError(f"OBB {tracker} {k} = {got[k]} misses the JAX value {v}")
            boxmot_tpu_torch.run_eval_obb(MMOT_ROOT, tracker, device="cpu", output_dir=out["cpu"])
            gpu, cpu = _mot_rows(out["cuda"]), _mot_rows(out["cpu"])
            for seq, g in gpu.items():
                c = cpu[seq]
                keys = [0, 1, 10, 11]  # frame, id, conf, cls
                corner = float(np.abs(g[:, 2:10] - c[:, 2:10]).max(initial=0.0)) \
                    if g.shape == c.shape else np.inf
                if not (g.shape == c.shape and np.array_equal(g[:, keys], c[:, keys])
                        and corner <= OBB_BOX_TOL):
                    raise AssertionError(f"OBB {tracker} {seq}: corner rows differ cuda vs cpu")
                print(f"OBB {tracker} {seq} corner rows cuda vs cpu: {len(g)} rows, frame/id/"
                      f"conf/cls equal, max corner diff {corner:.3g} px")
            # det_ind is not in the corner rows: hold the replay's tracks
            cfg = build_replay_config(tracker, is_obb=True)
            seqs = [{"dets": d} for d in dets.values()]
            for (go, gm), (co, cm) in zip(replay_sequences_outputs(cfg, seqs, device="cuda"),
                                          replay_sequences_outputs(cfg, seqs, device="cpu")):
                box = float(np.abs(go[gm][:, :5] - co[cm][:, :5]).max(initial=0.0))
                if not (np.array_equal(gm, cm) and np.array_equal(go[gm][:, 5:], co[cm][:, 5:])
                        and box <= OBB_BOX_TOL):
                    raise AssertionError(f"OBB {tracker}: tracks differ between cuda and cpu")
            print(f"OBB {tracker} replay tracks cuda vs cpu: masks, ids, conf, cls, det_ind "
                  f"equal; max xywha diff {box:.3g}")


def _live_frames(n_frames):
    """The first n_frames of LIVE_SEQ's public det.txt as (Ni, 6) arrays, and
    a blank image of the sequence's size."""
    rows = np.loadtxt(LIVE_SEQ / "det" / "det.txt", delimiter=",", ndmin=2)
    frames = []
    for f in range(1, n_frames + 1):
        sel = rows[rows[:, 0] == f]
        frames.append(np.stack([sel[:, 2], sel[:, 3], sel[:, 2] + sel[:, 4], sel[:, 3] + sel[:, 5],
                                sel[:, 6], np.zeros(len(sel))], axis=1).astype(np.float32))
    info = configparser.ConfigParser()
    info.read(LIVE_SEQ / "seqinfo.ini")
    img = np.zeros((info.getint("Sequence", "imHeight"), info.getint("Sequence", "imWidth"), 3),
                   np.uint8)
    return frames, img


def run_live():
    """Phase 6a: live update on cuda against the same tracker on the cpu."""
    frames, img = _live_frames(50)
    trackers = {d: boxmot_tpu_torch.create_tracker("bytetrack", device=d) for d in ("cuda", "cpu")}
    n_rows, worst, update_ms = 0, 0.0, []
    for f, dets in enumerate(frames, start=1):
        t0 = time.perf_counter()
        g = np.asarray(trackers["cuda"].update(dets, img))
        update_ms.append((time.perf_counter() - t0) * 1e3)
        c = np.asarray(trackers["cpu"].update(dets, img))
        if g.shape != c.shape or not np.array_equal(g[:, 4:], c[:, 4:]):
            raise AssertionError(f"live frame {f}: ids/conf/cls/det_ind differ between cuda and cpu")
        if len(g):
            worst = max(worst, float(np.abs(g[:, :4] - c[:, :4]).max()))
        if not worst <= 1e-3:
            raise AssertionError(f"live frame {f}: boxes differ by {worst} px")
        if not np.isfinite(g).all():
            raise AssertionError(f"live frame {f}: non-finite output")
        n_rows += len(g)
    if n_rows == 0:
        raise AssertionError("live API: no track was emitted in 50 frames")
    print(f"live API, 50 frames of {LIVE_SEQ.name}: {n_rows} rows equal to cpu "
          f"(ids, det_ind, cls, conf exact; max box diff {worst:.3g} px); cuda update "
          f"median {statistics.median(update_ms[1:]):.3f} ms/frame (host clock, frames 2-50)")


def run_live_obb(tracker):
    """Phase 6b: live update of (N, 7) mmot-mini frames, cuda against cpu."""
    n_rows, worst = 0, 0.0
    for seq, frames in mmot_obb_dets(MMOT_ROOT).items():
        trackers = {d: boxmot_tpu_torch.create_tracker(tracker, device=d) for d in ("cuda", "cpu")}
        for f, dets in enumerate(frames, start=1):
            g = np.asarray(trackers["cuda"].update(dets))
            c = np.asarray(trackers["cpu"].update(dets))
            if g.shape != c.shape or g.shape[1] != 9 or not np.array_equal(g[:, 5:], c[:, 5:]):
                raise AssertionError(f"live OBB {tracker} {seq} frame {f}: tracks differ")
            if len(g):
                worst = max(worst, float(np.abs(g[:, :5] - c[:, :5]).max()))
            if not (worst <= OBB_BOX_TOL and np.isfinite(g).all()):
                raise AssertionError(f"live OBB {tracker} {seq} frame {f}: boxes differ by {worst}")
            n_rows += len(g)
    if n_rows == 0:
        raise AssertionError(f"live OBB {tracker}: no track was emitted")
    print(f"live OBB {tracker}, mmot-mini: {n_rows} rows of 9 equal to cpu (ids, det_ind, "
          f"cls, conf exact; max xywha diff {worst:.3g})")


def run_live_crowded():
    """Phase 6c: frames of 300 detections (the 512 bucket), cuda against cpu."""
    frames = synthetic_frames(3, 300, seed=9)
    trackers = {d: boxmot_tpu_torch.create_tracker("bytetrack", device=d) for d in ("cuda", "cpu")}
    for f, dets in enumerate(frames):
        dets = dets.copy()
        dets[:, 4] = np.linspace(0.3, 0.99, len(dets), dtype=np.float32)
        g = np.asarray(trackers["cuda"].update(dets))
        c = np.asarray(trackers["cpu"].update(dets))
        if g.shape != c.shape or not np.array_equal(g[:, 4:], c[:, 4:]):
            raise AssertionError(f"300 detections, frame {f}: tracks differ between cuda and cpu")
    print(f"live 300 detections, 3 frames: {len(g)} rows in the last frame, equal to cpu, "
          f"largest det_ind {int(g[:, 7].max())}")


def _bench(label, cfg, frames_fn, det_cols, card, launches=6):
    """frames/s of batch_replay at the bench shape; a distinct seeded input
    per launch, the first launch a warm-up."""
    batches = []
    for v in range(launches):
        packed = [pack_frames(frames_fn(N_FRAMES, N_DETS, seed=v * N_SEQS + s), D=D_BENCH,
                              F=N_FRAMES, det_cols=det_cols)[0] for s in range(N_SEQS)]
        batches.append(torch.from_numpy(np.stack(packed)).cuda())
    ms, capped = [], 0
    for i, b in enumerate(batches):
        states = init_states(cfg, N_SEQS, "cuda")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        states, outs, masks = batch_replay(cfg, states, b)
        end.record()
        end.synchronize()
        if not torch.isfinite(outs[masks]).all():
            raise AssertionError(f"{label} bench replay: non-finite output")
        capped += int(states.lap_capped.sum())
        if i:
            ms.append(start.elapsed_time(end))
    fps = N_SEQS * N_FRAMES / (statistics.median(ms) / 1e3)
    line = {"metric": f"{label}_replay_fps_{N_DETS}dets", "value": fps, "unit": "frames/s",
            "shape": [N_SEQS, N_FRAMES, N_DETS, D_BENCH, CAPACITY], "launch_ms": ms,
            "lap_capped": capped, "card": card}
    print(json.dumps(line))
    return fps


def run_throughput(card):
    """Phase 7: the AABB and OBB ByteTrack bench lines."""
    drive("bench bytetrack AABB", lambda: _bench(
        "bytetrack", ByteTrackConfig(capacity=CAPACITY), synthetic_frames, 6, card),
        {"fused_iou_cost": 2, "masked_assignment": 3}, sync_free=False)
    drive("bench bytetrack OBB", lambda: _bench(
        "bytetrack_obb", ByteTrackConfig(capacity=CAPACITY, is_obb=True),
        lambda n, d, seed: synthetic_obb_frames(n, d, seed=seed, miss=0.0), 7, card, launches=4),
        {"rotated_iou": 2, "masked_assignment": 3}, sync_free=False)


def build_kernels():
    """Phase 2: one nvcc per source, all started together."""
    names = [src for _, src, _ in KERNELS.values()]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(build.build, names)))
    for name, path in paths.items():
        seconds, log = build.BUILD_LOG.get(name, (0.0, "(prebuilt)\n"))
        print(f"built {path.name} in {seconds:.1f} s\n{log.strip()}")
    print(f"kernels built in {time.perf_counter() - t0:.1f} s (wall, in parallel)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {kind}")
    print(f"nvidia-smi: {smi}")
    build_kernels()

    rng = np.random.default_rng(0)
    step_calls = bench_step_calls()
    checks = {"fused_iou_cost": check_k1(rng, step_calls),
              "masked_assignment": check_k2(rng, step_calls),
              "rotated_iou": check_k3(rng, step_calls)}
    del step_calls
    check_kalman_obb(rng)

    check_sync_mode_is_live()
    run_aabb_evals()
    run_obb_evals()
    live = {"fused_iou_cost": 2, "masked_assignment": 3}
    drive("live bytetrack AABB", run_live, live, sync_free=False)
    drive("live bytetrack OBB", lambda: run_live_obb("bytetrack"),
          {"rotated_iou": 2, "masked_assignment": 3}, sync_free=False)
    drive("live sfsort OBB", lambda: run_live_obb("sfsort"),
          {"rotated_iou": 1, "masked_assignment": 2}, sync_free=False)
    drive("live bytetrack 300 detections", run_live_crowded, live, sync_free=False)
    run_throughput(smi)

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"nvidia-smi: {smi}")
    for name, c in checks.items():
        print(f"wrapper ms {name}: {c['wrapper_ms']:.5f} (CUDA events around one call of the "
              f"wrapper, host work included)")
    # library_ms: no single PyTorch call computes any of the three functions
    kernels = [
        {"name": name, "route": "cuda", "source": f"boxmot_tpu_torch/csrc/{src}.cu",
         "replaces": replaces, "launches": LAUNCHES[name],
         **{k: checks[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None}
        for name, (_, src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
