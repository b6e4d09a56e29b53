# Frozen copy of boxmot_tpu_torch/trackers/ocsort.py at commit 78364f93b578: the plain
# (twin) path only, on every device; no kernel, no tracker shell.
"""OC-SORT (AABB and OBB) as a fixed-capacity slot bank, batched over S sequences.

Counterpart of ``boxmot_tpu/trackers/ocsort.py``: observation-centric SORT
with an XYSR Kalman filter, a velocity-direction term in the first pass's
cost, observation-centric recovery (OCR) against the last observations, and
the observation-centric re-update (ORU) of tracks that are found again
after misses.  Every state tensor carries a leading axis S, and one
``ocsort_step`` call advances S independent sequences by one frame:

* the masked XYSR predict (area velocity zeroed where it would drive the
  area negative);
* the previous observation ``delta_t`` frames back, from each slot's ring;
* pass 1: IoU (kernel K1 in its IoU-only mode for ``"iou"``, K3 for
  ``"iou_obb"``) plus the velocity-direction cost, the reference's
  unique-candidate shortcut, else a full assignment (kernel K2, its
  threshold computed per problem on the device);
* the optional BYTE pass on low-confidence detections, reusing pass 1's IoU;
* OCR: leftover detections against the last observations (K1 or K3, K2);
* the ORU (kernel K4, ``ops.oru``), then one masked update of every matched
  slot;
* velocities, observation rings, freezes at a first miss, new tracks in
  free slots, removal and emission of the last observation box.

The step uses masks and ``torch.where`` only, so on a CUDA device a replay
runs without a host sync.  The reference's quirks that the JAX step keeps
are kept: the OBB batch velocity takes the AABB centre formula on columns
0-3, the velocity cost is gated on column 4 of the previous observation
(theta in OBB mode), the stored OBB velocity uses true centres, and Q_a
takes Q_s's value.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from portbench.reference.frozen.motion import kalman
from portbench.reference.frozen.ops.geometry import exact, obb2xysr, xysr2obb, xysr2xyxy, xyxy2xysr
from portbench.reference.frozen.ops.iou import get_asso_func
from portbench.reference.frozen.ops.lap import masked_assignment
from portbench.reference.frozen.ops.oru import MAX_ORU, masked_update, oru_replay  # noqa: F401 (re-export)
from portbench.reference.frozen.trackers.slots import allocate, scatter_det_flags, take


@dataclasses.dataclass(frozen=True)
class OcSortConfig:
    """Field for field the JAX ``OcSortConfig``, with the same defaults."""

    det_thresh: float = 0.3
    min_conf: float = 0.1
    max_age: int = 30
    min_hits: int = 3
    iou_threshold: float = 0.3
    delta_t: int = 3
    inertia: float = 0.2
    use_byte: bool = False
    q_xy_scaling: float = 0.01
    q_s_scaling: float = 0.0001
    asso_func: str = "iou"
    frame_w: float = 0.0  # set from the first img for centroid asso
    frame_h: float = 0.0
    is_obb: bool = False  # oriented boxes: 9-D XYSR+theta filter
    capacity: int = 256


@dataclasses.dataclass
class OcSortState:
    """S slot banks of capacity K.  The fields up to ``next_id`` are the JAX
    ``OcSortState`` fields with a leading S axis."""

    mean: torch.Tensor  # (S, K, 7) xysr + velocities; (S, K, 9) with theta (OBB)
    cov: torch.Tensor  # (S, K, 7, 7); (S, K, 9, 9)
    active: torch.Tensor  # (S, K) bool
    age: torch.Tensor  # (S, K) int32 predicts since creation
    tsu: torch.Tensor  # (S, K) int32 time since update
    hits: torch.Tensor  # (S, K) int32
    hit_streak: torch.Tensor  # (S, K) int32
    tid: torch.Tensor  # (S, K) int32
    conf: torch.Tensor  # (S, K) f32
    cls: torch.Tensor  # (S, K) f32
    det_ind: torch.Tensor  # (S, K) f32
    last_obs: torch.Tensor  # (S, K, 5) box + conf, or -1; (S, K, 6) (OBB)
    has_obs: torch.Tensor  # (S, K) bool: ever updated with a detection
    obs_ring: torch.Tensor  # (S, K, R, 5 or 6) observations by age % R
    ring_age: torch.Tensor  # (S, K, R) int32 age stored, -1 empty
    velocity: torch.Tensor  # (S, K, 2) (dy, dx)
    observed: torch.Tensor  # (S, K) bool: matched on the previous step
    frozen_mean: torch.Tensor  # (S, K, dx) snapshot at the first miss (ORU)
    frozen_cov: torch.Tensor  # (S, K, dx, dx)
    last_meas: torch.Tensor  # (S, K, 4 or 5) xysr measurement of the last real update
    frame_count: torch.Tensor  # (S,) int32
    next_id: torch.Tensor  # (S,) int32
    lap_capped: torch.Tensor  # (S,) int32 solves that stopped at the iteration cap
    oru_replayed: torch.Tensor  # (S,) int32 slots the ORU replayed


def init_state(cfg: OcSortConfig, n: int, device) -> OcSortState:
    """n fresh slot banks on ``device``."""
    K, R = cfg.capacity, cfg.delta_t
    dx = 9 if cfg.is_obb else 7
    obs = 6 if cfg.is_obb else 5  # stored observation: box + conf
    dz = 5 if cfg.is_obb else 4

    def full(shape, value, dtype):
        return torch.full((n, *shape), value, dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    return OcSortState(
        mean=full((K, dx), 0.0, f32),
        cov=full((K, dx, dx), 0.0, f32),
        active=full((K,), False, torch.bool),
        age=full((K,), 0, i32),
        tsu=full((K,), 0, i32),
        hits=full((K,), 0, i32),
        hit_streak=full((K,), 0, i32),
        tid=full((K,), 0, i32),
        conf=full((K,), 0.0, f32),
        cls=full((K,), 0.0, f32),
        det_ind=full((K,), 0.0, f32),
        last_obs=full((K, obs), -1.0, f32),
        has_obs=full((K,), False, torch.bool),
        obs_ring=full((K, R, obs), -1.0, f32),
        ring_age=full((K, R), -1, i32),
        velocity=full((K, 2), 0.0, f32),
        observed=full((K,), False, torch.bool),
        frozen_mean=full((K, dx), 0.0, f32),
        frozen_cov=full((K, dx, dx), 0.0, f32),
        last_meas=full((K, dz), 0.0, f32),
        frame_count=full((), 0, i32),
        next_id=full((), 1, i32),
        lap_capped=full((), 0, i32),
        oru_replayed=full((), 0, i32),
    )


@functools.lru_cache(maxsize=16)
def _layout(obb: bool, q_xy_scaling: float, q_s_scaling: float) -> kalman.KFLayout:
    # Q_a takes Q_s's value: the reference passes Q_a_scaling=self.Q_s_scaling
    # at track creation, so the constructor's own default never applies
    return kalman.make_xysr_layout(obb, q_xy_scaling, q_s_scaling, q_s_scaling)


def _full_assignment(cost, row_mask, col_mask, capped):
    """Full (max-cardinality, min-cost) assignment over the valid pairs: the
    auction with a threshold of hi + delta per problem, delta 1 % of the
    valid costs' range (at least 1e-4), as the JAX step; see its docstring."""
    valid = row_mask[:, :, None] & col_mask[:, None, :]
    hi = torch.where(valid, cost, -math.inf).amax(dim=(1, 2))
    lo = torch.where(valid, cost, math.inf).amin(dim=(1, 2))
    hi = torch.where(torch.isfinite(hi), hi, 0.0)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    delta = torch.clamp_min(hi - lo, 1e-2) * 1e-2
    return masked_assignment(cost, row_mask, col_mask, hi + delta, capped)


def _unique_shortcut(iou, row_mask, col_mask, thresh):
    """The reference's shortcut: where the candidates at iou > thresh form a
    perfect partial matching, use it.  Returns usable (S,), r2c (S, K)."""
    a = (iou > thresh) & row_mask[:, :, None] & col_mask[:, None, :]
    ai = a.to(torch.int32)
    usable = (ai.sum(dim=2).amax(dim=1) == 1) & (ai.sum(dim=1).amax(dim=1) == 1)
    r2c = torch.where(a.any(dim=2), ai.argmax(dim=2).to(torch.int32), -1)
    return usable, r2c


def _speed_direction(from_boxes, to_boxes):
    """Normalized (dy, dx) between box centres (xyxy), pairwise:
    (S, K, 4) x (S, D, 4) -> two (S, K, D)."""
    fcx = (from_boxes[..., 0] + from_boxes[..., 2]) / 2.0
    fcy = (from_boxes[..., 1] + from_boxes[..., 3]) / 2.0
    tcx = (to_boxes[..., 0] + to_boxes[..., 2]) / 2.0
    tcy = (to_boxes[..., 1] + to_boxes[..., 3]) / 2.0
    dx = tcx[:, None, :] - fcx[:, :, None]
    dy = tcy[:, None, :] - fcy[:, :, None]
    norm = exact(torch.sqrt, dx * dx + dy * dy) + 1e-6
    return dy / norm, dx / norm


def _at(x, idx):
    """x (S, K, D) at column idx (S, K)."""
    return torch.gather(x, 2, idx.long()[..., None])[..., 0]


def _filtered(r2c, iou, thresh, gate):
    """Rows whose assigned pair has iou >= thresh, in problems where ``gate``
    (S,) holds."""
    D = iou.shape[2]
    return (r2c >= 0) & (_at(iou, torch.clamp(r2c, 0, D - 1)) >= thresh) & gate[:, None]


def _gate(iou, rows, cols, thresh):
    """(S,): some valid pair has iou > thresh."""
    best = torch.where(rows[:, :, None] & cols[:, None, :], iou, -math.inf).amax(dim=(1, 2))
    return best > thresh


def _set(x, i, v):
    return torch.cat([x[..., :i], v[..., None], x[..., i + 1:]], dim=-1)


def ocsort_step(cfg: OcSortConfig, state: OcSortState, dets: torch.Tensor,
                det_valid: torch.Tensor):
    """One frame of S sequences.

    dets: (S, D, 7) [x1, y1, x2, y2, conf, cls, det_ind], or (S, D, 8)
    [cx, cy, w, h, theta, conf, cls, det_ind] when ``cfg.is_obb``; padding
    rows with conf = -1; det_valid: (S, D) bool.  Returns (state, out
    (S, K, 8) or (S, K, 9), out_mask (S, K)).
    """
    obb = cfg.is_obb
    layout = _layout(obb, cfg.q_xy_scaling, cfg.q_s_scaling)
    asso = get_asso_func(cfg.asso_func + "_obb" if obb else cfg.asso_func,
                         cfg.frame_w or None, cfg.frame_h or None)
    D, R = dets.shape[1], cfg.delta_t
    B = 5 if obb else 4  # box columns
    vs_idx = 7 if obb else 6  # the area velocity
    thr = cfg.iou_threshold
    frame = state.frame_count + 1

    conf = dets[..., B].contiguous()
    first = det_valid & (conf > cfg.det_thresh)
    second = det_valid & (conf > cfg.min_conf) & (conf < cfg.det_thresh)
    det_box = dets[..., :B].contiguous()
    det_meas = obb2xysr(det_box) if obb else xyxy2xysr(det_box)
    det_meas = torch.cat([det_meas[..., :2], torch.clamp_min(det_meas[..., 2:4], 1e-6),
                          det_meas[..., 4:]], -1)

    # predict: the area velocity zeroed where it would drive the area negative
    active = state.active
    vs = state.mean[..., vs_idx]
    mean = _set(state.mean, vs_idx, torch.where(vs + state.mean[..., 2] <= 0, 0.0, vs))
    mean, cov = kalman.predict(layout, mean, state.cov, active)
    age = state.age + active.to(torch.int32)
    hit_streak = torch.where(active & (state.tsu > 0), 0, state.hit_streak)
    tsu = state.tsu + active.to(torch.int32)
    trk_box = xysr2obb(mean) if obb else xysr2xyxy(mean[..., :4])

    # the observation delta_t frames back (or the nearest later one) from the ring
    k_obs = state.last_obs
    found = torch.zeros_like(active)
    for i in range(R):
        target = age - (R - i)
        slot = torch.clamp(torch.remainder(target, R), 0, R - 1).long()
        hit = (torch.gather(state.ring_age, 2, slot[..., None])[..., 0] == target) & (target >= 0)
        ring_obs = torch.gather(state.obs_ring, 2, slot[..., None, None].expand(
            -1, -1, 1, state.obs_ring.shape[-1]))[:, :, 0]
        k_obs = torch.where((hit & ~found)[..., None], ring_obs, k_obs)
        found = found | hit

    # pass 1: high-confidence detections against the predicted boxes, IoU
    # plus the velocity-direction cost.  The batch velocity takes the AABB
    # centre formula on columns 0-3 in OBB mode too (a reference quirk).
    capped = state.lap_capped.clone()
    iou1 = asso(trk_box, det_box)
    Y, X = _speed_direction(k_obs[..., :4], det_box[..., :4])
    diff_cos = torch.clamp(state.velocity[..., 1:2] * X + state.velocity[..., 0:1] * Y, -1.0, 1.0)
    diff_angle = (math.pi / 2.0 - torch.abs(exact(torch.acos, diff_cos))) / torch.full_like(
        diff_cos, math.pi)
    # column 4 is theta in OBB mode: a negative angle drops the velocity cost (a quirk)
    valid_vel = (k_obs[..., 4] >= 0)[..., None]
    angle_cost = valid_vel * diff_angle * cfg.inertia * conf[:, None, :]

    usable, r2c_short = _unique_shortcut(iou1, active, first, thr)
    r2c_full = _full_assignment(-(iou1 + angle_cost), active, first, capped)
    r2c1 = torch.where(usable[:, None], r2c_short, r2c_full)
    at1 = _at(iou1, torch.clamp(r2c1, 0, D - 1))
    # the shortcut's matches come from iou > thresh candidates
    matched = (r2c1 >= 0) & torch.where(usable[:, None], at1 > thr, at1 >= thr)
    dm = scatter_det_flags(r2c1, matched, D)
    det_col = torch.where(matched, r2c1, -1)

    # optional BYTE pass on low-confidence detections, on pass 1's IoU
    if cfg.use_byte:
        rows2 = active & ~matched
        r2c2 = _full_assignment(-iou1, rows2, second, capped)
        keep2 = _filtered(r2c2, iou1, thr, _gate(iou1, rows2, second, thr))
        matched = matched | keep2
        det_col = torch.where(keep2, r2c2, det_col)
        dm = dm | scatter_det_flags(r2c2, keep2, D)

    # OCR: leftover detections against the last observations
    rows3 = active & ~matched
    cols3 = first & ~dm
    iou3 = asso(state.last_obs[..., :B].contiguous(), det_box)
    r2c3 = _full_assignment(-iou3, rows3, cols3, capped)
    keep3 = _filtered(r2c3, iou3, thr, _gate(iou3, rows3, cols3, thr))
    matched = matched | keep3
    det_col = torch.where(keep3, r2c3, det_col)
    dm = dm | scatter_det_flags(r2c3, keep3, D)
    c = torch.clamp(det_col, 0, D - 1)

    # ORU: re-found tracks replay the filter from their frozen state (K4).
    # OBB measurements resolve their parameterization against the predicted
    # state before the restore, as the reference prepares the measurement
    # before it unfreezes.
    rejoin = matched & ~state.observed & state.has_obs & (tsu > 1)
    z2 = take(det_meas, c)
    if obb:
        z2 = kalman.align_obb_xysr(z2, mean[..., :5])
    replayed = state.oru_replayed.clone()
    mean, cov = oru_replay(layout, mean.contiguous(), cov.contiguous(), state.frozen_mean,
                           state.frozen_cov, state.last_meas, z2.contiguous(), rejoin, tsu,
                           replayed)

    # the regular update of every matched slot (OBB: angular velocity damped x0.8)
    mean, cov = masked_update(layout, mean, cov, z2, matched)

    # velocity and observation bookkeeping for matched slots
    if obb:
        # the stored OBB velocity uses true centres, unlike the batch cost
        box = take(det_box, c)
        dyy = box[..., 1] - k_obs[..., 1]
        dxx = box[..., 0] - k_obs[..., 0]
        nrm = exact(torch.sqrt, dxx * dxx + dyy * dyy) + 1e-6
        vel_new = torch.stack([dyy / nrm, dxx / nrm], -1)
    else:
        # pass 1's directions: the same k_obs and detections
        vel_new = torch.stack([_at(Y, c), _at(X, c)], -1)
    velocity = torch.where((matched & state.has_obs)[..., None], vel_new, state.velocity)

    new_obs = torch.cat([take(det_box, c), take(conf, c)[..., None]], -1)
    last_obs = torch.where(matched[..., None], new_obs, state.last_obs)
    slot = torch.clamp(torch.remainder(age, R), 0, R - 1).long()
    ring_set = state.obs_ring.scatter(2, slot[..., None, None].expand(-1, -1, 1, new_obs.shape[-1]),
                                      new_obs[:, :, None, :])
    obs_ring = torch.where(matched[..., None, None], ring_set, state.obs_ring)
    ring_age = torch.where(matched[..., None],
                           state.ring_age.scatter(2, slot[..., None], age[..., None]), state.ring_age)
    last_meas = torch.where(matched[..., None], z2, state.last_meas)
    has_obs = state.has_obs | matched
    hits = state.hits + matched.to(torch.int32)
    hit_streak = hit_streak + matched.to(torch.int32)
    det_cls = dets[..., B + 1].contiguous()
    det_ind = dets[..., B + 2].contiguous()
    conf_s = torch.where(matched, take(conf, c), state.conf)
    cls_s = torch.where(matched, take(det_cls, c), state.cls)
    det_ind_s = torch.where(matched, take(det_ind, c), state.det_ind)
    tsu = torch.where(matched, 0, tsu)

    # misses: freeze on the first unobserved step
    first_miss = active & ~matched & state.observed
    frozen_mean = torch.where(first_miss[..., None], mean, state.frozen_mean)
    frozen_cov = torch.where(first_miss[..., None, None], cov, state.frozen_cov)
    observed = torch.where(active, matched, state.observed)

    # new tracks from the unmatched high-confidence detections, into free slots in order
    n_new, free_rank, takes, slot_det = allocate(first & ~dm, ~active)
    init_mean_v, init_cov_v = kalman.initiate(layout, take(det_meas, slot_det))
    mean = torch.where(takes[..., None], init_mean_v, mean)
    cov = torch.where(takes[..., None, None], init_cov_v, cov)
    active = active | takes
    tid = torch.where(takes, state.next_id[:, None] + free_rank, state.tid)
    conf_s = torch.where(takes, take(conf, slot_det), conf_s)
    cls_s = torch.where(takes, take(det_cls, slot_det), cls_s)
    det_ind_s = torch.where(takes, take(det_ind, slot_det), det_ind_s)
    age = torch.where(takes, 0, age)
    tsu = torch.where(takes, 0, tsu)
    hits = torch.where(takes, 0, hits)
    hit_streak = torch.where(takes, 0, hit_streak)
    has_obs = has_obs & ~takes
    observed = observed & ~takes
    velocity = torch.where(takes[..., None], 0.0, velocity)
    last_obs = torch.where(takes[..., None], -1.0, last_obs)
    ring_age = torch.where(takes[..., None], -1, ring_age)

    # removal
    active = active & ~(tsu > cfg.max_age)

    # output: the last observation box where there is one
    state_box = xysr2obb(mean) if obb else xysr2xyxy(mean[..., :4])
    out_box = torch.where(has_obs[..., None], last_obs[..., :B], state_box)
    warm = (hit_streak >= cfg.min_hits) | (frame[:, None] <= cfg.min_hits)
    out_mask = active & (tsu < 1) & warm
    out = torch.cat([out_box, tid[..., None].to(torch.float32), conf_s[..., None], cls_s[..., None],
                     det_ind_s[..., None]], dim=-1)

    new_state = OcSortState(
        mean=mean,
        cov=cov,
        active=active,
        age=age.to(torch.int32),
        tsu=tsu.to(torch.int32),
        hits=hits.to(torch.int32),
        hit_streak=hit_streak.to(torch.int32),
        tid=tid.to(torch.int32),
        conf=conf_s,
        cls=cls_s,
        det_ind=det_ind_s,
        last_obs=last_obs,
        has_obs=has_obs,
        obs_ring=obs_ring,
        ring_age=ring_age.to(torch.int32),
        velocity=velocity,
        observed=observed,
        frozen_mean=frozen_mean,
        frozen_cov=frozen_cov,
        last_meas=last_meas,
        frame_count=frame,
        next_id=state.next_id + n_new,
        lap_capped=capped,
        oru_replayed=replayed,
    )
    return new_state, out, out_mask


