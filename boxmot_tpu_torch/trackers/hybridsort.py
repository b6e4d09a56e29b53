"""HybridSORT (AABB) as a fixed-capacity slot bank, batched over S sequences.

Counterpart of ``boxmot_tpu/trackers/hybridsort.py``: score-aware tracking
on the 9-state XYSCR Kalman filter ([x, y, s, c, r] and the velocities of
x, y, s and c), four-corner velocity consistency and tracklet confidence
modelling (TCM), with optional embedding guidance (EG).  Every state tensor
carries a leading axis S, and one ``hybridsort_step`` call advances S
independent sequences by one frame:

* the camera update: each active slot's box corners through the frame's
  warp (S, 2, 3), the state's x, y, s, r rebuilt from them, its score kept;
  the area velocity zeroed where it would drive the area negative (before
  this predict only, never inside the ORU); the masked predict;
* the Kalman score (the state's c, clipped) and the simple score (the
  confidence trend), and the observation ``delta_t`` frames back, from each
  slot's ring;
* pass 1: the configured association similarity (kernel K1 in its IoU-only
  mode for ``"iou"``; the YAML tier's ``"diou"`` is plain PyTorch) plus the
  four corner-velocity costs minus the score difference (TCM); with ReID the
  EG cost (the EMA feature's and the long-term bank mean's cosine
  distances, one ``torch.bmm`` each) and a full assignment (kernel K2) with
  the long-term correction, without it the unique-candidate shortcut, else
  a full assignment;
* the optional BYTE pass on low-confidence detections (TCM on the simple
  score, the low EG weight), on pass 1's similarity;
* the final chance: leftover high-confidence detections against the last
  observations (K1 or plain, K2).  Each of these two passes keeps no match
  in a sequence where no valid pair passes its gate, so its assignment
  solves only the sequences whose gate holds (the JAX step solves them all
  and discards the rest: the same matches).  On the frame after births the
  final chance's rows hold the -1 placeholder as their last observation;
  DIoU against it puts a problem's costs within about 0.1 of each other,
  the auction then runs into its iteration cap, and the gate fails unless a
  detection lies near the image's corner;
* the ORU (kernel K4's XYSCR instance, ``ops.oru``), then one update of
  every matched slot;
* the corner velocities summed over the ``delta_t`` window, with the last
  observation as the fallback; the EMA or ``adapfs`` feature update and the
  long-term bank's push, on pass-1 matches only;
* bookkeeping, freezes at a first miss, new tracks in free slots (which
  reset the ring, the velocities, the bank and the previous confidence),
  removal, and emission of ``tid + 1`` with the last observation's box.

The step uses masks and ``torch.where`` only, so on a CUDA device a replay
runs without a host sync.  Without ReID nothing is ever pushed to the
long-term bank, so its rows past the first stay zero; a birth then writes
the first row in place, into the bank of the state it was given (the bank
is read only with ReID).

Each pass runs inside a span of ``utils/spans.py`` (``hybridsort.predict``,
``pass1``, ``byte``, ``final``, ``oru``, ``update``, ``births``; the bank's
read and writes in ``hybridsort.bank_read`` and ``bank_write``), which costs
one check unless a profiler records.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math

import numpy as np
import torch

from boxmot_tpu_torch.motion import kalman
from boxmot_tpu_torch.ops.geometry import exact
from boxmot_tpu_torch.ops.iou import get_asso_func
from boxmot_tpu_torch.ops.oru import oru_replay
from boxmot_tpu_torch.trackers.base import BaseTracker
from boxmot_tpu_torch.trackers.botsort import (
    IDENTITY_WARP,
    frame_embs,
    l2_normalize,
    model_feature_dim,
    warp_tensor,
)
from boxmot_tpu_torch.trackers.deepocsort import _apply_affine
from boxmot_tpu_torch.trackers.ocsort import (
    _at,
    _filtered,
    _full_assignment,
    _gate,
    _unique_shortcut,
)
from boxmot_tpu_torch.trackers.slots import allocate, scatter_det_flags, take
from boxmot_tpu_torch.utils.spans import span

LOGGER = logging.getLogger("boxmot_tpu_torch")
CORNERS = ("lt", "rt", "lb", "rb")
# corner -> (x column, y column) of an xyxy box (reference association.py:431-470)
CORNER_COLS = {"lt": (0, 1), "rt": (0, 3), "lb": (2, 1), "rb": (2, 3)}


@dataclasses.dataclass(frozen=True)
class HybridSortConfig:
    """Field for field the JAX ``HybridSortConfig``, with the same defaults."""

    det_thresh: float = 0.5  # high-score threshold
    low_thresh: float = 0.1
    max_age: int = 30
    min_hits: int = 3
    iou_threshold: float = 0.3
    delta_t: int = 3
    inertia: float = 0.05
    use_byte: bool = True
    track_thresh: float = 0.5
    alpha: float = 0.9
    adapfs: bool = False
    longterm_bank_length: int = 30
    with_reid: bool = True
    EG_weight_high_score: float = 4.6
    EG_weight_low_score: float = 1.3
    TCM_first_step: bool = True
    TCM_byte_step: bool = True
    TCM_byte_step_weight: float = 1.0
    with_longterm_reid: bool = True
    longterm_reid_weight: float = 0.0
    with_longterm_reid_correction: bool = True
    longterm_reid_correction_thresh: float = 0.4
    longterm_reid_correction_thresh_low: float = 0.4
    asso_func: str = "iou"
    feat_dim: int = 512
    capacity: int = 256


@dataclasses.dataclass
class HybridSortState:
    """S slot banks of capacity K.  The fields up to ``next_id`` are the JAX
    ``HybridSortState`` fields with a leading S axis."""

    mean: torch.Tensor  # (S, K, 9) xyscr + velocities of x, y, s, c
    cov: torch.Tensor  # (S, K, 9, 9)
    active: torch.Tensor  # (S, K) bool
    age: torch.Tensor  # (S, K) int32
    tsu: torch.Tensor  # (S, K) int32 time since update
    hits: torch.Tensor  # (S, K) int32
    hit_streak: torch.Tensor  # (S, K) int32
    tid: torch.Tensor  # (S, K) int32, emitted as tid + 1
    conf: torch.Tensor  # (S, K) f32
    conf_pre: torch.Tensor  # (S, K) f32 previous confidence, -1 when absent
    cls: torch.Tensor  # (S, K) f32
    det_ind: torch.Tensor  # (S, K) f32
    last_obs: torch.Tensor  # (S, K, 5) box + conf, or -1
    has_obs: torch.Tensor  # (S, K) bool
    obs_ring: torch.Tensor  # (S, K, R, 5) observations by age % R
    ring_age: torch.Tensor  # (S, K, R) int32 age stored, -1 empty
    vel: torch.Tensor  # (S, K, 4, 2) corner velocities (dy, dx)
    observed: torch.Tensor  # (S, K) bool: matched on the previous step
    frozen_mean: torch.Tensor  # (S, K, 9) snapshot at the first miss (ORU)
    frozen_cov: torch.Tensor  # (S, K, 9, 9)
    last_meas: torch.Tensor  # (S, K, 5) xyscr measurement of the last real update
    smooth: torch.Tensor  # (S, K, F) EMA feature
    bank: torch.Tensor  # (S, K, L, F) long-term features, newest first
    bank_count: torch.Tensor  # (S, K) int32
    frame_count: torch.Tensor  # (S,) int32
    next_id: torch.Tensor  # (S,) int32, internal ids from 0
    lap_capped: torch.Tensor  # (S,) int32 solves that stopped at the iteration cap
    oru_replayed: torch.Tensor  # (S,) int32 slots the ORU replayed


JAX_FIELDS = tuple(f.name for f in dataclasses.fields(HybridSortState))[:-2]


def init_state(cfg: HybridSortConfig, n: int, device) -> HybridSortState:
    """n fresh slot banks on ``device``."""
    K, R, F, L = cfg.capacity, cfg.delta_t, cfg.feat_dim, cfg.longterm_bank_length

    def full(shape, value, dtype):
        return torch.full((n, *shape), value, dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    return HybridSortState(
        mean=full((K, 9), 0.0, f32),
        cov=full((K, 9, 9), 0.0, f32),
        active=full((K,), False, torch.bool),
        age=full((K,), 0, i32),
        tsu=full((K,), 0, i32),
        hits=full((K,), 0, i32),
        hit_streak=full((K,), 0, i32),
        tid=full((K,), 0, i32),
        conf=full((K,), 0.0, f32),
        conf_pre=full((K,), -1.0, f32),
        cls=full((K,), 0.0, f32),
        det_ind=full((K,), 0.0, f32),
        last_obs=full((K, 5), -1.0, f32),
        has_obs=full((K,), False, torch.bool),
        obs_ring=full((K, R, 5), -1.0, f32),
        ring_age=full((K, R), -1, i32),
        vel=full((K, 4, 2), 0.0, f32),
        observed=full((K,), False, torch.bool),
        frozen_mean=full((K, 9), 0.0, f32),
        frozen_cov=full((K, 9, 9), 0.0, f32),
        last_meas=full((K, 5), 0.0, f32),
        smooth=full((K, F), 0.0, f32),
        bank=full((K, L, F), 0.0, f32),
        bank_count=full((K,), 0, i32),
        frame_count=full((), 0, i32),
        next_id=full((), 0, i32),
        lap_capped=full((), 0, i32),
        oru_replayed=full((), 0, i32),
    )


def state_from_numpy(arrays, device) -> HybridSortState:
    """The port's state from the JAX ``HybridSortState`` fields as numpy
    arrays with a leading S axis (copied: a step may write the bank)."""
    fields = {name: torch.from_numpy(np.array(arrays[name])).to(device) for name in JAX_FIELDS}
    zeros = torch.zeros((fields["active"].shape[0],), dtype=torch.int32, device=device)
    return HybridSortState(**fields, lap_capped=zeros, oru_replayed=zeros.clone())


def state_to_numpy(state: HybridSortState) -> dict:
    """The JAX ``HybridSortState`` fields as numpy arrays with a leading S axis."""
    return {name: getattr(state, name).cpu().numpy() for name in JAX_FIELDS}


def bbox_to_z(box5):
    """[x1, y1, x2, y2, conf] -> [cx, cy, s, c, r] (reference hybridsort.py:46-59)."""
    w = box5[..., 2] - box5[..., 0]
    h = box5[..., 3] - box5[..., 1]
    return torch.stack([box5[..., 0] + w / 2.0, box5[..., 1] + h / 2.0,
                        torch.clamp_min(w * h, 1e-6), box5[..., 4],
                        torch.clamp_min(w / torch.clamp_min(h, 1e-6), 1e-6)], -1)


def x_to_bbox(mean):
    """state -> [x1, y1, x2, y2] (reference hybridsort.py:61-70)."""
    s, r = mean[..., 2], mean[..., 4]
    w = exact(torch.sqrt, torch.clamp_min(s * r, 1e-12))
    h = s / torch.clamp_min(w, 1e-6)
    cx, cy = mean[..., 0], mean[..., 1]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _unit(dx, dy):
    """(dy, dx) / (|(dx, dy)| + 1e-6)."""
    norm = exact(torch.sqrt, dx * dx + dy * dy) + 1e-6
    return dy / norm, dx / norm


def _emb_dist(smooth, feat):
    """(S, K, D) max(0, 1 - smooth . feat), one ``torch.bmm`` (TF32 off)."""
    return torch.clamp_min(1.0 - torch.bmm(smooth, feat.transpose(1, 2)), 0.0)


def _longterm_dist(bank, bank_count, smooth, feat):
    """(S, K, D) cosine distance of the detections to each track's long-term
    feature: the mean of its valid bank rows (its EMA feature while the bank
    is empty), L2-normalised."""
    L = bank.shape[2]
    valid = torch.arange(L, device=bank.device) < torch.clamp_max(bank_count, L)[..., None]
    bank_sum = torch.where(valid[..., None], bank, 0.0).sum(dim=2)
    long_feat = bank_sum / torch.clamp_min(bank_count, 1).to(torch.float32)[..., None]
    long_feat = torch.where((bank_count > 0)[..., None], long_feat, smooth)
    return _emb_dist(l2_normalize(long_feat), feat)


@functools.lru_cache(maxsize=1)
def _layout() -> kalman.KFLayout:
    return kalman.make_xyscr_layout()


def hybridsort_step(cfg: HybridSortConfig, state: HybridSortState, dets: torch.Tensor,
                    det_valid: torch.Tensor, embs: torch.Tensor, warp: torch.Tensor):
    """One frame of S sequences.

    dets: (S, D, 7) [x1, y1, x2, y2, conf, cls, det_ind], padding rows with
    conf = -1; det_valid (S, D) bool; embs (S, D, feat_dim) each detection's
    appearance; warp (S, 2, 3) the camera-motion affine of each sequence.
    Returns (state, out (S, K, 8), out_mask (S, K)).
    """
    layout = _layout()
    asso = get_asso_func(cfg.asso_func)
    D, R = dets.shape[1], cfg.delta_t
    thr = cfg.iou_threshold
    frame = state.frame_count + 1
    active = state.active

    conf = dets[..., 4].contiguous()
    first = det_valid & (conf > cfg.det_thresh)
    second = det_valid & (conf > cfg.low_thresh) & (conf < cfg.det_thresh)
    det_box = dets[..., :4].contiguous()
    det_box5 = torch.cat([det_box, conf[..., None]], -1)
    det_z = bbox_to_z(det_box5)
    feat = l2_normalize(embs)

    with span("hybridsort.predict"):
        # the camera update: the state's corners warped, the score kept
        # (reference hybridsort.py:203-226)
        wb5 = torch.cat([_apply_affine(x_to_bbox(state.mean), warp), state.mean[..., 3:4]], -1)
        mean = torch.cat([torch.where(active[..., None], bbox_to_z(wb5), state.mean[..., :5]),
                          state.mean[..., 5:]], -1)

        # predict: the area velocity zeroed where it would drive the area negative
        vs = mean[..., 7]
        mean = torch.cat([mean[..., :7], torch.where(vs + mean[..., 2] <= 0, 0.0, vs)[..., None],
                          mean[..., 8:]], -1)
        mean, cov = kalman.predict(layout, mean, state.cov, active)
        age = state.age + active.to(torch.int32)
        hit_streak = torch.where(active & (state.tsu > 0), 0, state.hit_streak)
        tsu = state.tsu + active.to(torch.int32)

        trk_box = x_to_bbox(mean)
        kal_score = torch.clamp(mean[..., 3], cfg.track_thresh, 1.0)
        simple_score = torch.where(
            state.conf_pre < 0, torch.clamp(state.conf, 0.1, cfg.track_thresh),
            torch.clamp(state.conf - (state.conf_pre - state.conf), 0.1, cfg.track_thresh))

        # the observation delta_t frames back (or the nearest later one), from the ring
        k_obs = state.last_obs
        found = torch.zeros_like(active)
        for i in range(R):
            target = age - (R - i)
            slot = torch.clamp(torch.remainder(target, R), 0, R - 1).long()
            hit = ((torch.gather(state.ring_age, 2, slot[..., None])[..., 0] == target)
                   & (target >= 0))
            ring_obs = torch.gather(state.obs_ring, 2,
                                    slot[..., None, None].expand(-1, -1, 1, 5))[:, :, 0]
            k_obs = torch.where((hit & ~found)[..., None], ring_obs, k_obs)
            found = found | hit

    with span("hybridsort.pass1"):
        # pass 1: the configured similarity, the four corner velocities and TCM
        capped = state.lap_capped.clone()
        iou1 = asso(trk_box, det_box)
        angle_cost = torch.zeros_like(iou1)
        valid_vel = (k_obs[..., 4] >= 0)[..., None]
        pi = torch.full_like(iou1, math.pi)
        for ci, corner in enumerate(CORNERS):
            cx, cy = CORNER_COLS[corner]
            Y, X = _unit(det_box[:, None, :, cx] - k_obs[:, :, None, cx],
                         det_box[:, None, :, cy] - k_obs[:, :, None, cy])
            cosang = torch.clamp(state.vel[..., ci, 1:2] * X + state.vel[..., ci, 0:1] * Y,
                                 -1.0, 1.0)
            diff = (math.pi / 2.0 - torch.abs(exact(torch.acos, cosang))) / pi
            angle_cost = angle_cost + valid_vel * diff * cfg.inertia * conf[:, None, :]
        score_dif = torch.abs(kal_score[..., None] - conf[:, None, :])
        sim_combo = iou1 + (angle_cost - score_dif)  # TCM (reference association.py:540-543)
        thre = iou1 - score_dif

        reid = cfg.with_reid
        eg_high = reid and cfg.EG_weight_high_score > 0 and cfg.TCM_first_step
        eg_low = reid and cfg.EG_weight_low_score > 0 and cfg.use_byte
        emb_dist = _emb_dist(state.smooth, feat) if eg_high or eg_low else None
        if eg_high:
            cost1 = -sim_combo + cfg.EG_weight_high_score * emb_dist
            if cfg.with_longterm_reid:
                with span("hybridsort.bank_read"):
                    long_dist = _longterm_dist(state.bank, state.bank_count, state.smooth, feat)
                cost1 = cost1 + cfg.longterm_reid_weight * long_dist
            r2c1 = _full_assignment(cost1, active, first, capped)
            c1 = torch.clamp(r2c1, 0, D - 1)
            bad = _at(thre, c1) < thr
            if cfg.with_longterm_reid_correction:
                bad = bad & (_at(emb_dist, c1) > cfg.longterm_reid_correction_thresh)
            m1 = (r2c1 >= 0) & ~bad
        else:
            usable, r2c_short = _unique_shortcut(iou1, active, first, thr)
            r2c_full = _full_assignment(-sim_combo, active, first, capped)
            r2c1 = torch.where(usable[:, None], r2c_short, r2c_full)
            c1 = torch.clamp(r2c1, 0, D - 1)
            keep = torch.where(usable[:, None], _at(iou1, c1) > thr, _at(thre, c1) >= thr)
            m1 = (r2c1 >= 0) & keep
        dm = scatter_det_flags(r2c1, m1, D)
        matched = m1
        det_col = torch.where(m1, r2c1, -1)

    with span("hybridsort.byte"):
        # the BYTE pass on low-confidence detections (reference hybridsort.py:607-650),
        # on pass 1's similarity (the same function of the same boxes)
        if cfg.use_byte:
            rows2 = active & ~matched
            cost2 = -iou1
            if cfg.TCM_byte_step:
                sdif2 = torch.abs(simple_score[..., None] - conf[:, None, :])
                cost2 = cost2 + cfg.TCM_byte_step_weight * sdif2
            if eg_low:
                cost2 = cost2 + cfg.EG_weight_low_score * emb_dist
            gate2 = _gate(iou1, rows2, second, thr)
            r2c2 = _full_assignment(cost2, rows2 & gate2[:, None], second, capped)
            m2 = _filtered(r2c2, iou1, thr, gate2)
            if eg_low and cfg.with_longterm_reid_correction:
                c2 = torch.clamp(r2c2, 0, D - 1)
                m2 = m2 & (_at(emb_dist, c2) <= cfg.longterm_reid_correction_thresh_low)
            matched = matched | m2
            det_col = torch.where(m2, r2c2, det_col)
            dm = dm | scatter_det_flags(r2c2, m2, D)

    with span("hybridsort.final"):
        # the final chance: leftover high-confidence detections against the last observations
        rows3 = active & ~matched
        cols3 = first & ~dm
        iou3 = asso(state.last_obs[..., :4].contiguous(), det_box)
        gate3 = _gate(iou3, rows3, cols3, thr)
        r2c3 = _full_assignment(-iou3, rows3 & gate3[:, None], cols3, capped)
        m3 = _filtered(r2c3, iou3, thr, gate3)
        matched = matched | m3
        det_col = torch.where(m3, r2c3, det_col)
        dm = dm | scatter_det_flags(r2c3, m3, D)
        c = torch.clamp(det_col, 0, D - 1)

    with span("hybridsort.oru"):
        # ORU: re-found tracks replay the XYSCR filter from their frozen state (K4)
        rejoin = matched & ~state.observed & state.has_obs & (tsu > 1)
        z2 = take(det_z, c).contiguous()
        replayed = state.oru_replayed.clone()
        mean, cov = oru_replay(layout, mean.contiguous(), cov.contiguous(), state.frozen_mean,
                               state.frozen_cov, state.last_meas, z2, rejoin, tsu, replayed)
        mean, cov = kalman.update(layout, mean, cov, z2, matched)

    with span("hybridsort.update"):
        # corner velocities: unit vectors summed over the delta_t window, the
        # last observation where the window holds none
        box_c = take(det_box, c)
        acc = [torch.zeros_like(state.vel[..., 0, :]) for _ in CORNERS]
        any_prev = torch.zeros_like(active)
        for i in range(R):
            target = age - i - 1
            slot = torch.clamp(torch.remainder(target, R), 0, R - 1).long()
            hit = ((torch.gather(state.ring_age, 2, slot[..., None])[..., 0] == target)
                   & (target >= 0))
            prev = torch.gather(state.obs_ring, 2,
                                slot[..., None, None].expand(-1, -1, 1, 5))[:, :, 0]
            for ci, corner in enumerate(CORNERS):
                cx, cy = CORNER_COLS[corner]
                contrib = torch.stack(_unit(box_c[..., cx] - prev[..., cx],
                                            box_c[..., cy] - prev[..., cy]), -1)
                acc[ci] = acc[ci] + torch.where(hit[..., None], contrib, 0.0)
            any_prev = any_prev | hit
        fb = [torch.stack(_unit(box_c[..., cx] - state.last_obs[..., cx],
                                box_c[..., cy] - state.last_obs[..., cy]), -1)
              for cx, cy in (CORNER_COLS[k] for k in CORNERS)]
        new_vel = torch.where(any_prev[..., None, None], torch.stack(acc, -2), torch.stack(fb, -2))
        vel = torch.where((matched & state.has_obs)[..., None, None], new_vel, state.vel)

        # feature updates on pass-1 matches (EMA or adapfs) and the long-term
        # bank's push-front; without ReID none happens
        f = take(feat, c)
        det_conf = take(conf, c)
        smooth, bank, bank_count = state.smooth, state.bank, state.bank_count
        if reid:
            if cfg.adapfs:
                total = torch.clamp_min(state.conf + det_conf, 1e-6)
                pre_w = cfg.alpha * (state.conf / total)
                cur_w = (1 - cfg.alpha) * (det_conf / total)
                s_ = pre_w + cur_w
                sm = (pre_w / s_)[..., None] * state.smooth + (cur_w / s_)[..., None] * f
            else:
                sm = cfg.alpha * state.smooth + (1 - cfg.alpha) * f
            upd = m1[..., None]
            smooth = torch.where(upd, l2_normalize(sm), state.smooth)
            with span("hybridsort.bank_write"):
                bank_row0 = torch.where(upd, f, bank[:, :, 0])
                bank_rest = torch.where(upd[..., None], bank[:, :, :-1], bank[:, :, 1:])
            bank_count = bank_count + m1.to(torch.int32)

        # bookkeeping of the matched slots
        new_obs = torch.cat([box_c, det_conf[..., None]], -1)
        last_obs = torch.where(matched[..., None], new_obs, state.last_obs)
        slot = torch.clamp(torch.remainder(age, R), 0, R - 1).long()
        ring_set = state.obs_ring.scatter(2, slot[..., None, None].expand(-1, -1, 1, 5),
                                          new_obs[:, :, None, :])
        obs_ring = torch.where(matched[..., None, None], ring_set, state.obs_ring)
        ring_age = torch.where(matched[..., None],
                               state.ring_age.scatter(2, slot[..., None], age[..., None]),
                               state.ring_age)
        last_meas = torch.where(matched[..., None], z2, state.last_meas)
        has_obs = state.has_obs | matched
        hits = state.hits + matched.to(torch.int32)
        hit_streak = hit_streak + matched.to(torch.int32)
        det_cls = dets[..., 5].contiguous()
        det_ind = dets[..., 6].contiguous()
        conf_pre = torch.where(matched, state.conf, state.conf_pre)
        conf_s = torch.where(matched, det_conf, state.conf)
        cls_s = torch.where(matched, take(det_cls, c), state.cls)
        det_ind_s = torch.where(matched, take(det_ind, c), state.det_ind)
        tsu = torch.where(matched, 0, tsu)

        # misses: freeze on the first unobserved step; update(None) clears the trend
        miss = active & ~matched
        first_miss = miss & state.observed
        frozen_mean = torch.where(first_miss[..., None], mean, state.frozen_mean)
        frozen_cov = torch.where(first_miss[..., None, None], cov, state.frozen_cov)
        observed = torch.where(active, matched, state.observed)
        conf_pre = torch.where(miss, -1.0, conf_pre)

    with span("hybridsort.births"):
        # new tracks from the unmatched high-confidence detections, into free slots in order
        n_new, free_rank, takes, slot_det = allocate(first & ~dm, ~active)
        init_mean_v, init_cov_v = kalman.initiate(layout, take(det_z, slot_det))
        mean = torch.where(takes[..., None], init_mean_v, mean)
        cov = torch.where(takes[..., None, None], init_cov_v, cov)
        active = active | takes
        tid = torch.where(takes, state.next_id[:, None] + free_rank, state.tid)
        conf_s = torch.where(takes, take(conf, slot_det), conf_s)
        conf_pre = torch.where(takes, -1.0, conf_pre)
        cls_s = torch.where(takes, take(det_cls, slot_det), cls_s)
        det_ind_s = torch.where(takes, take(det_ind, slot_det), det_ind_s)
        age = torch.where(takes, 0, age)
        tsu = torch.where(takes, 0, tsu)
        hits = torch.where(takes, 0, hits)
        hit_streak = torch.where(takes, 0, hit_streak)
        has_obs = has_obs & ~takes
        observed = observed & ~takes
        vel = torch.where(takes[..., None, None], 0.0, vel)
        last_obs = torch.where(takes[..., None], -1.0, last_obs)
        ring_age = torch.where(takes[..., None], -1, ring_age)
        born = take(feat, slot_det)
        smooth = torch.where(takes[..., None], born, smooth)
        bank_count = torch.where(takes, 1, bank_count)
        with span("hybridsort.bank_write"):
            if reid:
                # a birth empties the bank and writes its feature first
                bank_row0 = torch.where(takes[..., None], born, bank_row0)
                bank_rest = torch.where(takes[..., None, None], 0.0, bank_rest)
                bank = torch.cat([bank_row0[:, :, None], bank_rest], dim=2)
            else:
                bank[:, :, 0] = torch.where(takes[..., None], born, bank[:, :, 0])

        # removal
        active = active & ~(tsu > cfg.max_age)

        # output: tid + 1, the last observation box where there is one
        out_box = torch.where(has_obs[..., None], last_obs[..., :4], x_to_bbox(mean))
        warm = (hit_streak >= cfg.min_hits) | (frame[:, None] <= cfg.min_hits)
        out_mask = active & (tsu < 1) & warm
        out = torch.cat([out_box, (tid + 1)[..., None].to(torch.float32), conf_s[..., None],
                         cls_s[..., None], det_ind_s[..., None]], dim=-1)

    new_state = HybridSortState(
        mean=mean,
        cov=cov,
        active=active,
        age=age.to(torch.int32),
        tsu=tsu.to(torch.int32),
        hits=hits.to(torch.int32),
        hit_streak=hit_streak.to(torch.int32),
        tid=tid.to(torch.int32),
        conf=conf_s,
        conf_pre=conf_pre,
        cls=cls_s,
        det_ind=det_ind_s,
        last_obs=last_obs,
        has_obs=has_obs,
        obs_ring=obs_ring,
        ring_age=ring_age.to(torch.int32),
        vel=vel,
        observed=observed,
        frozen_mean=frozen_mean,
        frozen_cov=frozen_cov,
        last_meas=last_meas,
        smooth=smooth,
        bank=bank,
        bank_count=bank_count.to(torch.int32),
        frame_count=frame,
        next_id=state.next_id + n_new,
        lap_capped=capped,
        oru_replayed=replayed,
    )
    return new_state, out, out_mask


class HybridSort(BaseTracker):
    """Live tracker with the JAX ``HybridSort`` constructor surface.

    With ``with_reid`` the embeddings passed to ``update(dets, img, embs)``
    feed the appearance terms; without them ``reid_model`` (e.g.
    ``reid.ReID``) computes them from the image, and without a model the
    features are rows of ones, with one warning, as in the JAX tracker
    (``with_reid`` is honoured without a model).  CMC is ``cmc_method`` (ECC
    by default, on the tracker's device).  Internal ids start at 0 and are
    emitted as tid + 1."""

    supports_obb = False
    _id_emit_offset = 1

    def __init__(
        self,
        device,
        reid_model=None,
        cmc_method: str = "ecc",
        with_reid: bool = True,
        low_thresh: float = 0.1,
        delta_t: int = 3,
        inertia: float = 0.05,
        use_byte: bool = True,
        longterm_bank_length: int = 30,
        alpha: float = 0.9,
        adapfs: bool = False,
        track_thresh: float = 0.5,
        EG_weight_high_score: float = 4.6,
        EG_weight_low_score: float = 1.3,
        TCM_first_step: bool = True,
        TCM_byte_step: bool = True,
        TCM_byte_step_weight: float = 1.0,
        high_score_matching_thresh: float = 0.7,
        with_longterm_reid: bool = True,
        longterm_reid_weight: float = 0.0,
        with_longterm_reid_correction: bool = True,
        longterm_reid_correction_thresh: float = 0.4,
        longterm_reid_correction_thresh_low: float = 0.4,
        dataset: str = "",
        capacity: int = 256,
        **kwargs,
    ):
        super().__init__(device=device, **kwargs)
        self.with_reid = bool(with_reid)
        self.model = reid_model if self.with_reid else None
        self.dataset = str(dataset)  # an association hint the reference leaves inactive
        self._warned_no_feats = False
        self.cfg = HybridSortConfig(
            det_thresh=self.det_thresh,
            low_thresh=low_thresh,
            max_age=self.max_age,
            min_hits=self.min_hits,
            iou_threshold=self.iou_threshold,
            delta_t=delta_t,
            inertia=inertia,
            use_byte=use_byte,
            track_thresh=track_thresh,
            alpha=alpha,
            adapfs=adapfs,
            longterm_bank_length=longterm_bank_length,
            with_reid=self.with_reid,
            EG_weight_high_score=EG_weight_high_score if self.with_reid else 0.0,
            EG_weight_low_score=EG_weight_low_score if self.with_reid else 0.0,
            TCM_first_step=TCM_first_step,
            TCM_byte_step=TCM_byte_step,
            TCM_byte_step_weight=TCM_byte_step_weight,
            with_longterm_reid=with_longterm_reid,
            longterm_reid_weight=longterm_reid_weight,
            with_longterm_reid_correction=with_longterm_reid_correction,
            longterm_reid_correction_thresh=longterm_reid_correction_thresh,
            longterm_reid_correction_thresh_low=longterm_reid_correction_thresh_low,
            asso_func=self.asso_func_name,
            feat_dim=model_feature_dim(reid_model) if self.model else (
                512 if self.with_reid else 1),
            capacity=capacity,
        )
        from boxmot_tpu_torch.motion.cmc import create_cmc

        self.cmc = create_cmc(cmc_method, device=self.device)

    def _init_state(self):
        return init_state(self.cfg, 1, self.device)

    def _step(self, state, dets_padded, det_valid):
        img, embs, dets = self._frame_inputs
        n, D = len(dets), dets_padded.shape[0]
        if not (self.with_reid and n):
            embs = None
        elif embs is None and (self.model is None or img is None) and not self._warned_no_feats:
            # the reference errors out here (its model is None); the
            # features are constant instead, said once
            self._warned_no_feats = True
            LOGGER.warning("hybridsort: with_reid=True but no reid_model and no embs supplied — "
                           "appearance terms see constant features; pass with_reid=False for "
                           "motion-only")
        emb = frame_embs(self.model, embs, img, dets[:, :4], D, self.cfg.feat_dim, self.device,
                         fill=1.0)
        if self.cmc is not None and img is not None:
            warp = self.cmc.apply(img, dets[:, :4])
        else:
            warp = IDENTITY_WARP
        state, out, out_mask = hybridsort_step(self.cfg, state, dets_padded[None], det_valid[None],
                                               emb[None], warp_tensor(warp, self.device)[None])
        return state, out[0], out_mask[0]
