"""OccluBoost (AABB and OBB) as a fixed-capacity slot bank, batched over S sequences.

Counterpart of ``boxmot_tpu/trackers/occluboost.py``: BoostTrack's
multi-cue association and DLO/DUO boosts on the XYHR filter, with

* abnormal-motion suppression (AMS): each slot's ring of observed boxes
  detects centre and scale speed spikes and damps the Kalman mean's gain
  (``kalman.update(..., gain_scale)``);
* a ReID-only recovery pass, an appearance-gated low-confidence second
  pass and a pure-appearance GTA recovery against recently lost tracks;
* BoT-SORT-style confirmation of tentative tracks;
* a graveyard of 64 dead tracks whose ids detections can take again
  (resurrection), with linearly interpolated gap rows for the frames they
  missed, kept in a 4096-row buffer per sequence;
* duplicate suppression that keeps the older of two emitted tracks.

The oriented path (``is_obb``) runs the XYHR filter with theta, rotated IoU
(kernel K3) and a BoT-SORT-style first-pass cost, and skips CMC, the boosts
and AMS.  The axis-aligned IoUs run on kernel K1's IoU-only mode (tracks
first; the detection x track matrices read its transpose, which is exact,
see ``trackers.boosttrack``), the assignments on kernel K2.

The JAX step skips the gap fill with a ``lax.cond`` on frames without a
resurrection; here it always runs, masked (8 resurrections x 63 frames), so
no host read decides it.  The step uses masks and ``torch.where`` only, so
on a CUDA device a replay runs without a host sync.  As in the JAX package
the duplicate loop is vectorized, the graveyard has 64 slots and at most 8
resurrections a frame fill gaps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from boxmot_tpu_torch.motion import kalman
from boxmot_tpu_torch.ops.geometry import exact, wrap_angle
from boxmot_tpu_torch.ops.lap import masked_assignment
from boxmot_tpu_torch.ops.rotated_iou import rotated_iou
from boxmot_tpu_torch.trackers.base import BaseTracker
from boxmot_tpu_torch.trackers.boosttrack import (
    _div,
    _duo_apply,
    _sum64,
    at_kd,
    boost_cost,
    camera_update_xyhr,
    dlo_boost,
    duo_boost,
    emb_products,
    gate_order_rank,
    iou_kd,
    live_cmc,
    mh_distance,
    obb2xyhr,
    ranked_allocate,
    shape_ok,
    track_confidence,
    xyhr2obb,
    xyhr2xyxy,
    xyxy2xyhr,
)
from boxmot_tpu_torch.trackers.botsort import (
    IDENTITY_WARP,
    BotSort,
    frame_embs,
    l2_normalize,
    model_feature_dim,
    warp_tensor,
)
from boxmot_tpu_torch.trackers.ocsort import _full_assignment, _unique_shortcut
from boxmot_tpu_torch.trackers.slots import scatter_det_flags, take

GRAVE_SLOTS = 64
GAP_BUF = 4096
MAX_RES_PER_FRAME = 8
MAX_GAP_FILL = 64


@dataclasses.dataclass(frozen=True)
class OccluBoostConfig:
    """Field for field the JAX ``OccluBoostConfig``, with the same defaults."""

    det_thresh: float = 0.5
    max_age: int = 30
    min_hits: int = 3
    iou_threshold: float = 0.3
    min_box_area: int = 10
    aspect_ratio_thresh: float = 1.6
    lambda_iou: float = 0.5
    lambda_mhd: float = 0.25
    lambda_shape: float = 0.25
    use_dlo_boost: bool = True
    use_duo_boost: bool = True
    dlo_boost_coef: float = 0.65
    s_sim_corr: bool = False
    use_rich_s: bool = False
    use_sb: bool = False
    use_vt: bool = False
    with_reid: bool = True
    feat_dim: int = 512
    recovery_appearance_thresh: float = 0.99
    recovery_iou_thresh: float = 0.1
    recovery_max_age: int = 1
    feat_alpha: float = 0.95
    track_low_thresh: float = 0.1
    second_iou_thresh: float = 0.6
    second_appearance_thresh: float = 0.5
    second_pass_max_age: int = 1
    second_pass_min_hits: int = 3
    use_second_pass: bool = False
    new_track_thresh: float = 0.6
    confirm_hits: int = 2
    instant_confirm_thresh: float = 0.7
    tentative_max_age: int = 1
    duplicate_iou_thresh: float = 0.85
    ams_enabled: bool = True
    ams_alpha0: float = 0.4
    ams_threshold: float = 0.5
    ams_buffer_size: int = 30
    ams_shrink_ratio: float = 0.75
    lambda_emb_multiplier: float = 1.5
    gta_enabled: bool = True
    gta_appearance_thresh: float = 0.5
    gta_min_track_length: int = 5
    gta_interpolate: bool = True
    gta_max_gap: int = 60
    is_obb: bool = False  # oriented boxes: rotated IoU, no CMC, boosts or AMS
    capacity: int = 256


@dataclasses.dataclass
class OccluBoostState:
    """S slot banks of capacity K.  The fields up to ``next_id`` are the JAX
    ``OccluBoostState`` fields with a leading S axis."""

    mean: torch.Tensor  # (S, K, 8) xyhr + velocities; (S, K, 10) with theta (OBB)
    cov: torch.Tensor  # (S, K, 8, 8); (S, K, 10, 10)
    active: torch.Tensor  # (S, K) bool
    age: torch.Tensor  # (S, K) int32
    tsu: torch.Tensor  # (S, K) int32 time since update
    hit_streak: torch.Tensor  # (S, K) int32
    tid: torch.Tensor  # (S, K) int32
    conf: torch.Tensor  # (S, K) f32
    cls: torch.Tensor  # (S, K) f32
    det_ind: torch.Tensor  # (S, K) f32
    emb: torch.Tensor  # (S, K, F) unit appearance (written with with_reid)
    is_activated: torch.Tensor  # (S, K) bool: confirmed
    ams_ring: torch.Tensor  # (S, K, B, 4) observed cxcywh boxes by count % B
    ams_count: torch.Tensor  # (S, K) int32 observations written
    g_valid: torch.Tensor  # (S, G) bool graveyard slots in use
    g_emb: torch.Tensor  # (S, G, F)
    g_box: torch.Tensor  # (S, G, 4) last emitted box (xyxy; cxcywh for OBB)
    g_frame: torch.Tensor  # (S, G) int32 frame of burial
    g_conf: torch.Tensor  # (S, G) f32
    g_cls: torch.Tensor  # (S, G) f32
    g_gid: torch.Tensor  # (S, G) int32 the buried track's id
    gap_rows: torch.Tensor  # (S, GAP_BUF, 9) [frame, id, x1, y1, x2, y2, conf, cls, -1]
    gap_count: torch.Tensor  # (S,) int32 rows written
    frame_count: torch.Tensor  # (S,) int32
    next_id: torch.Tensor  # (S,) int32
    lap_capped: torch.Tensor  # (S,) int32 solves that stopped at the iteration cap
    resurrections: torch.Tensor  # (S,) int32 detections that took a buried track's id


JAX_FIELDS = tuple(f.name for f in dataclasses.fields(OccluBoostState))[:-2]


def init_state(cfg: OccluBoostConfig, n: int, device) -> OccluBoostState:
    """n fresh slot banks on ``device``."""
    K, F, B, G = cfg.capacity, cfg.feat_dim, cfg.ams_buffer_size, GRAVE_SLOTS
    dx = 10 if cfg.is_obb else 8

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros((n, *shape), dtype=dtype, device=device)

    f32, b = torch.float32, torch.bool
    return OccluBoostState(
        mean=zeros(K, dx, dtype=f32), cov=zeros(K, dx, dx, dtype=f32), active=zeros(K, dtype=b),
        age=zeros(K), tsu=zeros(K), hit_streak=zeros(K), tid=zeros(K),
        conf=zeros(K, dtype=f32), cls=zeros(K, dtype=f32), det_ind=zeros(K, dtype=f32),
        emb=zeros(K, F, dtype=f32), is_activated=zeros(K, dtype=b),
        ams_ring=zeros(K, B, 4, dtype=f32), ams_count=zeros(K),
        g_valid=zeros(G, dtype=b), g_emb=zeros(G, F, dtype=f32), g_box=zeros(G, 4, dtype=f32),
        g_frame=zeros(G), g_conf=zeros(G, dtype=f32), g_cls=zeros(G, dtype=f32), g_gid=zeros(G),
        gap_rows=zeros(GAP_BUF, 9, dtype=f32), gap_count=zeros(), frame_count=zeros(),
        next_id=torch.ones((n,), dtype=torch.int32, device=device), lap_capped=zeros(),
        resurrections=zeros(),
    )


def _gather_ring(ring, pos):
    """ring (S, K, B, 4) at each slot's position pos (S, K) -> (S, K, 4)."""
    idx = pos.long()[..., None, None].expand(-1, -1, 1, ring.shape[-1])
    return torch.gather(ring, 2, idx)[:, :, 0]


def _norm2(v):
    """sqrt(v0^2 + v1^2) along the last axis (of length 2), the root correctly rounded."""
    return exact(torch.sqrt, v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _ams_alpha(cfg, ring, count, cur):
    """Each slot's AMS gain scale (S, K), from its ring (S, K, B, 4) of
    past cxcywh observations, their count (S, K) and the observation cur
    (S, K, 4) about to be appended."""
    B = ring.shape[2]
    live = torch.clamp_max(count, B)
    prev = _gather_ring(ring, torch.clamp((count - 1) % B, 0, B - 1))
    oldest = _gather_ring(ring, torch.clamp((count - live) % B, 0, B - 1))

    cur_v = cur - prev
    # the mean of consecutive differences telescopes to (last - first)/(n - 1)
    mean_v = (prev - oldest) / torch.clamp_min(live - 1, 1).to(torch.float32)[..., None]
    eps = 1e-6
    cur_c, mean_c = _norm2(cur_v[..., :2]), _norm2(mean_v[..., :2])
    cur_a, mean_a = _norm2(cur_v[..., 2:]), _norm2(mean_v[..., 2:])
    d_c = torch.clamp_min(cur_c - mean_c, 0.0) / torch.clamp_min(mean_c, eps)
    d_a = torch.clamp_min(cur_a - mean_a, 0.0) / torch.clamp_min(mean_a, eps)
    alpha_c = torch.where(d_c <= cfg.ams_threshold, 1.0, cfg.ams_alpha0)
    alpha_a = torch.where(d_a <= cfg.ams_threshold, 1.0, cfg.ams_alpha0)
    alpha = 0.5 * (alpha_c + alpha_a)

    # the shrink-ratio check: only genuinely shrinking boxes are suppressed
    live_mask = torch.arange(B, device=ring.device) < live[..., None]
    areas = torch.where(live_mask, ring[..., 2] * ring[..., 3], 0.0)
    mean_area = _sum64(areas, 2) / torch.clamp_min(live, 1).to(torch.float32)
    alpha = torch.where(cur[..., 2] * cur[..., 3] >= mean_area * cfg.ams_shrink_ratio, 1.0, alpha)
    alpha = torch.where(live >= 2, alpha, 1.0)
    if not cfg.ams_enabled or cfg.ams_alpha0 >= 1.0:
        alpha = torch.ones_like(alpha)
    return alpha


def _ams_append(ring, count, cur, mask):
    """Write cur (S, K, 4) at count % B of the slots in ``mask``."""
    B = ring.shape[2]
    pos = torch.clamp(count % B, 0, B - 1).long()[..., None, None].expand(-1, -1, 1, 4)
    old = torch.gather(ring, 2, pos)
    ring = ring.scatter(2, pos, torch.where(mask[..., None, None], cur[:, :, None, :], old))
    return ring, count + mask.to(torch.int32)


def _gated_lsa_max(sim, row_mask, col_mask, capped):
    """Maximise the similarity (S, R, C) over gated pairs (entries <= 0 are
    invalid): a full assignment of -sim (kernel K2), kept where sim > 0."""
    r2c = _full_assignment((-sim).contiguous(), row_mask, col_mask, capped)
    c = torch.clamp(r2c, 0, sim.shape[2] - 1)
    ok = (r2c >= 0) & (torch.gather(sim, 2, c.long()[..., None])[..., 0] > 0)
    return torch.where(ok, r2c, -1)


def _gap_fill(cfg, frame, res_det, res_gslot, res_gid, det_box, g, gap_rows, gap_count):
    """Append the linearly interpolated rows of the frames each resurrected
    track missed (at most MAX_RES_PER_FRAME resurrections, the first in
    detection order) to the gap buffer (S, GAP_BUF, 9), dropping rows past
    its end.  ``g`` is (g_frame, g_box, g_conf, g_cls) before this frame's
    burials."""
    g_frame, g_box, g_conf, g_cls = g
    S, D = res_det.shape
    R = min(MAX_RES_PER_FRAME, D)
    order = torch.argsort((~res_det).to(torch.int32), dim=1, stable=True)[:, :R]
    gs = take(res_gslot, order)
    death = take(g_frame, gs)
    gap = frame - death
    do_fill = take(res_det, order) & (gap > 1) & (gap <= cfg.gta_max_gap)
    last_box = take(g_box, gs)
    cur_box = take(det_box[..., :4].contiguous(), order)  # OBB keeps cx, cy, w, h, as JAX
    t = torch.arange(1, MAX_GAP_FILL, dtype=torch.int32, device=res_det.device)
    in_gap = do_fill[..., None] & (t < gap[..., None])  # (S, R, T)
    a_t = t.to(torch.float32) / torch.clamp_min(gap.to(torch.float32), 1.0)[..., None]
    ib = (1 - a_t)[..., None] * last_box[:, :, None, :] + a_t[..., None] * cur_box[:, :, None, :]
    frames_rt = (death[..., None] + t).to(torch.float32)

    def col(v):  # (S, R) -> (S, R, T, 1)
        return v.to(torch.float32)[..., None, None].expand(frames_rt.shape + (1,))

    rows = torch.cat([frames_rt[..., None], col(take(res_gid, order)), ib, col(take(g_conf, gs)),
                      col(take(g_cls, gs)), torch.full_like(frames_rt, -1.0)[..., None]], dim=-1)
    rows = rows.reshape(S, -1, 9)
    flat_valid = in_gap.reshape(S, -1)
    offsets = torch.cumsum(flat_valid, dim=1) - 1
    pos = torch.where(flat_valid, gap_count[:, None] + offsets, GAP_BUF)
    pos = torch.clamp_max(pos, GAP_BUF).long()  # past the end: the spare row, cut off
    spare = torch.zeros((S, 1, 9), dtype=gap_rows.dtype, device=gap_rows.device)
    gap_rows = torch.cat([gap_rows, spare], 1).scatter(1, pos[..., None].expand(-1, -1, 9),
                                                       rows)[:, :GAP_BUF]
    gap_count = torch.clamp_max(gap_count + flat_valid.sum(dim=1, dtype=torch.int32), GAP_BUF)
    return gap_rows, gap_count.to(torch.int32)


def occluboost_step(cfg: OccluBoostConfig, state: OccluBoostState, dets: torch.Tensor,
                    det_valid: torch.Tensor, embs: torch.Tensor | None,
                    warp: torch.Tensor | None):
    """One frame of S sequences.

    dets: (S, D, 7) [x1, y1, x2, y2, conf, cls, det_ind], or (S, D, 8)
    [cx, cy, w, h, theta, conf, cls, det_ind] when ``cfg.is_obb``; padding
    rows with conf = -1; det_valid (S, D) bool; embs (S, D, feat_dim), each
    detection's appearance (None when ``cfg.with_reid`` is off, which never
    reads it); warp (S, 2, 3), each sequence's camera-motion affine (None in
    OBB mode, which applies none).  Returns (state, out (S, K, 8) or
    (S, K, 9), out_mask (S, K)).
    """
    obb = cfg.is_obb
    layout = kalman.make_xyhr_layout(obb=obb)
    S, D = dets.shape[:2]
    K = cfg.capacity
    B = 5 if obb else 4  # box columns
    frame = (state.frame_count + 1)[:, None]
    active = state.active
    reid = cfg.with_reid
    gta = cfg.gta_enabled and reid

    det_box = dets[..., :B].contiguous()
    conf = torch.where(det_valid, dets[..., B], -1.0)
    orig_conf = conf
    det_cls = dets[..., B + 1].contiguous()
    det_ind = dets[..., B + 2].contiguous()

    # camera update (AABB) and predict
    mean = state.mean if obb else camera_update_xyhr(state.mean, warp, active)
    mean, cov = kalman.predict(layout, mean, state.cov, active)
    act = active.to(torch.int32)
    age = state.age + act
    hit_streak = torch.where(active & (state.tsu > 0), 0, state.hit_streak)
    tsu = state.tsu + act

    if obb:
        trk_box = xyhr2obb(mean).contiguous()
        det_z = obb2xyhr(det_box)
        # tracks x detections, for the recovery and second passes (rotated
        # IoU is not symmetric to the bit, so pass 1's own order is a second launch)
        need_td = reid or cfg.use_second_pass
        iou_td = rotated_iou(trk_box, det_box) if need_td else None
    else:
        trk_conf = track_confidence(age, tsu, active)
        trk_box = xyhr2xyxy(mean[..., :4])
        det_z = xyxy2xyhr(det_box)
        md = mh_distance(det_box, mean, cov)
        pair_valid = det_valid[:, :, None] & active[:, None, :]
        iou_td = iou_kd(trk_box, det_box)
        iou = iou_td.transpose(1, 2)  # (S, D, K), exact (trackers.boosttrack)
        if cfg.use_dlo_boost:
            conf = dlo_boost(cfg, conf, det_valid, det_box, trk_box, trk_conf, tsu, md,
                             pair_valid, iou)
        if cfg.use_duo_boost:
            conf = _duo_apply(cfg, conf, det_box,
                              duo_boost(cfg, conf, det_valid, md, pair_valid, active))

    first = det_valid & (conf >= cfg.det_thresh)
    if cfg.use_second_pass:
        second = (det_valid & ~first & (orig_conf >= cfg.track_low_thresh)
                  & (orig_conf < cfg.det_thresh))
    det_emb = l2_normalize(embs) if reid else None
    capped = state.lap_capped.clone()

    if reid:
        emb_cost = emb_products(det_emb, state.emb)  # (S, D, K)
    if obb:
        # pass 1: rotated IoU cost gated at iou_threshold, with appearance fused
        iou_dk = rotated_iou(det_box, trk_box)
        gate1 = iou_dk < cfg.iou_threshold
        cost = torch.where(gate1, 1e6, 1.0 - iou_dk)
        if reid:
            cost = torch.where(gate1, 1e6, cost - (cfg.lambda_iou + 0.5) * emb_cost)
        cost_kd = cost.transpose(1, 2).contiguous()
        r2c1 = _full_assignment(cost_kd, active, first, capped)
        c1 = torch.clamp(r2c1, 0, D - 1)
        m1 = (r2c1 >= 0) & (torch.gather(cost_kd, 2, c1.long()[..., None])[..., 0] < 1e5)
        inv_det1 = torch.zeros_like(first)
    else:
        # pass 1: BoostTrack's multi-cue association
        valid_dk = first[:, :, None] & active[:, None, :]
        iou_dk = torch.where(valid_dk, iou, 0.0)
        cost = boost_cost(cfg, det_box, trk_box, conf, trk_conf, md, iou_dk, valid_dk,
                          emb_cost if reid else torch.zeros_like(iou_dk),
                          cfg.lambda_emb_multiplier)
        cost_kd = cost.transpose(1, 2)
        usable, r2c_short = _unique_shortcut(cost_kd, active, first, cfg.iou_threshold)
        r2c_full = _full_assignment((-cost_kd).contiguous(), active, first, capped)
        r2c1 = torch.where(usable[:, None], r2c_short, r2c_full)
        c1 = torch.clamp(r2c1, 0, D - 1)
        iou_of = at_kd(iou_dk, c1)
        valid1 = iou_of >= cfg.iou_threshold
        if reid:
            valid1 = valid1 | ((at_kd(emb_cost, c1) >= 0.75) & (iou_of >= cfg.iou_threshold / 2))
        m1 = (r2c1 >= 0) & valid1
        # detections whose assignment failed the gate go to the end of the
        # reference's unmatched order (the OBB branch's is ascending)
        inv_det1 = scatter_det_flags(r2c1, (r2c1 >= 0) & ~valid1, D)

    unmatched_trk0 = active & ~m1
    dm = scatter_det_flags(r2c1, m1, D)

    trust = _div(conf - cfg.det_thresh, 1 - cfg.det_thresh)
    det_alpha_all = 0.95 + 0.05 * (1 - trust)
    carry = dict(mean=mean, cov=cov, ring=state.ams_ring, count=state.ams_count, emb=state.emb,
                 streak=hit_streak, tsu=tsu, conf=state.conf, cls=state.cls, dind=state.det_ind)

    def apply_update(matched, det_idx, alpha_emb):
        """The KF update with the AMS gain, the embedding EMA and the
        bookkeeping of one pass's matches (S, K) to det_idx (S, K)."""
        cc = torch.clamp(det_idx, 0, D - 1)
        z = take(det_z, cc)
        m = carry["mean"]
        if obb:
            # no AMS for oriented tracks; the measurement angle aligns to the state
            alpha = None
            z = torch.cat([z[..., :4], (m[..., 4] + wrap_angle(z[..., 4] - m[..., 4]))[..., None]],
                          -1)
        else:
            db = take(det_box, cc)
            cxcywh = torch.stack([(db[..., 0] + db[..., 2]) / 2, (db[..., 1] + db[..., 3]) / 2,
                                  torch.clamp_min(db[..., 2] - db[..., 0], 1e-6),
                                  torch.clamp_min(db[..., 3] - db[..., 1], 1e-6)], -1)
            alpha = _ams_alpha(cfg, carry["ring"], carry["count"], cxcywh)
            carry["ring"], carry["count"] = _ams_append(carry["ring"], carry["count"], cxcywh,
                                                        matched)
        carry["mean"], carry["cov"] = kalman.update(layout, m, carry["cov"], z, matched,
                                                    gain_scale=alpha)
        if reid:
            a = alpha_emb[..., None]
            new_emb = l2_normalize(a * carry["emb"] + (1 - a) * take(det_emb, cc))
            carry["emb"] = torch.where(matched[..., None], new_emb, carry["emb"])
        carry["streak"] = carry["streak"] + matched.to(torch.int32)
        carry["tsu"] = torch.where(matched, 0, carry["tsu"])
        carry["conf"] = torch.where(matched, take(conf, cc), carry["conf"])
        carry["cls"] = torch.where(matched, take(det_cls, cc), carry["cls"])
        carry["dind"] = torch.where(matched, take(det_ind, cc), carry["dind"])

    feat_alpha = torch.full((S, K), cfg.feat_alpha, device=dets.device)
    apply_update(m1, r2c1, take(det_alpha_all, c1))
    is_activated = state.is_activated | (m1 & (carry["streak"] >= cfg.confirm_hits))
    det_unmatched = first & ~dm

    # ReID-only recovery against the predicted boxes
    if reid:
        elig = unmatched_trk0 & (carry["tsu"] <= cfg.recovery_max_age)
        sim = emb_products(carry["emb"], det_emb)  # (S, K, D), the updated embeddings
        gated = torch.where(iou_td < cfg.recovery_iou_thresh, -1.0, sim)
        gated = torch.where(sim < cfg.recovery_appearance_thresh, -1.0, gated)
        r2c_rec = _gated_lsa_max(gated, elig, det_unmatched, capped)
        m_rec = r2c_rec >= 0
        apply_update(m_rec, r2c_rec, feat_alpha)
        is_activated = is_activated | (m_rec & (carry["streak"] >= cfg.confirm_hits))
        dm = dm | scatter_det_flags(r2c_rec, m_rec, D)
        det_unmatched = first & ~dm

    # appearance-gated low-confidence second pass
    if cfg.use_second_pass:
        elig2 = (unmatched_trk0 & (carry["tsu"] <= cfg.second_pass_max_age)
                 & (carry["streak"] >= cfg.second_pass_min_hits) & is_activated)
        cost2 = torch.where(iou_td < cfg.second_iou_thresh, 1.0, 1.0 - iou_td)
        if reid:
            sim2 = emb_products(carry["emb"], det_emb)
            cost2 = torch.where(sim2 < cfg.second_appearance_thresh, 1.0, cost2)
        r2c_2 = masked_assignment(cost2.contiguous(), elig2, second, 1.0, capped)
        m_2 = r2c_2 >= 0
        apply_update(m_2, r2c_2, feat_alpha)
        is_activated = is_activated | (m_2 & (carry["streak"] >= cfg.confirm_hits))

    # GTA: pure-appearance recovery of alive but drifted tracks
    if gta:
        elig_g = (unmatched_trk0 & (carry["tsu"] <= cfg.gta_max_gap)
                  & (age >= cfg.gta_min_track_length))
        sim_g = emb_products(carry["emb"], det_emb)
        gated_g = torch.where(sim_g < cfg.gta_appearance_thresh, -1.0, sim_g)
        r2c_g = _gated_lsa_max(gated_g, elig_g, det_unmatched, capped)
        m_g = r2c_g >= 0
        apply_update(m_g, r2c_g, feat_alpha)
        is_activated = is_activated | (m_g & (carry["streak"] >= cfg.confirm_hits))
        dm = dm | scatter_det_flags(r2c_g, m_g, D)
        det_unmatched = first & ~dm

    # GTA: graveyard resurrection (detections x graveyard slots)
    g_valid, g_emb, g_box, g_frame = state.g_valid, state.g_emb, state.g_box, state.g_frame
    g_conf, g_cls, g_gid = state.g_conf, state.g_cls, state.g_gid
    gap_rows, gap_count = state.gap_rows, state.gap_count
    res_det = torch.zeros_like(first)
    if gta:
        res_cand = det_unmatched & (conf >= cfg.new_track_thresh)
        sim_r = emb_products(det_emb, g_emb)  # (S, D, G)
        gated_r = torch.where(sim_r < cfg.gta_appearance_thresh, -1.0, sim_r)
        d2g = _gated_lsa_max(gated_r, res_cand, g_valid, capped)
        res_det = d2g >= 0
        res_gslot = torch.clamp(d2g, 0, GRAVE_SLOTS - 1)
        res_gid = take(g_gid, res_gslot)
        g_valid = g_valid & ~scatter_det_flags(res_gslot, res_det, GRAVE_SLOTS)

    # new tracks, resurrected ones with their old ids
    new_det = det_unmatched & (conf >= cfg.new_track_thresh)
    fresh = new_det & ~res_det
    n_fresh = fresh.sum(dim=1, dtype=torch.int32)
    det_tid = state.next_id[:, None] + gate_order_rank(fresh, inv_det1)
    if gta:
        det_tid = torch.where(res_det, res_gid, det_tid)
    _, free_rank, takes, slot_det = ranked_allocate(new_det, torch.cumsum(new_det, dim=1) - 1,
                                                    ~active)
    init_mean, init_cov = kalman.initiate(layout, take(det_z, slot_det))
    mean = torch.where(takes[..., None], init_mean, carry["mean"])
    cov = torch.where(takes[..., None, None], init_cov, carry["cov"])
    active2 = active | takes
    tid = torch.where(takes, take(det_tid, slot_det), state.tid)
    slot_conf = take(conf, slot_det)
    conf_s = torch.where(takes, slot_conf, carry["conf"])
    cls_s = torch.where(takes, take(det_cls, slot_det), carry["cls"])
    det_ind_s = torch.where(takes, take(det_ind, slot_det), carry["dind"])
    age = torch.where(takes, 0, age)
    tsu = torch.where(takes, 0, carry["tsu"])
    hit_streak = torch.where(takes, 0, carry["streak"])
    emb = carry["emb"]
    if reid:
        emb = torch.where(takes[..., None], take(det_emb, slot_det), emb)
    count = torch.where(takes, 0, carry["count"])
    new_activated = take(res_det, slot_det) | (slot_conf >= cfg.instant_confirm_thresh)
    if cfg.confirm_hits <= 1:
        new_activated = torch.ones_like(new_activated)
    is_activated = torch.where(takes, new_activated, is_activated)

    # the resurrections' gap rows (the JAX step skips this on frames without one)
    if gta and cfg.gta_interpolate:
        gap_rows, gap_count = _gap_fill(cfg, frame, res_det, res_gslot, res_gid, det_box,
                                        (g_frame, g_box, g_conf, g_cls), gap_rows, gap_count)

    # emission and duplicate suppression, which keeps the older track
    out_box = xyhr2obb(mean).contiguous() if obb else xyhr2xyxy(mean[..., :4])
    emit = (active2 & (tsu < 1) & is_activated
            & ((hit_streak >= cfg.min_hits) | (frame <= cfg.min_hits)))
    if 0.0 < cfg.duplicate_iou_thresh < 1.0:
        pij = rotated_iou(out_box, out_box) if obb else iou_kd(out_box, out_box)
        pij = torch.where(emit[:, :, None] & emit[:, None, :], pij, 0.0)
        pij = pij - torch.eye(K, dtype=pij.dtype, device=pij.device) * pij
        older = age[:, :, None] >= age[:, None, :]
        kill = torch.any((pij >= cfg.duplicate_iou_thresh) & older, dim=1)
        emit = emit & ~kill
        active2 = active2 & ~kill
    out_mask = emit if obb else emit & shape_ok(cfg, out_box)
    out = torch.cat([out_box, tid[..., None].to(torch.float32), conf_s[..., None],
                     cls_s[..., None], det_ind_s[..., None]], dim=-1)

    # lifecycle, and burial of eligible dead tracks in free graveyard slots
    alive = (tsu <= cfg.max_age) & (is_activated | (tsu <= cfg.tentative_max_age))
    dead = active2 & ~alive
    active2 = active2 & alive
    if gta:
        g_valid = g_valid & ((frame - g_frame) <= cfg.gta_max_gap)
        bury = dead & (age >= cfg.gta_min_track_length)
        slot_free = ~g_valid
        gfree_rank = (torch.cumsum(slot_free, dim=1) - 1).to(torch.int32)
        g_takes = slot_free & (gfree_rank < bury.sum(dim=1, dtype=torch.int32)[:, None])
        trk_by_rank = torch.full((S, K + 1), K, dtype=torch.int64, device=bury.device)
        trk_ids = torch.arange(K, device=bury.device).expand(S, K)
        trk_by_rank = trk_by_rank.scatter(
            1, torch.where(bury, torch.cumsum(bury, dim=1) - 1, K), trk_ids)[:, :K]
        src = torch.clamp(take(trk_by_rank, torch.clamp(gfree_rank, 0, K - 1)), 0, K - 1)
        g_emb = torch.where(g_takes[..., None], take(emb, src), g_emb)
        g_box = torch.where(g_takes[..., None], take(out_box[..., :4].contiguous(), src), g_box)
        g_frame = torch.where(g_takes, frame, g_frame)
        g_conf = torch.where(g_takes, take(conf_s, src), g_conf)
        g_cls = torch.where(g_takes, take(cls_s, src), g_cls)
        g_gid = torch.where(g_takes, take(tid, src), g_gid)
        g_valid = g_valid | g_takes

    i32 = torch.int32
    new_state = OccluBoostState(
        mean=mean, cov=cov, active=active2, age=age.to(i32), tsu=tsu.to(i32),
        hit_streak=hit_streak.to(i32), tid=tid.to(i32), conf=conf_s, cls=cls_s,
        det_ind=det_ind_s, emb=emb, is_activated=is_activated, ams_ring=carry["ring"],
        ams_count=count.to(i32), g_valid=g_valid, g_emb=g_emb, g_box=g_box,
        g_frame=g_frame.to(i32), g_conf=g_conf, g_cls=g_cls, g_gid=g_gid.to(i32),
        gap_rows=gap_rows, gap_count=gap_count.to(i32), frame_count=state.frame_count + 1,
        next_id=state.next_id + n_fresh, lap_capped=capped,
        resurrections=state.resurrections + res_det.sum(dim=1, dtype=torch.int32),
    )
    return new_state, out, out_mask


def flush_gta_rows(state: OccluBoostState, smooth_tau: float = 5.0, index: int = 0) -> np.ndarray:
    """The gap-fill rows of sequence ``index`` of a state, GP-smoothed
    (``smooth_gap_rows``): (N, 9) MOT rows [frame, id, x1, y1, x2, y2,
    conf, cls, -1]."""
    n = int(state.gap_count[index])
    if n == 0:
        return np.empty((0, 9))
    rows = state.gap_rows[index, :min(n, GAP_BUF)].cpu().numpy().astype(float)
    return smooth_gap_rows(rows, smooth_tau)


def smooth_gap_rows(rows: np.ndarray, smooth_tau: float = 5.0) -> np.ndarray:
    """Smooth each id's gap rows (at least 3) with the posterior mean of a
    Gaussian process at its own frames: a fixed RBF kernel of length scale
    clip(tau·log(max(tau³ / n, 1e-6)), 1/tau, tau²), noise 1e-10 on the
    diagonal, no target normalisation, as the JAX copy's scikit-learn
    regressor computes it, without scikit-learn: numpy for the kernel and
    scipy's LAPACK Cholesky factor and solve, the calls the regressor makes
    (the matrix of nearby frames is nearly singular, so another solve moves
    the mean by up to 1e-4 px)."""
    from scipy.linalg import cho_solve, cholesky

    if not (smooth_tau > 0 and len(rows) >= 3):
        return rows
    for tid in np.unique(rows[:, 1]):
        idx = np.where(rows[:, 1] == tid)[0]
        if len(idx) < 3:
            continue
        tau = smooth_tau
        length_scale = np.clip(tau * np.log(max(tau ** 3 / len(idx), 1e-6)), tau ** -1, tau ** 2)
        x = rows[idx, 0] / length_scale
        k = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2)
        lower = cholesky(k + 1e-10 * np.eye(len(idx)), lower=True, check_finite=False)
        rows[idx, 2:6] = k @ cho_solve((lower, True), rows[idx, 2:6], check_finite=False)
    return rows


class OccluBoost(BaseTracker):
    """Live tracker with the JAX ``OccluBoost`` constructor surface.

    ``with_reid`` (and GTA with it) needs a ``reid_model``, as in the JAX
    tracker: then the embeddings passed to ``update(dets, img, embs)`` feed
    the appearance terms, or, without them, the model computes them from the
    image, on the enclosing axis-aligned boxes of oriented detections;
    without a model ``embs`` are not read.  CMC (ECC by default) runs on
    every axis-aligned frame with an image; the oriented mode applies none."""

    supports_obb = True

    def __init__(
        self,
        device,
        reid_model=None,
        recovery_appearance_thresh: float = 0.99,
        recovery_iou_thresh: float = 0.1,
        recovery_max_age: int = 1,
        feat_alpha: float = 0.95,
        track_low_thresh: float = 0.1,
        second_iou_thresh: float = 0.6,
        second_appearance_thresh: float = 0.5,
        second_pass_max_age: int = 1,
        second_pass_min_hits: int = 3,
        use_second_pass: bool = False,
        new_track_thresh: float = 0.6,
        confirm_hits: int = 2,
        instant_confirm_thresh: float = 0.7,
        tentative_max_age: int = 1,
        duplicate_iou_thresh: float = 0.85,
        ams_enabled: bool = True,
        ams_alpha0: float = 0.4,
        ams_threshold: float = 0.5,
        ams_buffer_size: int = 30,
        ams_shrink_ratio: float = 0.75,
        lambda_emb_multiplier: float = 1.5,
        gta_enabled: bool = True,
        gta_appearance_thresh: float = 0.5,
        gta_min_track_length: int = 5,
        gta_smooth_tau: float = 5.0,
        gta_interpolate: bool = True,
        gta_max_gap: int = 60,
        adaptive_kf: bool = False,
        use_cmc: bool = True,
        cmc_method: str = "ecc",
        min_box_area: int = 10,
        aspect_ratio_thresh: float = 1.6,
        lambda_iou: float = 0.5,
        lambda_mhd: float = 0.25,
        lambda_shape: float = 0.25,
        use_dlo_boost: bool = True,
        use_duo_boost: bool = True,
        dlo_boost_coef: float = 0.65,
        s_sim_corr: bool = False,
        use_rich_s: bool = False,
        use_sb: bool = False,
        use_vt: bool = False,
        with_reid: bool = True,
        capacity: int = 256,
        **kwargs,
    ):
        super().__init__(device=device, **kwargs)
        self.with_reid = with_reid and reid_model is not None
        self.model = reid_model if self.with_reid else None
        self.gta_smooth_tau = gta_smooth_tau
        self.cfg = OccluBoostConfig(
            det_thresh=self.det_thresh, max_age=self.max_age, min_hits=self.min_hits,
            iou_threshold=self.iou_threshold, min_box_area=min_box_area,
            aspect_ratio_thresh=aspect_ratio_thresh, lambda_iou=lambda_iou,
            lambda_mhd=lambda_mhd, lambda_shape=lambda_shape, use_dlo_boost=use_dlo_boost,
            use_duo_boost=use_duo_boost, dlo_boost_coef=dlo_boost_coef, s_sim_corr=s_sim_corr,
            use_rich_s=use_rich_s, use_sb=use_sb, use_vt=use_vt, with_reid=self.with_reid,
            feat_dim=model_feature_dim(reid_model) if self.model else 1,
            recovery_appearance_thresh=recovery_appearance_thresh,
            recovery_iou_thresh=recovery_iou_thresh, recovery_max_age=recovery_max_age,
            feat_alpha=feat_alpha, track_low_thresh=track_low_thresh,
            second_iou_thresh=second_iou_thresh,
            second_appearance_thresh=second_appearance_thresh,
            second_pass_max_age=second_pass_max_age, second_pass_min_hits=second_pass_min_hits,
            use_second_pass=use_second_pass, new_track_thresh=max(new_track_thresh, 0.0),
            confirm_hits=max(int(confirm_hits), 1), instant_confirm_thresh=instant_confirm_thresh,
            tentative_max_age=max(int(tentative_max_age), 0),
            duplicate_iou_thresh=duplicate_iou_thresh, ams_enabled=ams_enabled,
            ams_alpha0=float(np.clip(ams_alpha0, 0.0, 1.0)),
            ams_threshold=max(ams_threshold, 0.0),
            ams_buffer_size=max(int(ams_buffer_size), 2),
            ams_shrink_ratio=float(np.clip(ams_shrink_ratio, 0.0, 1.0)),
            lambda_emb_multiplier=lambda_emb_multiplier,
            gta_enabled=bool(gta_enabled) and self.with_reid,
            gta_appearance_thresh=gta_appearance_thresh,
            gta_min_track_length=max(int(gta_min_track_length), 1),
            gta_interpolate=gta_interpolate, gta_max_gap=max(int(gta_max_gap), 1),
            is_obb=self.is_obb, capacity=capacity,
        )
        self.cmc = live_cmc(use_cmc, cmc_method, self.device)

    def _init_state(self):
        return init_state(self.cfg, 1, self.device)

    def _set_detection_mode(self, is_obb: bool):
        super()._set_detection_mode(is_obb)
        self.cfg = dataclasses.replace(self.cfg, is_obb=is_obb)

    def flush_gta(self) -> np.ndarray:
        """The gap-fill rows online GTA accumulated (GP-smoothed), then an
        empty buffer and graveyard; per-class trackers keep none."""
        if self._state is None:
            return np.empty((0, 9))
        rows = flush_gta_rows(self._state, self.gta_smooth_tau)
        self._state = dataclasses.replace(self._state,
                                          gap_count=torch.zeros_like(self._state.gap_count),
                                          g_valid=torch.zeros_like(self._state.g_valid))
        return rows

    def _step(self, state, dets_padded, det_valid):
        img, embs, dets = self._frame_inputs
        emb = None
        if self.with_reid:
            # crops of oriented detections are their enclosing axis-aligned
            # boxes, as in the JAX shell (occluboost.py:880-888)
            boxes = BotSort._obb_hull_np(dets[:, :5]) if self.cfg.is_obb else dets[:, :4]
            emb = frame_embs(self.model, embs, img, boxes, dets_padded.shape[0],
                             self.cfg.feat_dim, self.device, fill=1.0)[None]
        warp = None
        if not self.cfg.is_obb:
            if self.cmc is not None and img is not None:
                warp = self.cmc.apply(img, dets[:, :4])
            else:
                warp = IDENTITY_WARP
            warp = warp_tensor(warp, self.device)[None]
        state, out, out_mask = occluboost_step(self.cfg, state, dets_padded[None],
                                               det_valid[None], emb, warp)
        return state, out[0], out_mask[0]
