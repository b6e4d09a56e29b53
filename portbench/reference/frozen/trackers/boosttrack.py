# Frozen copy of boxmot_tpu_torch/trackers/boosttrack.py at commit 78364f93b578: the plain
# (twin) path only, on every device; no kernel, no tracker shell.
"""BoostTrack (AABB) as a fixed-capacity slot bank, batched over S sequences.

Counterpart of ``boxmot_tpu/trackers/boosttrack.py``: one association pass
on an XYHR Kalman filter with a multi-cue cost and detection-confidence
boosting.  Every state tensor carries a leading axis S, and one
``boosttrack_step`` call advances S independent sequences by one frame:

* the camera-motion warp of the state's box corners, then the masked XYHR
  predict and each track's confidence (0.9^(7 - age) while warming up, else
  0.9^(tsu - 1));
* one IoU matrix of the predicted track boxes against the detections
  (kernel K1 in its IoU-only mode with ``iou_batch``'s union clamp), which
  the DLO boost and the association both read;
* the DLO boost (plain, or BoostTrack++'s rich similarity, soft-BIoU and
  varying threshold) and the DUO boost, whose detection x detection IoU is
  a second K1 launch;
* the cost iou + l_iou·conf·iou + l_mhd·MhSim + l_shape·conf·shape
  (+ l_emb·emb with appearance), the reference's unique-candidate shortcut
  or else a full assignment (kernel K2), and the validity gate;
* one masked update, the embedding EMA, new tracks in free slots (never
  matched detections first, then those that failed the gate) and emission.

K1 takes tracks first and gives (S, K, D); the steps read its transpose as
the JAX step's detection x track ``_iou``.  That is exact: the IoU of a pair
is a max, a min and a commutative sum of the two areas, so both orders give
the same bits.

The step uses masks and ``torch.where`` only, so on a CUDA device a replay
runs without a host sync.  ``exp``, ``pow`` and the norms are evaluated in
float64 and rounded once, sums that decide a gate are float64 sums rounded
once, and no division is by a Python scalar, so a CPU run and a CUDA run give
the same bits wherever no embedding product is involved.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.frozen.motion import kalman
from portbench.reference.frozen.ops.fused_iou_cost import IOU_BATCH_EPS, fused_iou_cost
from portbench.reference.frozen.ops.geometry import exact
from portbench.reference.frozen.trackers.botsort import IDENTITY_WARP, l2_normalize
from portbench.reference.frozen.trackers.ocsort import _full_assignment, _unique_shortcut
from portbench.reference.frozen.trackers.slots import scatter_det_flags, take

MH_LIMIT = 13.2767  # 99 % chi2(4) limit
_TRACK_CONF_BASE = float(np.float32(0.9))  # 0.9 as the JAX step's float32 power takes it


@dataclasses.dataclass(frozen=True)
class BoostTrackConfig:
    """Field for field the JAX ``BoostTrackConfig``, with the same defaults."""

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
    with_reid: bool = False
    feat_dim: int = 512
    capacity: int = 256


@dataclasses.dataclass
class BoostTrackState:
    """S slot banks of capacity K.  The fields up to ``next_id`` are the JAX
    ``BoostTrackState`` fields with a leading S axis."""

    mean: torch.Tensor  # (S, K, 8) xyhr + velocities
    cov: torch.Tensor  # (S, K, 8, 8)
    active: torch.Tensor  # (S, K) bool
    age: torch.Tensor  # (S, K) int32
    tsu: torch.Tensor  # (S, K) int32 time since update
    hit_streak: torch.Tensor  # (S, K) int32
    tid: torch.Tensor  # (S, K) int32
    conf: torch.Tensor  # (S, K) f32
    cls: torch.Tensor  # (S, K) f32
    det_ind: torch.Tensor  # (S, K) f32
    emb: torch.Tensor  # (S, K, F) unit appearance (written with with_reid)
    frame_count: torch.Tensor  # (S,) int32
    next_id: torch.Tensor  # (S,) int32
    lap_capped: torch.Tensor  # (S,) int32 solves that stopped at the iteration cap


def init_state(cfg: BoostTrackConfig, n: int, device) -> BoostTrackState:
    """n fresh slot banks on ``device``."""
    K = cfg.capacity

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros((n, *shape), dtype=dtype, device=device)

    f32 = torch.float32
    return BoostTrackState(
        mean=zeros(K, 8, dtype=f32), cov=zeros(K, 8, 8, dtype=f32),
        active=zeros(K, dtype=torch.bool), age=zeros(K), tsu=zeros(K), hit_streak=zeros(K),
        tid=zeros(K), conf=zeros(K, dtype=f32), cls=zeros(K, dtype=f32),
        det_ind=zeros(K, dtype=f32), emb=zeros(K, cfg.feat_dim, dtype=f32),
        frame_count=zeros(), next_id=torch.ones((n,), dtype=torch.int32, device=device),
        lap_capped=zeros(),
    )


# --- geometry ---------------------------------------------------------------

def xyhr2xyxy(mean):
    """(x, y, h, r = w/h, ...) -> (x1, y1, x2, y2); w is 0 where r <= 0."""
    x, y, h, r = mean[..., 0], mean[..., 1], mean[..., 2], mean[..., 3]
    w = torch.where(r <= 0, 0.0, r * h)
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def xyxy2xyhr(box):
    """(x1, y1, x2, y2) -> (cx, cy, h, r = w / (h + 1e-6))."""
    w = box[..., 2] - box[..., 0]
    h = box[..., 3] - box[..., 1]
    return torch.stack([box[..., 0] + w / 2, box[..., 1] + h / 2, h, w / (h + 1e-6)], dim=-1)


def obb2xyhr(box):
    """(cx, cy, w, h, theta) -> the oriented measurement (cx, cy, h, r = w/h, theta)."""
    w = torch.clamp_min(box[..., 2], 1e-4)
    h = torch.clamp_min(box[..., 3], 1e-4)
    return torch.stack([box[..., 0], box[..., 1], h, w / h, box[..., 4]], dim=-1)


def xyhr2obb(mean):
    """Oriented state (cx, cy, h, r, theta, ...) -> (cx, cy, w, h, theta)."""
    h, r = mean[..., 2], mean[..., 3]
    return torch.stack([mean[..., 0], mean[..., 1], h * r, h, mean[..., 4]], dim=-1)


def iou_kd(trk_box, det_box):
    """(S, K, D) IoU of xyxy tracks (S, K, 4) against detections (S, D, 4):
    kernel K1's IoU-only mode with ``iou_batch``'s union clamp."""
    return fused_iou_cost(trk_box.contiguous(), det_box.contiguous(), eps=IOU_BATCH_EPS)[0]


def _div(x, value: float):
    """x / value, dividing by a tensor: a CUDA division by a Python scalar
    multiplies by its reciprocal, which rounds otherwise."""
    return x / torch.full_like(x, value)


def _sum64(x, dim):
    """A float32 sum along ``dim`` taken in float64 and rounded once, so the
    CPU and the card (which sum in other orders) give the same bits."""
    return torch.sum(x.double(), dim=dim).to(x.dtype)


# --- similarity cues (all (S, D, K): detections by tracks) --------------------

def soft_biou(det_box, trk_box, trk_conf):
    """Soft-BIoU: both boxes buffered by (1 - the track's conf) factors."""
    k1, k2 = 0.25, 0.5
    b1 = det_box[:, :, None, :]
    b2 = trk_box[:, None, :, :]
    c2 = trk_conf[:, None, :]
    e1w = (b1[..., 2] - b1[..., 0]) * (1 - c2) * k1
    e1h = (b1[..., 3] - b1[..., 1]) * (1 - c2) * k1
    e2w = (b2[..., 2] - b2[..., 0]) * (1 - c2) * k2
    e2h = (b2[..., 3] - b2[..., 1]) * (1 - c2) * k2
    b1x1, b1y1 = b1[..., 0] - e1w, b1[..., 1] - e1h
    b1x2, b1y2 = b1[..., 2] + e1w, b1[..., 3] + e1h
    b2x1, b2y1 = b2[..., 0] - e2w, b2[..., 1] - e2h
    b2x2, b2y2 = b2[..., 2] + e2w, b2[..., 3] + e2h
    xx1 = torch.maximum(b1x1, b2x1)
    yy1 = torch.maximum(b1y1, b2y1)
    xx2 = torch.minimum(b1x2, b2x2)
    yy2 = torch.minimum(b1y2, b2y2)
    wh = torch.clamp_min(xx2 - xx1, 0.0) * torch.clamp_min(yy2 - yy1, 0.0)
    union = (b1x2 - b1x1) * (b1y2 - b1y1) + (b2x2 - b2x1) * (b2y2 - b2y1) - wh
    return wh / torch.clamp_min(union, 1e-12)


def shape_similarity(det_box, trk_box, s_sim_corr: bool):
    """exp(-(|dw - tw| / max(dw, tw) + |dh - th| / max(., .))); without
    ``s_sim_corr`` both terms divide by max(dw, tw), as the reference's v1."""
    dw = (det_box[..., 2] - det_box[..., 0])[:, :, None]
    dh = (det_box[..., 3] - det_box[..., 1])[:, :, None]
    tw = (trk_box[..., 2] - trk_box[..., 0])[:, None, :]
    th = (trk_box[..., 3] - trk_box[..., 1])[:, None, :]
    hd = torch.maximum(dh, th) if s_sim_corr else torch.maximum(dw, tw)
    return exact(torch.exp, -(torch.abs(dw - tw) / torch.maximum(dw, tw)
                              + torch.abs(dh - th) / hd))


def mh_similarity(md, valid):
    """Clamped, inverted Mahalanobis distance softmaxed over the detections
    of each track; pairs past MH_LIMIT or not ``valid`` are 0."""
    s = MH_LIMIT - torch.clamp_max(md, MH_LIMIT)
    e = torch.where(valid, exact(torch.exp, s), 0.0)
    denom = torch.clamp_min(_sum64(e, 1)[:, None, :], 1e-12)
    return torch.where((md > MH_LIMIT) | ~valid, 0.0, e / denom)


def camera_update_xyhr(mean, warp, active):
    """Warp the state box corners by (S, 2, 3) ``warp`` and rebuild
    [x, y, h, r] where ``active``."""
    sb = xyhr2xyxy(mean[..., :4])
    m = warp[:, None, :, :2]  # (S, 1, 2, 2)
    t = warp[:, None, :, 2]

    def apply(px, py):
        return [px * m[..., i, 0] + py * m[..., i, 1] + t[..., i] for i in range(2)]

    p1 = apply(sb[..., 0], sb[..., 1])
    p2 = apply(sb[..., 2], sb[..., 3])
    new_xyhr = xyxy2xyhr(torch.stack(p1 + p2, dim=-1))
    return torch.cat([torch.where(active[..., None], new_xyhr, mean[..., :4]), mean[..., 4:]], -1)


def track_confidence(age, tsu, active):
    """0.9^(7 - age) while a track warms up (age < 7), else 0.9^(tsu - 1);
    0 for an empty slot.  The power is taken in float64 and rounded once."""
    expo = torch.where(age < 7, 7 - age, tsu - 1).to(torch.float32).double()
    conf = torch.pow(torch.full_like(expo, _TRACK_CONF_BASE), expo).to(torch.float32)
    return torch.where(active, conf, 0.0)


def mh_distance(det_box, mean, cov):
    """(S, D, K) Mahalanobis distance normalised by each track's covariance
    diagonal, over the first four state dimensions."""
    det_z = xyxy2xyhr(det_box)
    sigma_inv = 1.0 / torch.clamp_min(torch.diagonal(cov, dim1=-2, dim2=-1)[..., :4], 1e-12)
    diff = det_z[:, :, None, :] - mean[:, None, :, :4]
    terms = diff * diff * sigma_inv[:, None, :, :]
    return ((terms[..., 0] + terms[..., 1]) + terms[..., 2]) + terms[..., 3]


# --- confidence boosts --------------------------------------------------------

def dlo_boost(cfg, conf, det_valid, det_box, trk_box, trk_conf, tsu, md, pair_valid, iou_dk):
    """DLO boost: conf = max(conf, max_s * coef), or BoostTrack++'s soft
    (``use_sb``) and varying-threshold (``use_vt``) variants; S is the IoU
    ``iou_dk`` (S, D, K), or the mean of the three rich cues (``use_rich_s``)."""
    if cfg.use_rich_s:
        S = (mh_similarity(md, pair_valid) + shape_similarity(det_box, trk_box, cfg.s_sim_corr)
             + soft_biou(det_box, trk_box, trk_conf))
        S = _div(S, 3.0)
    else:
        S = iou_dk
    S = torch.where(pair_valid, S, 0.0)
    max_s = S.amax(dim=2)
    if not cfg.use_sb and not cfg.use_vt:
        return torch.where(det_valid, torch.maximum(conf, max_s * cfg.dlo_boost_coef), conf)
    if cfg.use_sb:
        alpha = 0.65
        soft = alpha * conf + (1 - alpha) * exact(lambda x: torch.pow(x, 1.5), max_s)
        conf = torch.where(det_valid, torch.maximum(conf, soft), conf)
    if cfg.use_vt:
        thr = torch.clamp_min(0.95 - (tsu - 1).to(torch.float32), 0.8)
        hit = torch.any(pair_valid & (S > thr[:, None, :]), dim=2)
        conf = torch.where(det_valid & hit, torch.clamp_min(conf, cfg.det_thresh + 1e-5), conf)
    return conf


def duo_boost(cfg, conf, det_valid, md, pair_valid, active):
    """DUO candidates: valid detections below det_thresh that are farther
    than MH_LIMIT from every track, in frames that have a track."""
    md_min = torch.where(pair_valid, md, torch.inf).amin(dim=2)
    return (det_valid & (md_min > MH_LIMIT) & (conf < cfg.det_thresh)
            & active.any(dim=1, keepdim=True))


def _duo_apply(cfg, conf, det_box, cand):
    """Lift the DUO candidates to det_thresh + 1e-4: isolated ones, and of
    candidates that overlap (IoU > 0.3), the most confident (K1 on the
    detections against themselves)."""
    D = conf.shape[1]
    eye = torch.eye(D, dtype=conf.dtype, device=conf.device)
    diou = iou_kd(det_box, det_box)
    diou = torch.where(cand[:, :, None] & cand[:, None, :], diou, 0.0)
    diou = diou - eye * diou
    diou_max = diou.amax(dim=2)
    isolated = cand & (diou_max <= 0.3)
    has_overlap = cand & (diou_max > 0.3)
    peer = ((diou > 0.3) & has_overlap[:, None, :]) | eye.bool()
    peer_conf = torch.where(peer & cand[:, None, :], conf[:, None, :], -torch.inf)
    winner = has_overlap & (conf >= peer_conf.amax(dim=2))
    return torch.where(isolated | winner, cfg.det_thresh + 1e-4, conf)


def boost_cost(cfg, det_box, trk_box, conf, trk_conf, md, iou_dk, valid_dk, emb_cost,
               lambda_emb_multiplier=1.5):
    """The multi-cue association cost (S, D, K)."""
    conf_dk = conf[:, :, None] * trk_conf[:, None, :]
    conf_dk = torch.where(iou_dk < cfg.iou_threshold, 0.0, conf_dk)
    cost = iou_dk + cfg.lambda_iou * conf_dk * iou_dk
    cost = cost + cfg.lambda_mhd * mh_similarity(md, valid_dk)
    cost = cost + cfg.lambda_shape * conf_dk * shape_similarity(det_box, trk_box, cfg.s_sim_corr)
    if cfg.with_reid:
        lambda_emb = ((1 + cfg.lambda_iou + cfg.lambda_shape + cfg.lambda_mhd)
                      * lambda_emb_multiplier)
        cost = cost + lambda_emb * emb_cost
    return cost


def ranked_allocate(new_det, det_rank, free):
    """Give the new detections (S, D), in the order of their ``det_rank``,
    the free slots (S, K) in index order.  Returns n_new (S,), free_rank
    (S, K), takes (S, K) and slot_det (S, K), as ``slots.allocate``."""
    S, D = new_det.shape
    n_new = new_det.sum(dim=1, dtype=torch.int32)
    det_ids = torch.arange(D, device=new_det.device).expand(S, D)
    det_by_rank = torch.full((S, D + 1), D, dtype=torch.int64, device=new_det.device)
    det_by_rank = det_by_rank.scatter(1, torch.where(new_det, det_rank.long(), D), det_ids)[:, :D]
    free_rank = (torch.cumsum(free, dim=1) - 1).to(torch.int32)
    takes = free & (free_rank < n_new[:, None])
    slot_det = torch.clamp(take(det_by_rank, torch.clamp(free_rank, 0, D - 1)), 0, D - 1)
    return n_new, free_rank, takes, slot_det


def gate_order_rank(fresh, failed_gate):
    """Each detection's rank among the ``fresh`` ones (S, D) in the
    reference's unmatched order: never-matched detections ascending first,
    then those whose assignment failed the validity gate."""
    D = fresh.shape[1]
    key = torch.arange(D, device=fresh.device) + D * failed_gate.to(torch.int64)
    return torch.sum((key[:, None, :] < key[:, :, None]) & fresh[:, None, :], dim=2)


def at_kd(x_dk, c):
    """x_dk (S, D, K) at each track's detection column c (S, K) -> (S, K)."""
    return torch.gather(x_dk.transpose(1, 2), 2, c.long()[..., None])[..., 0]


def emb_products(a, b):
    """(S, N, M) products of the unit embeddings a (S, N, F) and b (S, M, F):
    one ``torch.bmm`` (TF32 off), a plain product that the JAX step also
    computes outside any Pallas kernel."""
    return torch.bmm(a, b.transpose(1, 2))


def boosttrack_step(cfg: BoostTrackConfig, state: BoostTrackState, dets: torch.Tensor,
                    det_valid: torch.Tensor, embs: torch.Tensor | None, warp: torch.Tensor):
    """One frame of S sequences.

    dets: (S, D, 7) [x1, y1, x2, y2, conf, cls, det_ind], padding rows with
    conf = -1; det_valid (S, D) bool; embs (S, D, feat_dim), each detection's
    appearance (None when ``cfg.with_reid`` is off, which never reads it);
    warp (S, 2, 3), each sequence's camera-motion affine.  Returns (state,
    out (S, K, 8), out_mask (S, K)).
    """
    layout = kalman.make_xyhr_layout()
    D = dets.shape[1]
    frame = (state.frame_count + 1)[:, None]
    active = state.active

    det_box = dets[..., :4].contiguous()
    conf = torch.where(det_valid, dets[..., 4], -1.0)

    # camera update, predict, track confidence
    mean = camera_update_xyhr(state.mean, warp, active)
    mean, cov = kalman.predict(layout, mean, state.cov, active)
    act = active.to(torch.int32)
    age = state.age + act
    hit_streak = torch.where(active & (state.tsu > 0), 0, state.hit_streak)
    tsu = state.tsu + act
    trk_conf = track_confidence(age, tsu, active)
    trk_box = xyhr2xyxy(mean[..., :4])

    det_z = xyxy2xyhr(det_box)
    md = mh_distance(det_box, mean, cov)
    pair_valid = det_valid[:, :, None] & active[:, None, :]
    iou = iou_kd(trk_box, det_box).transpose(1, 2)  # (S, D, K), exact (see the docstring)

    if cfg.use_dlo_boost:
        conf = dlo_boost(cfg, conf, det_valid, det_box, trk_box, trk_conf, tsu, md, pair_valid,
                         iou)
    if cfg.use_duo_boost:
        conf = _duo_apply(cfg, conf, det_box, duo_boost(cfg, conf, det_valid, md, pair_valid,
                                                        active))
    first = det_valid & (conf >= cfg.det_thresh)

    # association: (D, K) matrices, assigned as (K, D)
    valid_dk = first[:, :, None] & active[:, None, :]
    iou_dk = torch.where(valid_dk, iou, 0.0)
    if cfg.with_reid:
        det_emb = l2_normalize(embs)
        emb_cost = emb_products(det_emb, state.emb)
    else:
        emb_cost = torch.zeros_like(iou_dk)
    cost = boost_cost(cfg, det_box, trk_box, conf, trk_conf, md, iou_dk, valid_dk, emb_cost)
    cost_kd = cost.transpose(1, 2)
    capped = state.lap_capped.clone()
    usable, r2c_short = _unique_shortcut(cost_kd, active, first, cfg.iou_threshold)
    r2c_full = _full_assignment((-cost_kd).contiguous(), active, first, capped)
    r2c = torch.where(usable[:, None], r2c_short, r2c_full)
    c = torch.clamp(r2c, 0, D - 1)
    iou_of = at_kd(iou_dk, c)
    valid_match = iou_of >= cfg.iou_threshold
    if cfg.with_reid:
        emb_of = at_kd(emb_cost, c)
        valid_match = valid_match | ((emb_of >= 0.75) & (iou_of >= cfg.iou_threshold / 2))
    matched = (r2c >= 0) & valid_match
    dm = scatter_det_flags(r2c, matched, D)

    # update
    mean, cov = kalman.update(layout, mean, cov, take(det_z, c), matched)
    conf_c = take(conf, c)
    emb = state.emb
    if cfg.with_reid:
        trust = _div(conf_c - cfg.det_thresh, 1 - cfg.det_thresh)
        a = (0.95 + 0.05 * (1 - trust))[..., None]
        new_emb = l2_normalize(a * emb + (1 - a) * take(det_emb, c))
        emb = torch.where(matched[..., None], new_emb, emb)
    hit_streak = hit_streak + matched.to(torch.int32)
    tsu = torch.where(matched, 0, tsu)
    det_cls = dets[..., 5].contiguous()
    det_ind = dets[..., 6].contiguous()
    conf_s = torch.where(matched, conf_c, state.conf)
    cls_s = torch.where(matched, take(det_cls, c), state.cls)
    det_ind_s = torch.where(matched, take(det_ind, c), state.det_ind)

    # new tracks, in the reference's unmatched order
    new_det = first & ~dm
    failed = scatter_det_flags(r2c, (r2c >= 0) & ~valid_match, D)
    n_new, free_rank, takes, slot_det = ranked_allocate(new_det, gate_order_rank(new_det, failed),
                                                        ~active)
    init_mean, init_cov = kalman.initiate(layout, take(det_z, slot_det))
    mean = torch.where(takes[..., None], init_mean, mean)
    cov = torch.where(takes[..., None, None], init_cov, cov)
    active = active | takes
    tid = torch.where(takes, state.next_id[:, None] + free_rank, state.tid)
    conf_s = torch.where(takes, take(conf, slot_det), conf_s)
    cls_s = torch.where(takes, take(det_cls, slot_det), cls_s)
    det_ind_s = torch.where(takes, take(det_ind, slot_det), det_ind_s)
    age = torch.where(takes, 0, age)
    tsu = torch.where(takes, 0, tsu)
    hit_streak = torch.where(takes, 0, hit_streak)
    if cfg.with_reid:
        emb = torch.where(takes[..., None], take(det_emb, slot_det), emb)

    # output, then removal
    out_box = xyhr2xyxy(mean[..., :4])
    out_mask = (active & (tsu < 1) & ((hit_streak >= cfg.min_hits) | (frame <= cfg.min_hits))
                & shape_ok(cfg, out_box))
    out = torch.cat([out_box, tid[..., None].to(torch.float32), conf_s[..., None],
                     cls_s[..., None], det_ind_s[..., None]], dim=-1)
    active = active & ~(tsu > cfg.max_age)

    new_state = BoostTrackState(
        mean=mean, cov=cov, active=active, age=age.to(torch.int32), tsu=tsu.to(torch.int32),
        hit_streak=hit_streak.to(torch.int32), tid=tid.to(torch.int32), conf=conf_s, cls=cls_s,
        det_ind=det_ind_s, emb=emb, frame_count=state.frame_count + 1,
        next_id=state.next_id + n_new, lap_capped=capped,
    )
    return new_state, out, out_mask


def shape_ok(cfg, out_box):
    """The emission's aspect-ratio and minimum-area gate on xyxy boxes."""
    w = out_box[..., 2] - out_box[..., 0]
    h = out_box[..., 3] - out_box[..., 1]
    return (w / torch.clamp_min(h, 1e-12) <= cfg.aspect_ratio_thresh) & (w * h > cfg.min_box_area)


