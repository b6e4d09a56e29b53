"""BoT-SORT (AABB and OBB) as a fixed-capacity slot bank, batched over S sequences.

Counterpart of ``boxmot_tpu/trackers/botsort.py``: the ByteTrack two-stage
skeleton on an XYWH Kalman filter, with appearance embeddings and
camera-motion compensation (CMC).  Every state tensor carries a leading
axis S, and one ``botsort_step`` call advances S independent sequences by
one frame:

* the masked Kalman predict of the tracked + lost pool (size, and angle,
  velocities of lost tracks zeroed), then the frame's camera-motion warp
  (S, 2, 3) applied to the pool and the unconfirmed tracks: the state and
  covariance rotated for axis-aligned boxes (the reference's ``multi_gmc``),
  the corners warped and the rotated box refitted for oriented ones
  (``multi_gmc_obb``);
* one IoU matrix for all three passes and the fused-score cost
  ``1 - iou * conf``: kernel K1 in its IoU + cost mode (``iou_batch``'s
  union clamp) for axis-aligned boxes, kernel K3 and an elementwise cost
  for oriented ones;
* with ``with_reid``, the cosine distance between each track's smoothed
  embedding and each detection's (``torch.bmm`` over S: a plain product,
  which the JAX step also computes outside any Pallas kernel), clipped at
  ``appearance_thresh`` and gated by the IoU proximity;
* kernel K2 for the three passes (high-confidence detections against the
  pool, low-confidence ones against the unmatched tracked slots on IoU
  alone, leftovers against the unconfirmed tracks);
* one masked Joseph-form update, the embedding EMA renormalised, the
  confidence-weighted class vote, lifecycle changes, new tracks in free
  slots, and duplicate suppression between tracked and lost (K1's IoU-only
  mode, or K3).

The step uses masks and ``torch.where`` only, so on a CUDA device a replay
runs without a host sync.  Norms and angles go through
``ops.geometry.exact``, and no division is by a Python scalar, so a CPU run
and a CUDA run give the same bits wherever no embedding product is
involved; ``torch.bmm`` sums in another order on each, so with embeddings
the costs agree to a few ulps.

Slot states: 0 = empty, 1 = tracked, 2 = lost.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from boxmot_tpu_torch.motion import kalman
from boxmot_tpu_torch.ops.fused_iou_cost import IOU_BATCH_EPS, fused_iou_cost
from boxmot_tpu_torch.ops.geometry import exact, obb_corners, xywh2xyxy, xyxy2xywh
from boxmot_tpu_torch.ops.lap import masked_assignment
from boxmot_tpu_torch.ops.rotated_iou import rotated_iou
from boxmot_tpu_torch.trackers.base import BaseTracker
from boxmot_tpu_torch.trackers.slots import allocate, scatter_det_flags, take

EMPTY, TRACKED, LOST = 0, 1, 2

IDENTITY_WARP = np.eye(2, 3, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class BotSortConfig:
    """Field for field the JAX ``BotSortConfig``, with the same defaults."""

    track_high_thresh: float = 0.5
    track_low_thresh: float = 0.1
    new_track_thresh: float = 0.6
    match_thresh: float = 0.8
    proximity_thresh: float = 0.5
    appearance_thresh: float = 0.25
    second_match_thresh: float = 0.5
    unconfirmed_match_thresh: float = 0.7
    unconfirmed_emb_scale: float = 2.0
    fuse_first_associate: bool = False
    with_reid: bool = True
    max_time_lost: int = 30
    feat_dim: int = 512
    nr_classes: int = 80
    ema_alpha: float = 0.9
    is_obb: bool = False  # oriented boxes: XYWH-5 filter + OBB-aware CMC
    std_weight_position: float = 1.0 / 20
    std_weight_velocity: float = 1.0 / 160
    capacity: int = 256


@dataclasses.dataclass
class BotSortState:
    """S slot banks of capacity K.  The fields up to ``next_id`` are the JAX
    ``BotSortState`` fields with a leading S axis."""

    mean: torch.Tensor  # (S, K, 8) xywh + velocities; (S, K, 10) with theta (OBB)
    cov: torch.Tensor  # (S, K, 8, 8); (S, K, 10, 10)
    status: torch.Tensor  # (S, K) int32: EMPTY/TRACKED/LOST
    activated: torch.Tensor  # (S, K) bool
    tid: torch.Tensor  # (S, K) int32
    conf: torch.Tensor  # (S, K) f32
    cls: torch.Tensor  # (S, K) f32
    det_ind: torch.Tensor  # (S, K) f32
    frame_id: torch.Tensor  # (S, K) int32 last-update frame
    start_frame: torch.Tensor  # (S, K) int32
    tracklet_len: torch.Tensor  # (S, K) int32
    smooth_feat: torch.Tensor  # (S, K, F) EMA appearance, L2-normalised
    has_feat: torch.Tensor  # (S, K) bool
    cls_scores: torch.Tensor  # (S, K, NC) confidence-weighted votes
    cls_seen: torch.Tensor  # (S, K, NC) bool
    frame_count: torch.Tensor  # (S,) int32
    next_id: torch.Tensor  # (S,) int32
    lap_capped: torch.Tensor  # (S,) int32 solves that stopped at the iteration cap


JAX_FIELDS = tuple(f.name for f in dataclasses.fields(BotSortState))[:-1]


def init_state(cfg: BotSortConfig, n: int, device) -> BotSortState:
    """n fresh slot banks on ``device``."""
    K = cfg.capacity
    dx = 10 if cfg.is_obb else 8

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros((n, *shape), dtype=dtype, device=device)

    f32 = torch.float32
    return BotSortState(
        mean=zeros(K, dx, dtype=f32),
        cov=zeros(K, dx, dx, dtype=f32),
        status=zeros(K),
        activated=zeros(K, dtype=torch.bool),
        tid=zeros(K),
        conf=zeros(K, dtype=f32),
        cls=zeros(K, dtype=f32),
        det_ind=zeros(K, dtype=f32),
        frame_id=zeros(K),
        start_frame=zeros(K),
        tracklet_len=zeros(K),
        smooth_feat=zeros(K, cfg.feat_dim, dtype=f32),
        has_feat=zeros(K, dtype=torch.bool),
        cls_scores=zeros(K, cfg.nr_classes, dtype=f32),
        cls_seen=zeros(K, cfg.nr_classes, dtype=torch.bool),
        frame_count=zeros(),
        next_id=torch.ones((n,), dtype=torch.int32, device=device),
        lap_capped=zeros(),
    )


def state_from_numpy(arrays, device) -> BotSortState:
    """The port's state from the JAX ``BotSortState`` fields as numpy arrays
    with a leading S axis (e.g. ``np.asarray`` of a vmapped state)."""
    fields = {name: torch.from_numpy(np.ascontiguousarray(arrays[name])).to(device)
              for name in JAX_FIELDS}
    S = fields["status"].shape[0]
    return BotSortState(**fields,
                        lap_capped=torch.zeros((S,), dtype=torch.int32, device=device))


def state_to_numpy(state: BotSortState) -> dict:
    """The JAX ``BotSortState`` fields as numpy arrays with a leading S axis."""
    return {name: getattr(state, name).cpu().numpy() for name in JAX_FIELDS}


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(||x||, 1e-12) along the last axis, the norm summed in float64
    and rounded once, so that the CPU and the card divide by the same value."""
    norm = torch.sqrt(torch.sum(torch.square(x.double()), dim=-1, keepdim=True)).to(x.dtype)
    return x / torch.clamp_min(norm, 1e-12)


def appearance_distance(smooth_feat, feat, has_feat):
    """(S, K, D) cosine distance max(0, 1 - smooth_feat . feat) of the tracks'
    smoothed embeddings (S, K, F) to the detections' (S, D, F), both unit
    vectors; 1 for a track without features, which then never wins on
    appearance.  The product is one ``torch.bmm`` (TF32 off)."""
    dist = torch.clamp_min(1.0 - torch.bmm(smooth_feat, feat.transpose(1, 2)), 0.0)
    return torch.where(has_feat[..., None], dist, 1.0)


def _linear(x: torch.Tensor, rows, dim: int) -> torch.Tensor:
    """y[a] = sum of coef * x[b] over the (coef, b) terms of rows[a], along
    ``dim``: a small sparse matrix applied without a matmul (an add of an
    exact zero and a product by 1 are left out).  A coef is None for 1, or an
    (S,) tensor of the batch's per-sequence values."""
    out = []
    for terms in rows:
        acc = None
        for coef, b in terms:
            v = x.select(dim, b)
            if coef is not None:
                v = coef.view((-1,) + (1,) * (v.dim() - 1)) * v
            acc = v if acc is None else acc + v
        out.append(acc)
    return torch.stack(out, dim=dim)


def _rot_rows(R, pairs):
    """Rows of the 2 x 2 rotation R (S, 2, 2) on each (i, j) index pair."""
    rows = {}
    for i, j in pairs:
        rows[i] = [(R[:, 0, 0], i), (R[:, 0, 1], j)]
        rows[j] = [(R[:, 1, 0], i), (R[:, 1, 1], j)]
    return rows


def _apply_warp(mean, cov, warp, mask):
    """multi_gmc (reference botsort_track.py:118-133): with T = kron(I4, R),
    mean <- T mean + t on the position, cov <- T cov T^T, where ``mask``."""
    R, t = warp[:, :, :2], warp[:, :, 2]
    rows = _rot_rows(R, [(0, 1), (2, 3), (4, 5), (6, 7)])
    rows = [rows[a] for a in range(8)]
    new_mean = _linear(mean, rows, -1)
    new_mean = torch.cat([new_mean[..., :2] + t[:, None, :], new_mean[..., 2:]], -1)
    new_cov = _linear(_linear(cov, rows, -2), rows, -1)
    return (torch.where(mask[..., None], new_mean, mean),
            torch.where(mask[..., None, None], new_cov, cov))


def _apply_warp_obb(mean, cov, warp, mask):
    """OBB-aware CMC (reference multi_gmc_obb, botsort_track.py:197-231):
    warp the box corners, refit a rotated rect from its edges (exact under the
    similarity warps that ECC gives), align it to the pre-warp state, rotate
    the position velocities and scale the size velocities."""
    R, t = warp[:, :, :2], warp[:, :, 2]

    def view(v):  # (S,) -> broadcast against (S, K)
        return v[:, None]

    scale_x = torch.clamp_min(exact(torch.sqrt, R[:, 0, 0] * R[:, 0, 0] + R[:, 1, 0] * R[:, 1, 0]),
                              1e-6)
    scale_y = torch.clamp_min(exact(torch.sqrt, R[:, 0, 1] * R[:, 0, 1] + R[:, 1, 1] * R[:, 1, 1]),
                              1e-6)

    corners = obb_corners(mean[..., :5])  # (S, K, 4, 2): bl, tl, tr, br
    cx, cy = corners[..., 0], corners[..., 1]
    R4 = R[:, None, None]  # (S, 1, 1, 2, 2)
    wx = R4[..., 0, 0] * cx + R4[..., 0, 1] * cy + t[:, None, None, 0]
    wy = R4[..., 1, 0] * cx + R4[..., 1, 1] * cy + t[:, None, None, 1]
    ctr_x = (((wx[..., 0] + wx[..., 1]) + wx[..., 2]) + wx[..., 3]) * 0.25  # the mean of 4
    ctr_y = (((wy[..., 0] + wy[..., 1]) + wy[..., 2]) + wy[..., 3]) * 0.25
    w_x, w_y = wx[..., 2] - wx[..., 1], wy[..., 2] - wy[..., 1]  # tl -> tr: the width edge
    h_x, h_y = wx[..., 3] - wx[..., 2], wy[..., 3] - wy[..., 2]  # tr -> br: the height edge
    w = torch.clamp_min(exact(torch.sqrt, w_x * w_x + w_y * w_y), 1e-4)
    h = torch.clamp_min(exact(torch.sqrt, h_x * h_x + h_y * h_y), 1e-4)
    angle = torch.atan2(w_y.double(), w_x.double()).to(w.dtype)
    fitted = kalman.align_obb_to_ref(torch.stack([ctr_x, ctr_y, w, h, angle], -1), mean[..., :5])

    vel = _linear(mean[..., 5:7], [[(R[:, 0, 0], 0), (R[:, 0, 1], 1)],
                                   [(R[:, 1, 0], 0), (R[:, 1, 1], 1)]], -1)
    new_mean = torch.cat([fitted, vel, (mean[..., 7] * view(scale_x))[..., None],
                          (mean[..., 8] * view(scale_y))[..., None], mean[..., 9:]], -1)

    rows = _rot_rows(R, [(0, 1), (5, 6)])
    rows.update({2: [(scale_x, 2)], 3: [(scale_y, 3)], 4: [(None, 4)], 7: [(scale_x, 7)],
                 8: [(scale_y, 8)], 9: [(None, 9)]})
    rows = [rows[a] for a in range(10)]
    new_cov = _linear(_linear(cov, rows, -2), rows, -1)
    return (torch.where(mask[..., None], new_mean, mean),
            torch.where(mask[..., None, None], new_cov, cov))


def _vote_cls(cls_scores, cls_seen, cls_det, conf_det, apply_mask, nr_classes):
    """Confidence-weighted class voting (reference botsort_track.py:69-83);
    ties in the vote go to the first class, as ``jnp.argmax``."""
    ci = torch.clamp(cls_det.to(torch.int32), 0, nr_classes - 1).long()
    onehot = torch.nn.functional.one_hot(ci, nr_classes).to(cls_scores.dtype)
    add = onehot * conf_det[..., None] * apply_mask[..., None]
    new_scores = cls_scores + add
    seen_before = torch.gather(cls_seen, -1, ci[..., None])[..., 0]
    new_seen = cls_seen | (onehot > 0) & apply_mask[..., None]
    voted = torch.where(seen_before, torch.argmax(new_scores, dim=-1).to(torch.float32), cls_det)
    return new_scores, new_seen, voted


def botsort_step(cfg: BotSortConfig, state: BotSortState, dets: torch.Tensor,
                 det_valid: torch.Tensor, embs: torch.Tensor | None, warp: torch.Tensor):
    """One frame of S sequences.

    dets: (S, D, 7) [x1, y1, x2, y2, conf, cls, det_ind], or (S, D, 8)
    [cx, cy, w, h, theta, conf, cls, det_ind] when ``cfg.is_obb``; padding
    rows with conf = -1; det_valid (S, D) bool; embs (S, D, feat_dim), each
    detection's appearance (only first-stage rows are used; None when
    ``cfg.with_reid`` is off, which never reads it); warp (S, 2, 3), the
    camera-motion affine of each sequence.  Returns (state, out (S, K, 8) or
    (S, K, 9), out_mask (S, K)).
    """
    obb = cfg.is_obb
    layout = kalman.make_xywh_layout(obb, cfg.std_weight_position, cfg.std_weight_velocity)
    D = dets.shape[1]
    B = 5 if obb else 4  # box columns
    frame = (state.frame_count + 1)[:, None]  # (S, 1)

    conf = dets[..., B].contiguous()
    first = det_valid & (conf > cfg.track_high_thresh)
    second = det_valid & (conf > cfg.track_low_thresh) & (conf < cfg.track_high_thresh)

    status0 = state.status
    tracked_act = (status0 == TRACKED) & state.activated
    unconf = (status0 == TRACKED) & ~state.activated
    lost = status0 == LOST
    pool = tracked_act | lost

    # KF predict: lost tracks get their size (and angle) velocities zeroed
    v0 = 7 if obb else 6
    mean = torch.cat([state.mean[..., :v0],
                      torch.where(lost[..., None], 0.0, state.mean[..., v0:])], -1)
    pmean, pcov = kalman.predict(layout, mean, state.cov, pool)

    # camera-motion compensation of the pool and the unconfirmed tracks
    pmean, pcov = (_apply_warp_obb if obb else _apply_warp)(pmean, pcov, warp, pool | unconf)

    # one IoU matrix and fused-score cost for every pass
    if obb:
        det_xywh = dets[..., :5].contiguous()
        iou = rotated_iou(pmean[..., :5].contiguous(), det_xywh)
        fused = 1.0 - iou * conf[:, None, :]
    else:
        det_xyxy = dets[..., :4].contiguous()
        det_xywh = xyxy2xywh(det_xyxy)
        iou, fused = fused_iou_cost(xywh2xyxy(pmean[..., :4]), det_xyxy, conf, eps=IOU_BATCH_EPS)
    iou_dist = 1.0 - iou
    prox_mask = iou_dist > cfg.proximity_thresh

    if cfg.with_reid:
        feat = l2_normalize(embs)
        emb_dist_raw = appearance_distance(state.smooth_feat, feat, state.has_feat)
    capped = state.lap_capped.clone()

    # pass 1: high-confidence detections against the pool
    cost1 = fused if cfg.fuse_first_associate else iou_dist
    if cfg.with_reid:
        emb1 = torch.where(emb_dist_raw > cfg.appearance_thresh, 1.0, emb_dist_raw)
        cost1 = torch.minimum(cost1, torch.where(prox_mask, 1.0, emb1))
    r2c1 = masked_assignment(cost1, pool, first, cfg.match_thresh, capped)
    m1 = r2c1 >= 0
    dm1 = scatter_det_flags(r2c1, m1, D)

    # pass 2: low-confidence detections, IoU only
    r_tracked = pool & ~m1 & (status0 == TRACKED)
    r2c2 = masked_assignment(iou_dist, r_tracked, second, cfg.second_match_thresh, capped)
    m2 = r2c2 >= 0

    # unconfirmed pass: the fused score, and the scaled appearance distance
    u_first = first & ~dm1
    cost3 = fused
    if cfg.with_reid:
        emb3 = emb_dist_raw / torch.full_like(emb_dist_raw, cfg.unconfirmed_emb_scale)
        emb3 = torch.where(emb3 > cfg.appearance_thresh, 1.0, emb3)
        cost3 = torch.minimum(cost3, torch.where(prox_mask, 1.0, emb3))
    r2c3 = masked_assignment(cost3, unconf, u_first, cfg.unconfirmed_match_thresh, capped)
    m3 = r2c3 >= 0
    dm3 = scatter_det_flags(r2c3, m3, D)

    # one KF update for every matched slot
    matched = m1 | m2 | m3
    det_col = torch.where(m1, r2c1, torch.where(m2, r2c2, r2c3))
    c = torch.clamp(det_col, 0, D - 1)
    meas = take(det_xywh, c)
    if obb:
        # resolve the rotated-rect parameterization against the state
        meas = kalman.align_obb_to_ref(meas, pmean[..., :5])
    new_mean, new_cov = kalman.update(layout, pmean, pcov, meas, matched)
    if obb:
        # angular velocity damped x0.8 after every observed update
        theta_v = torch.where(matched, new_mean[..., 9] * 0.8, new_mean[..., 9])
        new_mean = torch.cat([new_mean[..., :9], theta_v[..., None]], -1)

    # appearance EMA for slots matched to a first-stage detection
    smooth_feat, has_feat = state.smooth_feat, state.has_feat
    if cfg.with_reid:
        upd_feat = matched & take(first, c)
        f = take(feat, c)
        ema = l2_normalize(cfg.ema_alpha * smooth_feat + (1 - cfg.ema_alpha) * f)
        new_smooth = torch.where(has_feat[..., None], ema, f)
        smooth_feat = torch.where(upd_feat[..., None], new_smooth, smooth_feat)
        has_feat = has_feat | upd_feat

    # bookkeeping for matched slots
    was_tracked = status0 == TRACKED
    tracklet_len = torch.where(
        matched, torch.where(was_tracked, state.tracklet_len + 1, 0), state.tracklet_len)
    status = torch.where(matched, TRACKED, status0)
    activated = state.activated | matched
    det_cls = dets[..., B + 1].contiguous()
    det_ind = dets[..., B + 2].contiguous()
    conf_s = torch.where(matched, take(conf, c), state.conf)
    det_ind_s = torch.where(matched, take(det_ind, c), state.det_ind)
    frame_id = torch.where(matched, frame, state.frame_id)
    cls_scores, cls_seen, voted = _vote_cls(state.cls_scores, state.cls_seen, take(det_cls, c),
                                            take(conf, c), matched, cfg.nr_classes)
    cls_s = torch.where(matched, voted, state.cls)

    # aged-out lost tracks; unmatched tracked -> lost; unmatched unconfirmed -> removed
    aged = (status == LOST) & (frame - frame_id > cfg.max_time_lost)
    status = torch.where(aged, EMPTY, status)
    status = torch.where(r_tracked & ~m2, LOST, status)
    status = torch.where(unconf & ~m3, EMPTY, status)

    # new tracks from the remaining high-confidence detections, into free slots in order
    new_det = u_first & ~dm3 & (conf >= cfg.new_track_thresh)
    n_new, free_rank, takes, slot_det = allocate(new_det, status == EMPTY)
    init_mean_v, init_cov_v = kalman.initiate(layout, take(det_xywh, slot_det))
    new_mean = torch.where(takes[..., None], init_mean_v, new_mean)
    new_cov = torch.where(takes[..., None, None], init_cov_v, new_cov)
    status = torch.where(takes, TRACKED, status)
    activated = torch.where(takes, frame == 1, activated)
    tid = torch.where(takes, state.next_id[:, None] + free_rank, state.tid)
    slot_conf, slot_cls = take(conf, slot_det), take(det_cls, slot_det)
    conf_s = torch.where(takes, slot_conf, conf_s)
    cls_s = torch.where(takes, slot_cls, cls_s)
    det_ind_s = torch.where(takes, take(det_ind, slot_det), det_ind_s)
    frame_id = torch.where(takes, frame, frame_id)
    start_frame = torch.where(takes, frame, state.start_frame)
    tracklet_len = torch.where(takes, 0, tracklet_len)
    # a new track's feature and class vote (reference STrack.__init__)
    if cfg.with_reid:
        new_feat = takes & take(first, slot_det)
        smooth_feat = torch.where(new_feat[..., None], take(feat, slot_det), smooth_feat)
        has_feat = torch.where(takes, new_feat, has_feat)
    else:
        has_feat = has_feat & ~takes
    cls_scores = torch.where(takes[..., None], 0.0, cls_scores)
    cls_seen = cls_seen & ~takes[..., None]
    cls_scores, cls_seen, _ = _vote_cls(cls_scores, cls_seen, slot_cls, slot_conf, takes,
                                        cfg.nr_classes)

    # duplicate suppression between tracked and lost: pairs closer than IoU
    # distance 0.15 keep the longer-lived track
    if obb:
        out_box = new_mean[..., :5].contiguous()
        corners = obb_corners(out_box).contiguous()
        pair_iou = rotated_iou(out_box, out_box, corners, corners)
    else:
        out_box = xywh2xyxy(new_mean[..., :4])
        pair_iou, _ = fused_iou_cost(out_box, out_box, eps=IOU_BATCH_EPS)
    a_mask = status == TRACKED
    b_mask = status == LOST
    pair = ((1.0 - pair_iou) < 0.15) & a_mask[:, :, None] & b_mask[:, None, :]
    age = frame_id - start_frame
    dup_a = torch.any(pair & (age[:, :, None] <= age[:, None, :]), dim=2)
    dup_b = torch.any(pair & (age[:, :, None] > age[:, None, :]), dim=1)
    status = torch.where(dup_a & a_mask, EMPTY, status)
    status = torch.where(dup_b & b_mask, EMPTY, status)

    out_mask = (status == TRACKED) & activated
    out = torch.cat([out_box, tid[..., None].to(torch.float32), conf_s[..., None],
                     cls_s[..., None], det_ind_s[..., None]], dim=-1)
    new_state = BotSortState(
        mean=new_mean,
        cov=new_cov,
        status=status.to(torch.int32),
        activated=activated,
        tid=tid.to(torch.int32),
        conf=conf_s,
        cls=cls_s,
        det_ind=det_ind_s,
        frame_id=frame_id.to(torch.int32),
        start_frame=start_frame.to(torch.int32),
        tracklet_len=tracklet_len.to(torch.int32),
        smooth_feat=smooth_feat,
        has_feat=has_feat,
        cls_scores=cls_scores,
        cls_seen=cls_seen,
        frame_count=state.frame_count + 1,
        next_id=state.next_id + n_new,
        lap_capped=capped,
    )
    return new_state, out, out_mask


def model_feature_dim(reid_model, default: int = 512) -> int:
    """The embedding width of ``reid_model`` (its ``feature_dim``), ``default``
    without a model, as the JAX shells read it."""
    return getattr(reid_model, "feature_dim", default) if reid_model else default


def frame_embs(model, embs, img, boxes, D: int, feat_dim: int, device,
               fill: float = 0.0) -> torch.Tensor:
    """(D, feat_dim) float32 embeddings of a step's n = len(boxes) detections
    on ``device``: the first n rows from ``embs`` when given, else from
    ``model`` on ``boxes`` of ``img`` when both are given (the port's ``ReID``
    keeps its features on the device, ``features``; another model is read
    through the reference's ``get_features``), else ``fill``, as are the other
    rows."""
    n = len(boxes)
    if embs is not None or model is None or img is None or not n:
        return padded_embs(embs, n, D, feat_dim, device, fill)
    if hasattr(model, "features"):
        feats = model.features(boxes, img)
    else:
        feats = torch.from_numpy(np.asarray(model.get_features(boxes, img), np.float32))
    out = torch.full((D, feat_dim), fill, dtype=torch.float32, device=device)
    out[:n] = feats.to(device)
    return out


def warp_tensor(warp, device) -> torch.Tensor:
    """A CMC estimator's (2, 3) warp as a float32 tensor on ``device`` (ECC's
    is one already)."""
    if torch.is_tensor(warp):
        return warp.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(warp, np.float32)).to(device)


def padded_embs(embs, n: int, D: int, feat_dim: int, device, fill: float = 0.0) -> torch.Tensor:
    """(D, feat_dim) float32 embeddings on ``device``: the first n rows from
    ``embs`` (None or an (N, F) array), the rest ``fill``, as the JAX shells
    pad (zeros; StrongSORT's and HybridSORT's ones)."""
    pad = np.full((D, feat_dim), fill, np.float32)
    if embs is not None and n:
        pad[:n] = np.asarray(embs, np.float32)[:n]
    return torch.from_numpy(pad).to(device)


class BotSort(BaseTracker):
    """Live tracker with the JAX ``BotSort`` constructor surface.

    With ``with_reid``, embeddings passed to ``update(dets, img, embs)`` feed
    the appearance cost; without them ``reid_model`` (e.g. ``reid.ReID``)
    computes them from the image, on the detections' boxes (rotated boxes as
    xywha).  CMC runs on every frame with an image: ECC on the tracker's
    device, SOF, ORB and SIFT on the host (``motion.cmc``)."""

    supports_obb = True

    def __init__(
        self,
        device,
        reid_model=None,
        track_high_thresh: float = 0.5,
        track_low_thresh: float = 0.1,
        new_track_thresh: float = 0.6,
        track_buffer: int = 30,
        match_thresh: float = 0.8,
        proximity_thresh: float = 0.5,
        appearance_thresh: float = 0.25,
        use_cmc: bool = True,
        cmc_method: str = "ecc",
        frame_rate: int = 30,
        fuse_first_associate: bool = False,
        with_reid: bool = True,
        second_match_thresh: float = 0.5,
        unconfirmed_match_thresh: float = 0.7,
        unconfirmed_emb_scale: float = 2.0,
        removed_stracks_buffer: int = 100,
        std_weight_position: float = 1.0 / 20,
        std_weight_velocity: float = 1.0 / 160,
        capacity: int = 256,
        **kwargs,
    ):
        super().__init__(device=device, **kwargs)
        # dead slots are recycled, so the removed-track buffer exists only
        # for the constructor's surface, as in the JAX tracker
        self.removed_stracks_buffer = int(removed_stracks_buffer)
        self.buffer_size = int(frame_rate / 30.0 * track_buffer)
        self.with_reid = with_reid
        self.model = reid_model if with_reid else None
        self.cfg = BotSortConfig(
            track_high_thresh=track_high_thresh,
            track_low_thresh=track_low_thresh,
            new_track_thresh=new_track_thresh,
            match_thresh=match_thresh,
            proximity_thresh=proximity_thresh,
            appearance_thresh=appearance_thresh,
            second_match_thresh=second_match_thresh,
            unconfirmed_match_thresh=unconfirmed_match_thresh,
            unconfirmed_emb_scale=unconfirmed_emb_scale,
            fuse_first_associate=fuse_first_associate,
            with_reid=with_reid,
            max_time_lost=self.buffer_size,
            feat_dim=model_feature_dim(reid_model),
            nr_classes=self.nr_classes,
            is_obb=self.is_obb,
            std_weight_position=std_weight_position,
            std_weight_velocity=std_weight_velocity,
            capacity=capacity,
        )
        if use_cmc and cmc_method not in (None, "none"):
            from boxmot_tpu_torch.motion.cmc import create_cmc

            self.cmc = create_cmc(cmc_method, device=self.device)
        else:
            self.cmc = None

    def _init_state(self):
        return init_state(self.cfg, 1, self.device)

    def _set_detection_mode(self, is_obb: bool):
        super()._set_detection_mode(is_obb)
        self.cfg = dataclasses.replace(self.cfg, is_obb=is_obb)

    @staticmethod
    def _obb_hull_np(xywha):
        """Enclosing AABBs of rotated boxes for CMC feature masking
        (reference _obb_detections_to_cmc_boxes, botsort.py:126-131)."""
        cx, cy, w, h, a = (xywha[:, i] for i in range(5))
        ca, sa = np.abs(np.cos(a)), np.abs(np.sin(a))
        hx = (w * ca + h * sa) / 2.0
        hy = (w * sa + h * ca) / 2.0
        return np.stack([cx - hx, cy - hy, cx + hx, cy + hy], axis=-1)

    def _lost_mask(self, state):
        # KF-predicted boxes of LOST slots feed show_kf_preds overlays
        return state.status[0] == LOST

    def _step(self, state, dets_padded, det_valid):
        img, embs, dets = self._frame_inputs
        B = self.layout.box_cols
        emb = None
        if self.cfg.with_reid:
            emb = frame_embs(self.model, embs, img, dets[:, :B], dets_padded.shape[0],
                             self.cfg.feat_dim, self.device)[None]
        if self.cmc is not None and img is not None:
            boxes = dets[:, :B]
            warp = self.cmc.apply(img, self._obb_hull_np(boxes) if self.cfg.is_obb else boxes)
        else:
            warp = IDENTITY_WARP
        state, out, out_mask = botsort_step(self.cfg, state, dets_padded[None], det_valid[None],
                                            emb, warp_tensor(warp, self.device)[None])
        return state, out[0], out_mask[0]
