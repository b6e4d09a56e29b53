"""DeepOCSORT (AABB) as a fixed-capacity slot bank, batched over S sequences.

Counterpart of ``boxmot_tpu/trackers/deepocsort.py``: OC-SORT's
observation-centric machinery (XYSR filter, velocity-direction cost, OCR,
ORU) plus appearance and camera-motion compensation.  Every state tensor
carries a leading axis S, and one ``deepocsort_step`` call advances S
independent sequences by one frame:

* the frame's camera-motion warp (S, 2, 3) applied to the Kalman state, to
  the ORU snapshot frozen at a first miss, to the last observation and to
  the observation ring of every active slot (reference deepocsort.py:189-207);
* the masked XYSR predict and the observation ``delta_t`` frames back;
* pass 1: IoU (kernel K1 in its IoU-only mode for ``"iou"``) plus the
  velocity-direction cost plus the embedding cost (``torch.bmm`` of the
  track and detection embeddings over S, zeroed where the IoU is 0 and
  scaled by the adaptive weighting, ``aw_max_metric``), the unique-candidate
  shortcut, else a full assignment (kernel K2);
* OCR on the last observations (K1, K2);
* the ORU (kernel K4, ``ops.oru``: OC-SORT's AABB replay, unchanged), one
  masked update of every matched slot, and the embedding EMA with a
  confidence-dependent alpha;
* OC-SORT's bookkeeping, new tracks in free slots, removal and emission of
  the last observation box.

Detections below ``det_thresh`` are discarded (there is no BYTE pass).  The
step reuses OC-SORT's ``_full_assignment``, ``_speed_direction`` and
``_unique_shortcut``, and uses masks and ``torch.where`` only, so on a CUDA
device a replay runs without a host sync.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from boxmot_tpu_torch.motion import kalman
from boxmot_tpu_torch.ops.geometry import exact, xysr2xyxy, xyxy2xysr
from boxmot_tpu_torch.ops.iou import get_asso_func
from boxmot_tpu_torch.ops.oru import oru_replay
from boxmot_tpu_torch.trackers.base import BaseTracker
from boxmot_tpu_torch.trackers.botsort import (
    IDENTITY_WARP,
    _linear,
    _rot_rows,
    l2_normalize,
    no_reid_model,
    padded_embs,
    warp_tensor,
)
from boxmot_tpu_torch.trackers.ocsort import (
    _at,
    _filtered,
    _full_assignment,
    _gate,
    _layout,
    _speed_direction,
    _unique_shortcut,
)
from boxmot_tpu_torch.trackers.slots import allocate, scatter_det_flags, take


@dataclasses.dataclass(frozen=True)
class DeepOcSortConfig:
    """Field for field the JAX ``DeepOcSortConfig``, with the same defaults."""

    det_thresh: float = 0.3
    max_age: int = 30
    min_hits: int = 3
    iou_threshold: float = 0.3
    delta_t: int = 3
    inertia: float = 0.2
    w_association_emb: float = 0.5
    alpha_fixed_emb: float = 0.95
    aw_param: float = 0.5
    embedding_off: bool = False
    aw_off: bool = False
    q_xy_scaling: float = 0.01
    q_s_scaling: float = 0.0001
    asso_func: str = "iou"
    frame_w: float = 0.0  # set from the first img for centroid asso
    frame_h: float = 0.0
    feat_dim: int = 512
    capacity: int = 256


@dataclasses.dataclass
class DeepOcSortState:
    """S slot banks of capacity K.  The fields up to ``next_id`` are the JAX
    ``DeepOcSortState`` fields with a leading S axis; they are OC-SORT's and
    ``emb``."""

    mean: torch.Tensor  # (S, K, 7) xysr + velocities
    cov: torch.Tensor  # (S, K, 7, 7)
    active: torch.Tensor  # (S, K) bool
    age: torch.Tensor  # (S, K) int32
    tsu: torch.Tensor  # (S, K) int32 time since update
    hits: torch.Tensor  # (S, K) int32
    hit_streak: torch.Tensor  # (S, K) int32
    tid: torch.Tensor  # (S, K) int32
    conf: torch.Tensor  # (S, K) f32
    cls: torch.Tensor  # (S, K) f32
    det_ind: torch.Tensor  # (S, K) f32
    last_obs: torch.Tensor  # (S, K, 5) box + conf, or -1
    has_obs: torch.Tensor  # (S, K) bool
    obs_ring: torch.Tensor  # (S, K, R, 5)
    ring_age: torch.Tensor  # (S, K, R) int32, -1 empty
    velocity: torch.Tensor  # (S, K, 2) (dy, dx)
    observed: torch.Tensor  # (S, K) bool
    frozen_mean: torch.Tensor  # (S, K, 7) snapshot at the first miss (ORU)
    frozen_cov: torch.Tensor  # (S, K, 7, 7)
    last_meas: torch.Tensor  # (S, K, 4) xysr of the last real update
    emb: torch.Tensor  # (S, K, F) appearance EMA, L2-normalised
    frame_count: torch.Tensor  # (S,) int32
    next_id: torch.Tensor  # (S,) int32
    lap_capped: torch.Tensor  # (S,) int32 solves that stopped at the iteration cap
    oru_replayed: torch.Tensor  # (S,) int32 slots the ORU replayed


JAX_FIELDS = tuple(f.name for f in dataclasses.fields(DeepOcSortState))[:-2]


def init_state(cfg: DeepOcSortConfig, n: int, device) -> DeepOcSortState:
    """n fresh slot banks on ``device``."""
    K, R, F = cfg.capacity, cfg.delta_t, cfg.feat_dim

    def full(shape, value, dtype):
        return torch.full((n, *shape), value, dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    return DeepOcSortState(
        mean=full((K, 7), 0.0, f32),
        cov=full((K, 7, 7), 0.0, f32),
        active=full((K,), False, torch.bool),
        age=full((K,), 0, i32),
        tsu=full((K,), 0, i32),
        hits=full((K,), 0, i32),
        hit_streak=full((K,), 0, i32),
        tid=full((K,), 0, i32),
        conf=full((K,), 0.0, f32),
        cls=full((K,), 0.0, f32),
        det_ind=full((K,), 0.0, f32),
        last_obs=full((K, 5), -1.0, f32),
        has_obs=full((K,), False, torch.bool),
        obs_ring=full((K, R, 5), -1.0, f32),
        ring_age=full((K, R), -1, i32),
        velocity=full((K, 2), 0.0, f32),
        observed=full((K,), False, torch.bool),
        frozen_mean=full((K, 7), 0.0, f32),
        frozen_cov=full((K, 7, 7), 0.0, f32),
        last_meas=full((K, 4), 0.0, f32),
        emb=full((K, F), 0.0, f32),
        frame_count=full((), 0, i32),
        next_id=full((), 1, i32),
        lap_capped=full((), 0, i32),
        oru_replayed=full((), 0, i32),
    )


def state_from_numpy(arrays, device) -> DeepOcSortState:
    """The port's state from the JAX ``DeepOcSortState`` fields as numpy
    arrays with a leading S axis."""
    fields = {name: torch.from_numpy(np.ascontiguousarray(arrays[name])).to(device)
              for name in JAX_FIELDS}
    zeros = torch.zeros((fields["active"].shape[0],), dtype=torch.int32, device=device)
    return DeepOcSortState(**fields, lap_capped=zeros, oru_replayed=zeros.clone())


def state_to_numpy(state: DeepOcSortState) -> dict:
    """The JAX ``DeepOcSortState`` fields as numpy arrays with a leading S axis."""
    return {name: getattr(state, name).cpu().numpy() for name in JAX_FIELDS}


def aw_max_metric(emb_cost, w_emb_const, bottom, valid_rows, valid_cols):
    """Adaptive weighting (reference association.py:29-58) with the top two
    similarities of each row and each column: emb_cost (S, K, D), valid_rows
    (S, K), valid_cols (S, D)."""
    masked = torch.where(valid_rows[:, :, None] & valid_cols[:, None, :], emb_cost, 0.0)

    def weights(mat):
        top2 = torch.topk(mat, 2, dim=-1).values
        first, second = top2[..., 0], top2[..., 1]
        ratio = torch.where(first != 0, second / torch.where(first == 0, 1.0, first), 0.0)
        # a tensor divisor: a CUDA division by a Python scalar multiplies by
        # its reciprocal, and the CPU's divides
        span = torch.full_like(ratio, 1.0 - bottom)
        w = 1.0 - torch.clamp_min(ratio - bottom, 0.0) / span
        return torch.where(first == 0, 0.0, w)

    row_w = weights(masked)
    col_w = weights(masked.transpose(1, 2))
    return w_emb_const * row_w[:, :, None] * col_w[:, None, :] * emb_cost


def _apply_affine(boxes, warp):
    """Warp (S, ..., 4) xyxy boxes: both corner points through the affine
    (S, 2, 3)."""
    shape = (warp.shape[0],) + (1,) * (boxes.dim() - 2)
    m = [[warp[:, i, j].view(shape) for j in range(3)] for i in range(2)]
    x1, y1, x2, y2 = (boxes[..., k] for k in range(4))
    return torch.stack([m[0][0] * x1 + m[0][1] * y1 + m[0][2], m[1][0] * x1 + m[1][1] * y1 + m[1][2],
                        m[0][0] * x2 + m[0][1] * y2 + m[0][2], m[1][0] * x2 + m[1][1] * y2 + m[1][2]],
                       dim=-1)


def _warp_kf(mean, cov, warp, mask):
    """apply_affine_correction (reference xysr.py:312-336): position and
    velocity rotated (the position also translated), s and r untouched."""
    R, t = warp[:, :, :2], warp[:, :, 2]
    rows = _rot_rows(R, [(0, 1), (4, 5)])
    rows.update({2: [(None, 2)], 3: [(None, 3)], 6: [(None, 6)]})
    rows = [rows[a] for a in range(7)]
    new_mean = _linear(mean, rows, -1)
    new_mean = torch.cat([new_mean[..., :2] + t[:, None, :], new_mean[..., 2:]], -1)
    new_cov = _linear(_linear(cov, rows, -2), rows, -1)
    return (torch.where(mask[..., None], new_mean, mean),
            torch.where(mask[..., None, None], new_cov, cov))


def deepocsort_step(cfg: DeepOcSortConfig, state: DeepOcSortState, dets: torch.Tensor,
                    det_valid: torch.Tensor, embs: torch.Tensor, warp: torch.Tensor):
    """One frame of S sequences.

    dets: (S, D, 7) [x1, y1, x2, y2, conf, cls, det_ind], padding rows with
    conf = -1; det_valid (S, D) bool; embs (S, D, feat_dim) each detection's
    appearance; warp (S, 2, 3) the camera-motion affine of each sequence.
    Returns (state, out (S, K, 8), out_mask (S, K)).
    """
    layout = _layout(False, cfg.q_xy_scaling, cfg.q_s_scaling)
    asso = get_asso_func(cfg.asso_func, cfg.frame_w or None, cfg.frame_h or None)
    D, R = dets.shape[1], cfg.delta_t
    thr = cfg.iou_threshold
    frame = state.frame_count + 1

    conf = dets[..., 4].contiguous()
    first = det_valid & (conf > cfg.det_thresh)
    det_box = dets[..., :4].contiguous()
    det_xysr = xyxy2xysr(det_box)
    det_xysr = torch.cat([det_xysr[..., :2], torch.clamp_min(det_xysr[..., 2:4], 1e-6)], -1)

    det_emb = l2_normalize(embs)
    trust = (conf - cfg.det_thresh) / torch.full_like(conf, 1.0 - cfg.det_thresh)
    det_alpha = cfg.alpha_fixed_emb + (1 - cfg.alpha_fixed_emb) * (1 - trust)

    # camera-motion compensation before the predict (reference deepocsort.py:351-355)
    active = state.active
    last_obs = torch.where((active & state.has_obs)[..., None],
                           torch.cat([_apply_affine(state.last_obs[..., :4], warp),
                                      state.last_obs[..., 4:5]], -1), state.last_obs)
    obs_ring = torch.where((active[..., None] & (state.ring_age >= 0))[..., None],
                           torch.cat([_apply_affine(state.obs_ring[..., :4], warp),
                                      state.obs_ring[..., 4:5]], -1), state.obs_ring)
    mean, cov = _warp_kf(state.mean, state.cov, warp, active)
    frozen_mean, frozen_cov = _warp_kf(state.frozen_mean, state.frozen_cov, warp, active)

    # predict: the area velocity zeroed where it would drive the area negative
    vs = mean[..., 6]
    mean = torch.cat([mean[..., :6], torch.where(vs + mean[..., 2] <= 0, 0.0, vs)[..., None]], -1)
    mean, cov = kalman.predict(layout, mean, cov, active)
    age = state.age + active.to(torch.int32)
    hit_streak = torch.where(active & (state.tsu > 0), 0, state.hit_streak)
    tsu = state.tsu + active.to(torch.int32)
    trk_box = xysr2xyxy(mean[..., :4])

    # the observation delta_t frames back (or the nearest later one), from the warped ring
    k_obs = last_obs
    found = torch.zeros_like(active)
    for i in range(R):
        target = age - (R - i)
        slot = torch.clamp(torch.remainder(target, R), 0, R - 1).long()
        hit = (torch.gather(state.ring_age, 2, slot[..., None])[..., 0] == target) & (target >= 0)
        ring_obs = torch.gather(obs_ring, 2, slot[..., None, None].expand(-1, -1, 1, 5))[:, :, 0]
        k_obs = torch.where((hit & ~found)[..., None], ring_obs, k_obs)
        found = found | hit

    # pass 1: IoU + velocity direction + adaptive-weighted embedding similarity
    capped = state.lap_capped.clone()
    iou1 = asso(trk_box, det_box)
    Y, X = _speed_direction(k_obs[..., :4], det_box)
    diff_cos = torch.clamp(state.velocity[..., 1:2] * X + state.velocity[..., 0:1] * Y, -1.0, 1.0)
    diff_angle = (math.pi / 2.0 - torch.abs(exact(torch.acos, diff_cos))) / torch.full_like(
        diff_cos, math.pi)
    valid_vel = (k_obs[..., 4] >= 0)[..., None]
    angle_cost = valid_vel * diff_angle * cfg.inertia * conf[:, None, :]
    cost = iou1 + angle_cost
    if not cfg.embedding_off:
        emb_cost = torch.bmm(state.emb, det_emb.transpose(1, 2))  # (S, K, D)
        emb_cost = torch.where(iou1 <= 0, 0.0, emb_cost)
        if cfg.aw_off:
            emb_cost = emb_cost * cfg.w_association_emb
        else:
            emb_cost = aw_max_metric(emb_cost, cfg.w_association_emb, cfg.aw_param, active, first)
        cost = cost + emb_cost

    usable, r2c_short = _unique_shortcut(iou1, active, first, thr)
    r2c_full = _full_assignment(-cost, active, first, capped)
    r2c1 = torch.where(usable[:, None], r2c_short, r2c_full)
    at1 = _at(iou1, torch.clamp(r2c1, 0, D - 1))
    # the shortcut's matches come from iou > thresh candidates
    matched = (r2c1 >= 0) & torch.where(usable[:, None], at1 > thr, at1 >= thr)
    dm = scatter_det_flags(r2c1, matched, D)
    det_col = torch.where(matched, r2c1, -1)

    # OCR, IoU only (reference deepocsort.py:425-460)
    rows3 = active & ~matched
    cols3 = first & ~dm
    iou3 = asso(last_obs[..., :4].contiguous(), det_box)
    r2c3 = _full_assignment(-iou3, rows3, cols3, capped)
    keep3 = _filtered(r2c3, iou3, thr, _gate(iou3, rows3, cols3, thr))
    matched = matched | keep3
    det_col = torch.where(keep3, r2c3, det_col)
    dm = dm | scatter_det_flags(r2c3, keep3, D)
    c = torch.clamp(det_col, 0, D - 1)

    # ORU: re-found tracks replay the filter from their (warped) frozen state (K4)
    rejoin = matched & ~state.observed & state.has_obs & (tsu > 1)
    z2 = take(det_xysr, c).contiguous()
    replayed = state.oru_replayed.clone()
    mean, cov = oru_replay(layout, mean.contiguous(), cov.contiguous(), frozen_mean.contiguous(),
                           frozen_cov.contiguous(), state.last_meas, z2, rejoin, tsu, replayed)
    mean, cov = kalman.update(layout, mean, cov, z2, matched)

    # embedding EMA with each detection's alpha (reference deepocsort.py:182-185)
    a = take(det_alpha, c)[..., None]
    new_emb = l2_normalize(a * state.emb + (1 - a) * take(det_emb, c))
    emb = torch.where(matched[..., None], new_emb, state.emb)

    # velocity and observation bookkeeping for matched slots (pass 1's
    # directions: the same k_obs and detections)
    vel_new = torch.stack([_at(Y, c), _at(X, c)], -1)
    velocity = torch.where((matched & state.has_obs)[..., None], vel_new, state.velocity)
    new_obs = torch.cat([take(det_box, c), take(conf, c)[..., None]], -1)
    last_obs = torch.where(matched[..., None], new_obs, last_obs)
    slot = torch.clamp(torch.remainder(age, R), 0, R - 1).long()
    ring_set = obs_ring.scatter(2, slot[..., None, None].expand(-1, -1, 1, 5), new_obs[:, :, None, :])
    obs_ring = torch.where(matched[..., None, None], ring_set, obs_ring)
    ring_age = torch.where(matched[..., None],
                           state.ring_age.scatter(2, slot[..., None], age[..., None]), state.ring_age)
    last_meas = torch.where(matched[..., None], z2, state.last_meas)
    has_obs = state.has_obs | matched
    hits = state.hits + matched.to(torch.int32)
    hit_streak = hit_streak + matched.to(torch.int32)
    det_cls = dets[..., 5].contiguous()
    det_ind = dets[..., 6].contiguous()
    conf_s = torch.where(matched, take(conf, c), state.conf)
    cls_s = torch.where(matched, take(det_cls, c), state.cls)
    det_ind_s = torch.where(matched, take(det_ind, c), state.det_ind)
    tsu = torch.where(matched, 0, tsu)

    # misses: freeze on the first unobserved step
    first_miss = active & ~matched & state.observed
    frozen_mean = torch.where(first_miss[..., None], mean, frozen_mean)
    frozen_cov = torch.where(first_miss[..., None, None], cov, frozen_cov)
    observed = torch.where(active, matched, state.observed)

    # new tracks from the unmatched high-confidence detections, into free slots in order
    n_new, free_rank, takes, slot_det = allocate(first & ~dm, ~active)
    init_mean_v, init_cov_v = kalman.initiate(layout, take(det_xysr, slot_det))
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
    emb = torch.where(takes[..., None], take(det_emb, slot_det), emb)

    # removal
    active = active & ~(tsu > cfg.max_age)

    # output: the last observation box where there is one
    out_box = torch.where(has_obs[..., None], last_obs[..., :4], xysr2xyxy(mean[..., :4]))
    warm = (hit_streak >= cfg.min_hits) | (frame[:, None] <= cfg.min_hits)
    out_mask = active & (tsu < 1) & warm
    out = torch.cat([out_box, tid[..., None].to(torch.float32), conf_s[..., None], cls_s[..., None],
                     det_ind_s[..., None]], dim=-1)

    new_state = DeepOcSortState(
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
        emb=emb,
        frame_count=frame,
        next_id=state.next_id + n_new,
        lap_capped=capped,
        oru_replayed=replayed,
    )
    return new_state, out, out_mask


class DeepOcSort(BaseTracker):
    """Live tracker with the JAX ``DeepOcSort`` constructor surface.

    ``reid_model`` is not ported (it raises).  Embeddings passed to
    ``update(dets, img, embs)`` feed the appearance cost; without them every
    detection's embedding is a row of ones, as in the JAX tracker (the
    replay, like the JAX replay, uses zeros).  CMC is ECC on the tracker's
    device unless ``cmc_off``."""

    supports_obb = False

    def __init__(
        self,
        device,
        reid_model=None,
        delta_t: int = 3,
        inertia: float = 0.2,
        w_association_emb: float = 0.5,
        alpha_fixed_emb: float = 0.95,
        aw_param: float = 0.5,
        embedding_off: bool = False,
        cmc_off: bool = False,
        aw_off: bool = False,
        Q_xy_scaling: float = 0.01,
        Q_s_scaling: float = 0.0001,
        capacity: int = 256,
        **kwargs,
    ):
        no_reid_model(reid_model)
        super().__init__(device=device, **kwargs)
        self.cfg = DeepOcSortConfig(
            det_thresh=self.det_thresh,
            max_age=self.max_age,
            min_hits=self.min_hits,
            iou_threshold=self.iou_threshold,
            delta_t=delta_t,
            inertia=inertia,
            w_association_emb=w_association_emb,
            alpha_fixed_emb=alpha_fixed_emb,
            aw_param=aw_param,
            embedding_off=embedding_off,
            aw_off=aw_off,
            q_xy_scaling=Q_xy_scaling,
            q_s_scaling=Q_s_scaling,
            asso_func=self.asso_func_name,
            feat_dim=512 if not embedding_off else 1,
            capacity=capacity,
        )
        if not cmc_off:
            from boxmot_tpu_torch.motion.cmc import create_cmc

            self.cmc = create_cmc("ecc", device=self.device)
        else:
            self.cmc = None

    def _init_state(self):
        return init_state(self.cfg, 1, self.device)

    def _set_frame_size(self, w: float, h: float):
        # only centroid association needs it
        if self.cfg.asso_func == "centroid":
            self.cfg = dataclasses.replace(self.cfg, frame_w=w, frame_h=h)

    def _step(self, state, dets_padded, det_valid):
        img, embs, dets = self._frame_inputs
        n, D = len(dets), dets_padded.shape[0]
        if self.cfg.embedding_off or not n:
            emb = padded_embs(None, n, D, self.cfg.feat_dim, self.device)
        elif embs is not None:
            emb = padded_embs(embs, n, D, self.cfg.feat_dim, self.device)
        else:  # no embeddings and no model: ones, as the reference
            emb = padded_embs(np.ones((n, self.cfg.feat_dim), np.float32), n, D,
                              self.cfg.feat_dim, self.device)
        if self.cmc is not None and img is not None:
            warp = self.cmc.apply(img, dets[:, :4])
        else:
            warp = IDENTITY_WARP
        state, out, out_mask = deepocsort_step(self.cfg, state, dets_padded[None],
                                               det_valid[None], emb[None],
                                               warp_tensor(warp, self.device)[None])
        return state, out[0], out_mask[0]
