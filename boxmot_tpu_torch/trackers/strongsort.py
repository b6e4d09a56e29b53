"""StrongSORT (AABB) as a fixed-capacity slot bank, batched over S sequences.

Counterpart of ``boxmot_tpu/trackers/strongsort.py``: the DeepSORT lineage
with the NSA Kalman filter (the measurement noise scaled by 1 - the
detection's confidence), an EMA appearance feature and a per-track bank of
the last ``nn_budget`` features, matched by appearance gated by the motion.
Every state tensor carries a leading axis S, and one ``strongsort_step``
call advances S independent sequences by one frame:

* the camera update: each alive slot's box corners through the frame's
  warp (S, 2, 3), the XYAH state rebuilt from them, then the masked predict;
* pass 1 over confirmed tracks: ``mc_lambda`` times the least cosine
  distance over the bank (one ``torch.bmm`` over S) plus ``1 - mc_lambda``
  times the squared Mahalanobis distance, ``INFTY`` where that exceeds
  chi2(4), a full assignment (kernel K2) and the ``max_cos_dist`` filter;
* pass 2 over tentative tracks and confirmed ones missed for exactly one
  frame: ``1 - iou_batch`` (kernel K1 in its IoU-only mode), K2 and the
  ``max_iou_dist`` filter;
* the NSA update of the matched slots with their detections' confidences,
  the EMA feature, the lifecycle (tentative, confirmed, ``max_age``) and new
  tracks in free slots;
* the bank's push-front of every confirmed track's EMA feature, on every
  frame, missed frames included (a most-recent-``nn_budget`` set read only
  through a minimum, laid out (S, K, nn_budget, F) as in JAX);
* emission of the confirmed tracks updated this frame.

The step uses masks and ``torch.where`` only, so on a CUDA device a replay
runs without a host sync.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from boxmot_tpu_torch.motion import kalman
from boxmot_tpu_torch.ops.fused_iou_cost import IOU_BATCH_EPS, fused_iou_cost
from boxmot_tpu_torch.ops.geometry import xyah2xyxy, xyxy2xyah
from boxmot_tpu_torch.trackers.base import BaseTracker
from boxmot_tpu_torch.trackers.botsort import (
    IDENTITY_WARP,
    frame_embs,
    l2_normalize,
    model_feature_dim,
    warp_tensor,
)
from boxmot_tpu_torch.trackers.deepocsort import _apply_affine
from boxmot_tpu_torch.trackers.ocsort import _at, _full_assignment
from boxmot_tpu_torch.trackers.slots import allocate, scatter_det_flags, take

EMPTY, TENTATIVE, CONFIRMED = 0, 1, 2
INFTY = 1e5
CHI2_4 = 9.4877


@dataclasses.dataclass(frozen=True)
class StrongSortConfig:
    """Field for field the JAX ``StrongSortConfig``, with the same defaults."""

    min_conf: float = 0.1
    max_cos_dist: float = 0.2
    max_iou_dist: float = 0.7
    max_age: int = 30
    n_init: int = 3
    nn_budget: int = 100
    mc_lambda: float = 0.98
    ema_alpha: float = 0.9
    feat_dim: int = 512
    capacity: int = 256
    std_weight_position: float = 1.0 / 20
    std_weight_velocity: float = 1.0 / 160


@dataclasses.dataclass
class StrongSortState:
    """S slot banks of capacity K.  The fields up to ``next_id`` are the JAX
    ``StrongSortState`` fields with a leading S axis."""

    mean: torch.Tensor  # (S, K, 8) xyah + velocities
    cov: torch.Tensor  # (S, K, 8, 8)
    status: torch.Tensor  # (S, K) int32 EMPTY / TENTATIVE / CONFIRMED
    hits: torch.Tensor  # (S, K) int32
    age: torch.Tensor  # (S, K) int32
    tsu: torch.Tensor  # (S, K) int32 time since update
    tid: torch.Tensor  # (S, K) int32
    conf: torch.Tensor  # (S, K) f32
    cls: torch.Tensor  # (S, K) f32
    det_ind: torch.Tensor  # (S, K) f32
    smooth: torch.Tensor  # (S, K, F) EMA feature
    has_feat: torch.Tensor  # (S, K) bool
    bank: torch.Tensor  # (S, K, nn_budget, F) features, newest first
    bank_count: torch.Tensor  # (S, K) int32 features pushed since the track's birth
    frame_count: torch.Tensor  # (S,) int32
    next_id: torch.Tensor  # (S,) int32
    lap_capped: torch.Tensor  # (S,) int32 solves that stopped at the iteration cap


JAX_FIELDS = tuple(f.name for f in dataclasses.fields(StrongSortState))[:-1]


def init_state(cfg: StrongSortConfig, n: int, device) -> StrongSortState:
    """n fresh slot banks on ``device``."""
    K, B, F = cfg.capacity, cfg.nn_budget, cfg.feat_dim

    def full(shape, value, dtype):
        return torch.full((n, *shape), value, dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    return StrongSortState(
        mean=full((K, 8), 0.0, f32),
        cov=full((K, 8, 8), 0.0, f32),
        status=full((K,), EMPTY, i32),
        hits=full((K,), 0, i32),
        age=full((K,), 0, i32),
        tsu=full((K,), 0, i32),
        tid=full((K,), 0, i32),
        conf=full((K,), 0.0, f32),
        cls=full((K,), 0.0, f32),
        det_ind=full((K,), 0.0, f32),
        smooth=full((K, F), 0.0, f32),
        has_feat=full((K,), False, torch.bool),
        bank=full((K, B, F), 0.0, f32),
        bank_count=full((K,), 0, i32),
        frame_count=full((), 0, i32),
        next_id=full((), 1, i32),
        lap_capped=full((), 0, i32),
    )


def state_from_numpy(arrays, device) -> StrongSortState:
    """The port's state from the JAX ``StrongSortState`` fields as numpy
    arrays with a leading S axis."""
    fields = {name: torch.from_numpy(np.array(arrays[name])).to(device) for name in JAX_FIELDS}
    zeros = torch.zeros((fields["status"].shape[0],), dtype=torch.int32, device=device)
    return StrongSortState(**fields, lap_capped=zeros)


def state_to_numpy(state: StrongSortState) -> dict:
    """The JAX ``StrongSortState`` fields as numpy arrays with a leading S axis."""
    return {name: getattr(state, name).cpu().numpy() for name in JAX_FIELDS}


@functools.lru_cache(maxsize=16)
def _layout(std_weight_position: float, std_weight_velocity: float) -> kalman.KFLayout:
    return kalman.make_xyah_layout(std_weight_position, std_weight_velocity, nsa=True)


def appearance_cost(bank, bank_count, feat):
    """(S, K, D) least cosine distance 1 - bank . feat over each track's
    valid bank rows (the first min(bank_count, nn_budget)), ``INFTY`` for a
    track with none: bank (S, K, B, F), feat (S, D, F) unit vectors.  The
    product is one ``torch.bmm`` over S (TF32 off)."""
    S, K, B, F = bank.shape
    D = feat.shape[1]
    sims = torch.bmm(bank.reshape(S, K * B, F), feat.transpose(1, 2)).view(S, K, B, D)
    rows = torch.arange(B, device=bank.device)
    valid = rows < torch.clamp_max(bank_count, B)[..., None]  # (S, K, B)
    cos_d = torch.where(valid[..., None], 1.0 - sims, math.inf).amin(dim=2)
    return torch.where(torch.isfinite(cos_d), cos_d, INFTY)


def strongsort_step(cfg: StrongSortConfig, state: StrongSortState, dets: torch.Tensor,
                    det_valid: torch.Tensor, embs: torch.Tensor, warp: torch.Tensor):
    """One frame of S sequences.

    dets: (S, D, 7) [x1, y1, x2, y2, conf, cls, det_ind], padding rows with
    conf = -1; det_valid (S, D) bool; embs (S, D, feat_dim) each detection's
    appearance; warp (S, 2, 3) the camera-motion affine of each sequence.
    Returns (state, out (S, K, 8), out_mask (S, K)).
    """
    layout = _layout(cfg.std_weight_position, cfg.std_weight_velocity)
    D = dets.shape[1]
    frame = state.frame_count + 1
    status0 = state.status
    alive = status0 != EMPTY
    confirmed = status0 == CONFIRMED
    tentative = status0 == TENTATIVE

    conf = dets[..., 4].contiguous()
    valid = det_valid & (conf >= cfg.min_conf)
    det_box = dets[..., :4].contiguous()
    det_xyah = xyxy2xyah(det_box)
    feat = l2_normalize(embs)

    # the camera update: the state's corners warped, the box rebuilt from
    # them (reference track.py:137-147), then the predict
    wb = _apply_affine(xyah2xyxy(state.mean[..., :4]), warp)
    w = wb[..., 2] - wb[..., 0]
    h = wb[..., 3] - wb[..., 1]
    warped = torch.stack([wb[..., 0] + w / 2, wb[..., 1] + h / 2, w / torch.clamp_min(h, 1e-6), h],
                         -1)
    mean = torch.cat([torch.where(alive[..., None], warped, state.mean[..., :4]),
                      state.mean[..., 4:]], -1)
    mean, cov = kalman.predict(layout, mean, state.cov, alive)
    age = state.age + alive.to(torch.int32)
    tsu = state.tsu + alive.to(torch.int32)

    # pass 1: confirmed tracks, the bank's appearance fused with the motion gate
    capped = state.lap_capped.clone()
    app_cost = appearance_cost(state.bank, state.bank_count, feat)
    gate = kalman.gating_distance(layout, mean, cov, det_xyah)
    cost1 = torch.where(gate > CHI2_4, INFTY, app_cost)
    cost1 = cfg.mc_lambda * cost1 + (1 - cfg.mc_lambda) * gate
    cost1 = torch.clamp_max(cost1, cfg.max_cos_dist + 1e-5)
    r2c1 = _full_assignment(cost1, confirmed, valid, capped)
    c1 = torch.clamp(r2c1, 0, D - 1)
    m1 = (r2c1 >= 0) & (_at(cost1, c1) <= cfg.max_cos_dist)
    dm = scatter_det_flags(r2c1, m1, D)

    # pass 2: tentative tracks and confirmed ones missed exactly one frame, IoU
    rows2 = (tentative | (confirmed & ~m1 & (tsu == 1))) & alive
    iou = fused_iou_cost(xyah2xyxy(mean[..., :4]), det_box, eps=IOU_BATCH_EPS)[0]
    iou_c = torch.where((tsu > 1)[..., None], INFTY, 1.0 - iou)
    iou_c = torch.clamp_max(iou_c, cfg.max_iou_dist + 1e-5)
    r2c2 = _full_assignment(iou_c, rows2, valid & ~dm, capped)
    c2 = torch.clamp(r2c2, 0, D - 1)
    m2 = (r2c2 >= 0) & (_at(iou_c, c2) <= cfg.max_iou_dist)
    dm = dm | scatter_det_flags(r2c2, m2, D)

    matched = m1 | m2
    c = torch.where(m1, c1, c2)

    # the NSA update with the detections' confidences (strongsort_kf)
    det_conf = take(conf, c)
    mean, cov = kalman.update(layout, mean, cov, take(det_xyah, c), matched, conf=det_conf)
    f = take(feat, c)
    sm = l2_normalize(cfg.ema_alpha * state.smooth + (1 - cfg.ema_alpha) * f)
    new_smooth = torch.where(state.has_feat[..., None], sm, f)
    smooth = torch.where(matched[..., None], new_smooth, state.smooth)
    has_feat = state.has_feat | matched

    hits = state.hits + matched.to(torch.int32)
    tsu = torch.where(matched, 0, tsu)
    det_cls = dets[..., 5].contiguous()
    det_ind = dets[..., 6].contiguous()
    conf_s = torch.where(matched, det_conf, state.conf)
    cls_s = torch.where(matched, take(det_cls, c), state.cls)
    det_ind_s = torch.where(matched, take(det_ind, c), state.det_ind)
    status = torch.where(tentative & matched & (hits >= cfg.n_init), CONFIRMED, status0)

    # mark_missed (reference track.py:189-194)
    missed = alive & ~matched
    status = torch.where(missed & tentative, EMPTY, status)
    status = torch.where(missed & confirmed & (tsu > cfg.max_age), EMPTY, status)

    # new tracks from the unmatched detections, into free slots in order
    n_new, free_rank, takes, slot_det = allocate(valid & ~dm, status == EMPTY)
    init_mean_v, init_cov_v = kalman.initiate(layout, take(det_xyah, slot_det))
    mean = torch.where(takes[..., None], init_mean_v, mean)
    cov = torch.where(takes[..., None, None], init_cov_v, cov)
    status = torch.where(takes, TENTATIVE, status)
    tid = torch.where(takes, state.next_id[:, None] + free_rank, state.tid)
    conf_s = torch.where(takes, take(conf, slot_det), conf_s)
    cls_s = torch.where(takes, take(det_cls, slot_det), cls_s)
    det_ind_s = torch.where(takes, take(det_ind, slot_det), det_ind_s)
    hits = torch.where(takes, 1, hits)
    age = torch.where(takes, 1, age)
    tsu = torch.where(takes, 0, tsu)
    smooth = torch.where(takes[..., None], take(feat, slot_det), smooth)
    has_feat = has_feat | takes
    bank_count = torch.where(takes, 0, state.bank_count)

    # the bank's partial_fit (reference tracker.py:97-107): every confirmed
    # track pushes its EMA feature to the front each frame, the oldest drops
    is_conf = status == CONFIRMED
    pushed = torch.cat([smooth[:, :, None], state.bank[:, :, :-1]], dim=2)
    bank = torch.where(is_conf[..., None, None], pushed, state.bank)
    bank_count = torch.where(is_conf, bank_count + 1, 0)

    out_mask = is_conf & (tsu < 1)
    out = torch.cat([xyah2xyxy(mean[..., :4]), tid[..., None].to(torch.float32), conf_s[..., None],
                     cls_s[..., None], det_ind_s[..., None]], dim=-1)

    new_state = StrongSortState(
        mean=mean,
        cov=cov,
        status=status.to(torch.int32),
        hits=hits.to(torch.int32),
        age=age.to(torch.int32),
        tsu=tsu.to(torch.int32),
        tid=tid.to(torch.int32),
        conf=conf_s,
        cls=cls_s,
        det_ind=det_ind_s,
        smooth=smooth,
        has_feat=has_feat,
        bank=bank,
        bank_count=bank_count.to(torch.int32),
        frame_count=frame,
        next_id=state.next_id + n_new,
        lap_capped=capped,
    )
    return new_state, out, out_mask


class StrongSort(BaseTracker):
    """Live tracker with the JAX ``StrongSort`` constructor surface.

    Embeddings passed to ``update(dets, img, embs)`` feed the bank; without
    them ``reid_model`` (e.g. ``reid.ReID``) computes them from the image,
    and without a model every detection's embedding is a row of ones, as in
    the JAX tracker.  CMC is ECC on the tracker's device, applied to every
    frame that comes with an image."""

    supports_obb = False

    def __init__(
        self,
        device,
        reid_model=None,
        min_conf: float = 0.1,
        max_cos_dist: float = 0.2,
        max_iou_dist: float = 0.7,
        n_init: int = 3,
        nn_budget: int = 100,
        mc_lambda: float = 0.98,
        ema_alpha: float = 0.9,
        std_weight_position: float = 1.0 / 20,
        std_weight_velocity: float = 1.0 / 160,
        capacity: int = 256,
        **kwargs,
    ):
        super().__init__(device=device, **kwargs)
        self.model = reid_model
        self.cfg = StrongSortConfig(
            min_conf=min_conf,
            max_cos_dist=max_cos_dist,
            max_iou_dist=max_iou_dist,
            max_age=self.max_age,
            n_init=n_init,
            nn_budget=nn_budget,
            mc_lambda=mc_lambda,
            ema_alpha=ema_alpha,
            feat_dim=model_feature_dim(reid_model),
            std_weight_position=std_weight_position,
            std_weight_velocity=std_weight_velocity,
            capacity=capacity,
        )
        from boxmot_tpu_torch.motion.cmc import create_cmc

        self.cmc = create_cmc("ecc", device=self.device)

    def _init_state(self):
        return init_state(self.cfg, 1, self.device)

    def _lost_mask(self, state):
        """(K,) alive slots missed this frame (the JAX shell's show_kf_preds
        rows), on the device: ``trackers/base.py`` folds it into the frame's
        one read-back."""
        return (state.status[0] != EMPTY) & (state.tsu[0] > 0)

    def _step(self, state, dets_padded, det_valid):
        img, embs, dets = self._frame_inputs
        D = dets_padded.shape[0]
        emb = frame_embs(self.model, embs, img, dets[:, :4], D, self.cfg.feat_dim, self.device,
                         fill=1.0)
        if self.cmc is not None and img is not None:
            warp = self.cmc.apply(img, dets[:, :4])
        else:
            warp = IDENTITY_WARP
        state, out, out_mask = strongsort_step(self.cfg, state, dets_padded[None], det_valid[None],
                                               emb[None], warp_tensor(warp, self.device)[None])
        return state, out[0], out_mask[0]
