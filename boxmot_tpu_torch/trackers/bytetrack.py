"""ByteTrack (AABB and OBB) as a fixed-capacity slot bank, batched over S sequences.

Counterpart of ``boxmot_tpu/trackers/bytetrack.py``.  The JAX step runs
one sequence and ``vmap`` batches it; here every state tensor carries an
explicit leading axis S and one ``bytetrack_step`` call advances S
independent sequences by one frame.  The association semantics are those
of the JAX step (see its module docstring); per frame the step runs:

* the Kalman predict over the tracked + lost pool (XYAH; XYWH + angle for
  oriented boxes);
* the shared IoU matrix and the fused-score cost ``1 - iou * conf``: kernel
  K1 (``ops.fused_iou_cost``, with ``iou_batch``'s union clamp, as the JAX
  step) for axis-aligned boxes, kernel K3
  (``ops.rotated_iou``) and an elementwise cost for oriented ones;
* kernel K2 (``ops.lap.masked_assignment``) for the three passes;
* one masked Joseph-form update for every matched slot (oriented
  measurements first aligned to the track's angle, and the angular
  velocity damped x0.8 after it);
* lifecycle changes, slot allocation for new tracks, duplicate
  suppression between tracked and lost (K1's IoU-only mode, or K3) and
  emission.

The step uses masks and ``torch.where`` only: no ``.item()``, no branch on
a tensor, no boolean-mask indexing and no ``nonzero``, so on a CUDA device
a whole replay runs without a host sync (``trackers/slots.py`` has the
scatters and the slot allocation).

Slot states: 0 = empty, 1 = tracked, 2 = lost.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from boxmot_tpu_torch.motion import kalman
from boxmot_tpu_torch.ops.fused_iou_cost import IOU_BATCH_EPS, fused_iou_cost
from boxmot_tpu_torch.ops.geometry import obb_corners, xyah2xyxy, xyxy2xyah
from boxmot_tpu_torch.ops.lap import masked_assignment
from boxmot_tpu_torch.ops.rotated_iou import rotated_iou
from boxmot_tpu_torch.trackers.base import BaseTracker
from boxmot_tpu_torch.trackers.slots import allocate, scatter_det_flags, take

EMPTY, TRACKED, LOST = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class ByteTrackConfig:
    """Field for field the JAX ``ByteTrackConfig``, with the same defaults."""

    track_thresh: float = 0.45
    match_thresh: float = 0.8
    min_conf: float = 0.1
    det_thresh: float = 0.45  # the reference sets det_thresh = track_thresh
    max_time_lost: int = 25
    is_obb: bool = False  # oriented boxes: XYWH-5 filter + rotated IoU
    std_weight_position: float = 1.0 / 20
    std_weight_velocity: float = 1.0 / 160
    capacity: int = 256


@dataclasses.dataclass
class ByteTrackState:
    """S slot banks of capacity K.  The fields up to ``next_id`` are the JAX
    ``ByteTrackState`` fields with a leading S axis."""

    mean: torch.Tensor  # (S, K, 8) xyah + velocities; (S, K, 10) xywh + angle (OBB)
    cov: torch.Tensor  # (S, K, 8, 8); (S, K, 10, 10) (OBB)
    status: torch.Tensor  # (S, K) int32: EMPTY/TRACKED/LOST
    activated: torch.Tensor  # (S, K) bool
    tid: torch.Tensor  # (S, K) int32 track id
    conf: torch.Tensor  # (S, K) f32
    cls: torch.Tensor  # (S, K) f32
    det_ind: torch.Tensor  # (S, K) f32
    frame_id: torch.Tensor  # (S, K) int32 last-update frame
    start_frame: torch.Tensor  # (S, K) int32
    tracklet_len: torch.Tensor  # (S, K) int32
    frame_count: torch.Tensor  # (S,) int32
    next_id: torch.Tensor  # (S,) int32
    lap_capped: torch.Tensor  # (S,) int32 solves that stopped at the iteration cap


JAX_FIELDS = tuple(f.name for f in dataclasses.fields(ByteTrackState))[:-1]


def init_state(cfg: ByteTrackConfig, n: int, device) -> ByteTrackState:
    """n fresh slot banks on ``device``."""
    K = cfg.capacity
    dx = 10 if cfg.is_obb else 8

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros((n, *shape), dtype=dtype, device=device)

    return ByteTrackState(
        mean=zeros(K, dx, dtype=torch.float32),
        cov=zeros(K, dx, dx, dtype=torch.float32),
        status=zeros(K),
        activated=zeros(K, dtype=torch.bool),
        tid=zeros(K),
        conf=zeros(K, dtype=torch.float32),
        cls=zeros(K, dtype=torch.float32),
        det_ind=zeros(K, dtype=torch.float32),
        frame_id=zeros(K),
        start_frame=zeros(K),
        tracklet_len=zeros(K),
        frame_count=zeros(),
        next_id=torch.ones((n,), dtype=torch.int32, device=device),
        lap_capped=zeros(),
    )


def state_from_numpy(arrays, device) -> ByteTrackState:
    """The port's state from the JAX ``ByteTrackState`` fields as numpy
    arrays with a leading S axis (e.g. ``np.asarray`` of a vmapped state)."""
    fields = {name: torch.from_numpy(np.ascontiguousarray(arrays[name])).to(device)
              for name in JAX_FIELDS}
    S = fields["status"].shape[0]
    return ByteTrackState(**fields,
                          lap_capped=torch.zeros((S,), dtype=torch.int32, device=device))


def state_to_numpy(state: ByteTrackState) -> dict:
    """The JAX ``ByteTrackState`` fields as numpy arrays with a leading S axis."""
    return {name: getattr(state, name).cpu().numpy() for name in JAX_FIELDS}


def bytetrack_step(cfg: ByteTrackConfig, state: ByteTrackState, dets: torch.Tensor,
                   det_valid: torch.Tensor):
    """One frame of S sequences.

    dets: (S, D, 7) [x1, y1, x2, y2, conf, cls, det_ind], or (S, D, 8)
    [cx, cy, w, h, theta, conf, cls, det_ind] when ``cfg.is_obb``; padding
    rows with conf = -1; det_valid: (S, D) bool.  Returns (state, out
    (S, K, 8) or (S, K, 9), out_mask (S, K)).
    """
    obb = cfg.is_obb
    if obb:
        layout = kalman.make_xywh_layout(True, cfg.std_weight_position, cfg.std_weight_velocity)
        conf_i, cls_i, ind_i = 5, 6, 7
    else:
        layout = kalman.make_xyah_layout(cfg.std_weight_position, cfg.std_weight_velocity)
        conf_i, cls_i, ind_i = 4, 5, 6
    D = dets.shape[1]
    frame = (state.frame_count + 1)[:, None]  # (S, 1)

    conf = dets[..., conf_i].contiguous()
    first = det_valid & (conf > cfg.track_thresh)
    second = det_valid & (conf > cfg.min_conf) & (conf < cfg.track_thresh)

    status0 = state.status
    tracked_act = (status0 == TRACKED) & state.activated
    unconf = (status0 == TRACKED) & ~state.activated
    lost = status0 == LOST
    pool = tracked_act | lost

    # KF predict over the pool; lost tracks get their size (and angle)
    # velocities zeroed
    mean = torch.cat([state.mean[..., :7],
                      torch.where(lost[..., None], 0.0, state.mean[..., 7:])], -1)
    pmean, pcov = kalman.predict(layout, mean, state.cov, pool)

    # rows not updated between passes keep their predicted means, so one
    # IoU matrix serves all three passes
    if obb:
        det_meas = dets[..., :5].contiguous()
        iou = rotated_iou(pmean[..., :5].contiguous(), det_meas)
        cost1 = 1.0 - iou * conf[:, None, :]
    else:
        det_xyxy = dets[..., :4].contiguous()
        det_meas = xyxy2xyah(det_xyxy)
        iou, cost1 = fused_iou_cost(xyah2xyxy(pmean[..., :4]), det_xyxy, conf, eps=IOU_BATCH_EPS)
    capped = state.lap_capped.clone()

    # pass 1: high-conf dets vs pool, fused-score cost
    r2c1 = masked_assignment(cost1, pool, first, cfg.match_thresh, capped)
    m1 = r2c1 >= 0
    dm1 = scatter_det_flags(r2c1, m1, D)

    # pass 2: low-conf dets vs unmatched TRACKED slots, plain IoU
    r_tracked = pool & ~m1 & (status0 == TRACKED)
    r2c2 = masked_assignment(1.0 - iou, r_tracked, second, 0.5, capped)
    m2 = r2c2 >= 0

    # unconfirmed pass: leftover high-conf dets vs unconfirmed tracks
    u_first = first & ~dm1
    r2c3 = masked_assignment(cost1, unconf, u_first, 0.7, capped)
    m3 = r2c3 >= 0
    dm3 = scatter_det_flags(r2c3, m3, D)

    # one KF update for every matched slot
    matched = m1 | m2 | m3
    det_col = torch.where(m1, r2c1, torch.where(m2, r2c2, r2c3))
    c = torch.clamp(det_col, 0, D - 1)
    meas = take(det_meas, c)
    if obb:
        # resolve the rotated-rect parameterization against the state
        meas = kalman.align_obb_to_ref(meas, pmean[..., :5])
    new_mean, new_cov = kalman.update(layout, pmean, pcov, meas, matched)
    if obb:
        # angular velocity damped x0.8 after every observed update
        theta_v = torch.where(matched, new_mean[..., 9] * 0.8, new_mean[..., 9])
        new_mean = torch.cat([new_mean[..., :9], theta_v[..., None]], -1)

    # bookkeeping for matched slots
    was_tracked = status0 == TRACKED  # update() vs re_activate()
    tracklet_len = torch.where(
        matched, torch.where(was_tracked, state.tracklet_len + 1, 0), state.tracklet_len
    )
    status = torch.where(matched, TRACKED, status0)
    activated = state.activated | matched
    det_cls = dets[..., cls_i].contiguous()
    det_ind = dets[..., ind_i].contiguous()
    conf_s = torch.where(matched, take(conf, c), state.conf)
    cls_s = torch.where(matched, take(det_cls, c), state.cls)
    det_ind_s = torch.where(matched, take(det_ind, c), state.det_ind)
    frame_id = torch.where(matched, frame, state.frame_id)

    # drop aged-out lost tracks (before this frame's new lost)
    aged = (status == LOST) & (frame - frame_id > cfg.max_time_lost)
    status = torch.where(aged, EMPTY, status)
    # tracked slots unmatched in both passes become lost
    status = torch.where(r_tracked & ~m2, LOST, status)
    # unmatched unconfirmed tracks are removed
    status = torch.where(unconf & ~m3, EMPTY, status)

    # new tracks from the remaining high-conf dets, into free slots in order
    new_det = u_first & ~dm3 & (conf >= cfg.det_thresh)
    n_new, free_rank, takes, slot_det = allocate(new_det, status == EMPTY)

    init_mean_v, init_cov_v = kalman.initiate(layout, take(det_meas, slot_det))
    new_mean = torch.where(takes[..., None], init_mean_v, new_mean)
    new_cov = torch.where(takes[..., None, None], init_cov_v, new_cov)
    status = torch.where(takes, TRACKED, status)
    activated = torch.where(takes, frame == 1, activated)
    tid = torch.where(takes, state.next_id[:, None] + free_rank, state.tid)
    conf_s = torch.where(takes, take(conf, slot_det), conf_s)
    cls_s = torch.where(takes, take(det_cls, slot_det), cls_s)
    det_ind_s = torch.where(takes, take(det_ind, slot_det), det_ind_s)
    frame_id = torch.where(takes, frame, frame_id)
    start_frame = torch.where(takes, frame, state.start_frame)
    tracklet_len = torch.where(takes, 0, tracklet_len)

    # duplicate suppression between tracked and lost: pairs closer than IoU
    # distance 0.15 keep the longer-lived track
    if obb:
        out_box = new_mean[..., :5].contiguous()
        corners = obb_corners(out_box).contiguous()
        pair_iou = rotated_iou(out_box, out_box, corners, corners)
    else:
        out_box = xyah2xyxy(new_mean[..., :4])
        pair_iou, _ = fused_iou_cost(out_box, out_box, eps=IOU_BATCH_EPS)
    a_mask = status == TRACKED
    b_mask = status == LOST
    close = (1.0 - pair_iou) < 0.15
    pair = close & a_mask[:, :, None] & b_mask[:, None, :]
    age = frame_id - start_frame
    time_a = age[:, :, None]
    time_b = age[:, None, :]
    dup_a = torch.any(pair & (time_a <= time_b), dim=2)
    dup_b = torch.any(pair & (time_a > time_b), dim=1)
    status = torch.where(dup_a & a_mask, EMPTY, status)
    status = torch.where(dup_b & b_mask, EMPTY, status)

    out_mask = (status == TRACKED) & activated
    out = torch.cat(
        [out_box, tid[..., None].to(torch.float32), conf_s[..., None], cls_s[..., None],
         det_ind_s[..., None]],
        dim=-1,
    )
    new_state = ByteTrackState(
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
        frame_count=state.frame_count + 1,
        next_id=state.next_id + n_new,
        lap_capped=capped,
    )
    return new_state, out, out_mask


class ByteTrack(BaseTracker):
    """Live tracker with the JAX ``ByteTrack`` constructor surface."""

    supports_obb = True

    def __init__(
        self,
        device,
        min_conf: float = 0.1,
        track_thresh: float = 0.45,
        match_thresh: float = 0.8,
        track_buffer: int = 25,
        frame_rate: int = 30,
        std_weight_position: float = 1.0 / 20,
        std_weight_velocity: float = 1.0 / 160,
        capacity: int = 256,
        **kwargs,
    ):
        super().__init__(device=device, **kwargs)
        # the reference resolution: det_thresh follows track_thresh, and
        # lost tracks live int(frame_rate / 30 * track_buffer) frames
        self.cfg = ByteTrackConfig(
            track_thresh=track_thresh,
            match_thresh=match_thresh,
            min_conf=min_conf,
            det_thresh=track_thresh,
            max_time_lost=int(frame_rate / 30.0 * track_buffer),
            is_obb=self.is_obb,
            std_weight_position=std_weight_position,
            std_weight_velocity=std_weight_velocity,
            capacity=capacity,
        )

    def _set_detection_mode(self, is_obb: bool):
        super()._set_detection_mode(is_obb)
        self.cfg = dataclasses.replace(self.cfg, is_obb=is_obb)

    def _init_state(self):
        return init_state(self.cfg, 1, self.device)

    def _step(self, state, dets_padded, det_valid):
        state, out, out_mask = bytetrack_step(self.cfg, state, dets_padded[None], det_valid[None])
        return state, out[0], out_mask[0]
