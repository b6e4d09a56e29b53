"""SFSORT (AABB and OBB) as a fixed-capacity slot bank, batched over S sequences.

Counterpart of ``boxmot_tpu/trackers/sfsort.py``: a Kalman-free tracker
whose state is the last matched box.  Pass 1 matches high-confidence
detections by the BBSI cost, 1 - (diou + sh + sw) / 3; pass 2 matches the
intermediate ones to the pass-1 leftovers by plain IoU.  Lost tracks split
into central and marginal by the frame margins, each with its timeout.
Both passes run kernel K2 (``ops.lap.masked_assignment``); in OBB mode the
rotated IoU of both passes is one launch of kernel K3
(``ops.rotated_iou``), since both passes compare the same boxes.

The reference quirks the JAX module keeps are kept: the AABB cost's
swapped "h_intersection" (along x) and "w_intersection" (along y); a frame
without high-confidence detections drops every unmatched track when it has
intermediate ones; timeouts of 0 purge lost tracks at once; ids start at 0
and every active track is emitted.  ``any_high`` and ``any_inter`` stay
(S, 1) tensors, and the step uses masks and ``torch.where`` only, so a
replay runs without a host sync.

Slot states: 0 = active, 1 = lost central, 2 = lost marginal, 3 = empty.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from boxmot_tpu_torch.motion.kalman import align_obb_to_ref
from boxmot_tpu_torch.ops.geometry import exact, obb2xyxy, wrap_angle
from boxmot_tpu_torch.ops.lap import masked_assignment
from boxmot_tpu_torch.ops.rotated_iou import rotated_iou
from boxmot_tpu_torch.trackers.base import BaseTracker
from boxmot_tpu_torch.trackers.slots import allocate, scatter_det_flags, take

EMPTY, ACTIVE, LOST_CENTRAL, LOST_MARGINAL = 3, 0, 1, 2
_EPS = 1e-7


def _third(x):
    """x / 3 as a true division: a CUDA division by a Python scalar
    multiplies by its float32 reciprocal, which is not x / 3."""
    return x / torch.full_like(x, 3.0)


@dataclasses.dataclass(frozen=True)
class SFSortConfig:
    """Field for field the JAX ``SFSortConfig``, with the same defaults."""

    high_th: float = 0.6
    match_th_first: float = 0.67
    new_track_th: float = 0.7
    low_th: float = 0.1
    match_th_second: float = 0.3
    dynamic_tuning: bool = False
    cth: float = 0.5
    high_th_m: float = 0.0
    new_track_th_m: float = 0.0
    match_th_first_m: float = 0.0
    marginal_timeout: int = 0
    central_timeout: int = 0
    is_obb: bool = False
    obb_theta_damping: float = 0.8
    capacity: int = 256


@dataclasses.dataclass
class SFSortState:
    """S slot banks of capacity K.  The fields up to ``margins`` are the JAX
    ``SFSortState`` fields with a leading S axis."""

    bbox: torch.Tensor  # (S, K, 4) last matched xyxy box; (S, K, 5) xywha (OBB)
    theta_vel: torch.Tensor  # (S, K) damped angle velocity (OBB; zeros for AABB)
    status: torch.Tensor  # (S, K) int32
    tid: torch.Tensor  # (S, K) int32
    conf: torch.Tensor  # (S, K) f32
    cls: torch.Tensor  # (S, K) f32
    det_ind: torch.Tensor  # (S, K) f32
    last_frame: torch.Tensor  # (S, K) int32
    frame_count: torch.Tensor  # (S,) int32
    next_id: torch.Tensor  # (S,) int32
    margins: torch.Tensor  # (S, 4) f32: left, right, top, bottom
    lap_capped: torch.Tensor  # (S,) int32 solves that stopped at the iteration cap


JAX_FIELDS = tuple(f.name for f in dataclasses.fields(SFSortState))[:-1]
NO_MARGINS = (0.0, 1e9, 0.0, 1e9)


def init_state(cfg: SFSortConfig, n: int, device, margins=None) -> SFSortState:
    """n fresh slot banks on ``device``; ``margins`` is (4,) or (n, 4)."""
    K = cfg.capacity
    values = np.broadcast_to(np.asarray(NO_MARGINS if margins is None else margins, np.float32),
                             (n, 4))
    # filled value by value: a copy from host memory would sync a replay
    margins = torch.empty((n, 4), dtype=torch.float32, device=device)
    for i in range(n):
        for j in range(4):
            margins[i, j].fill_(float(values[i, j]))
    bbox = torch.zeros((n, K, 5 if cfg.is_obb else 4), dtype=torch.float32, device=device)
    if cfg.is_obb:
        bbox[..., 2:4] = 1.0  # unit boxes: the rotated IoU stays finite

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros((n, *shape), dtype=dtype, device=device)

    return SFSortState(
        bbox=bbox,
        theta_vel=zeros(K, dtype=torch.float32),
        status=torch.full((n, K), EMPTY, dtype=torch.int32, device=device),
        tid=zeros(K),
        conf=zeros(K, dtype=torch.float32),
        cls=zeros(K, dtype=torch.float32),
        det_ind=zeros(K, dtype=torch.float32),
        last_frame=zeros(K),
        frame_count=zeros(),
        next_id=zeros(),
        margins=margins,
        lap_capped=zeros(),
    )


def state_from_numpy(arrays, device) -> SFSortState:
    """The port's state from the JAX ``SFSortState`` fields as numpy arrays
    with a leading S axis."""
    fields = {name: torch.from_numpy(np.ascontiguousarray(arrays[name])).to(device)
              for name in JAX_FIELDS}
    S = fields["status"].shape[0]
    return SFSortState(**fields, lap_capped=torch.zeros((S,), dtype=torch.int32, device=device))


def state_to_numpy(state: SFSortState) -> dict:
    """The JAX ``SFSortState`` fields as numpy arrays with a leading S axis."""
    return {name: getattr(state, name).cpu().numpy() for name in JAX_FIELDS}


def bbsi_cost(trk, det):
    """BBSI cost (S, K, D) between xyxy boxes (S, K, 4) and (S, D, 4), the
    reference math verbatim, swapped w/h naming included."""
    b1_x1, b1_y1, b1_x2, b1_y2 = (trk[:, :, None, i] for i in range(4))
    b2_x1, b2_y1, b2_x2, b2_y2 = (det[:, None, :, i] for i in range(4))

    h_inter = torch.clamp_min(torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1), 0)
    w_inter = torch.clamp_min(torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1), 0)
    inter = h_inter * w_inter

    box1_h = b1_x2 - b1_x1  # the reference's "height", along x
    box2_h = b2_x2 - b2_x1
    box1_w = b1_y2 - b1_y1
    box2_w = b2_y2 - b2_y1
    union = box2_h * box2_w + box1_h * box1_w - inter + _EPS
    iou = inter / union

    cx1 = (b1_x1 + b1_x2) / 2.0
    cy1 = (b1_y1 + b1_y2) / 2.0
    cx2 = (b2_x1 + b2_x2) / 2.0
    cy2 = (b2_y1 + b2_y2) / 2.0
    dw = torch.abs(box2_w - box1_w)
    sw = w_inter / torch.abs(w_inter + dw + _EPS)
    dh = torch.abs(box2_h - box1_h)
    sh = h_inter / torch.abs(h_inter + dh + _EPS)

    inner = torch.abs(cx1 - cx2) + torch.abs(cy1 - cy2)
    xxc1 = torch.minimum(b1_x1, b2_x1)
    yyc1 = torch.minimum(b1_y1, b2_y1)
    xxc2 = torch.maximum(b1_x2, b2_x2)
    yyc2 = torch.maximum(b1_y2, b2_y2)
    outer = torch.clamp_min(torch.abs(xxc2 - xxc1) + torch.abs(yyc2 - yyc1), _EPS)
    diou = iou - inner / outer
    return 1.0 - _third(diou + sh + sw)


def bbsi_cost_obb(trk, det, iou):
    """OBB BBSI cost (S, K, D) between xywha boxes (S, K, 5) and (S, D, 5),
    given their rotated IoU: min/max width and height ratios, and L1
    diagonals over the corners' axis-aligned hulls."""
    tw, th = trk[:, :, None, 2], trk[:, :, None, 3]
    dw, dh = det[:, None, :, 2], det[:, None, :, 3]
    sw = torch.minimum(tw, dw) / (torch.maximum(tw, dw) + _EPS)
    sh = torch.minimum(th, dh) / (torch.maximum(th, dh) + _EPS)
    inner = (torch.abs(trk[:, :, None, 0] - det[:, None, :, 0])
             + torch.abs(trk[:, :, None, 1] - det[:, None, :, 1]))
    t_hull, d_hull = obb2xyxy(trk), obb2xyxy(det)
    xxc1 = torch.minimum(t_hull[:, :, None, 0], d_hull[:, None, :, 0])
    yyc1 = torch.minimum(t_hull[:, :, None, 1], d_hull[:, None, :, 1])
    xxc2 = torch.maximum(t_hull[:, :, None, 2], d_hull[:, None, :, 2])
    yyc2 = torch.maximum(t_hull[:, :, None, 3], d_hull[:, None, :, 3])
    outer = torch.clamp_min(torch.abs(xxc2 - xxc1) + torch.abs(yyc2 - yyc1), _EPS)
    diou = iou - inner / outer
    return 1.0 - _third(diou + sh + sw)


def iou_cost(trk, det):
    """1 - IoU (S, K, D) between xyxy boxes, with eps 1e-7 added to the union."""
    xx1 = torch.maximum(trk[:, :, None, 0], det[:, None, :, 0])
    yy1 = torch.maximum(trk[:, :, None, 1], det[:, None, :, 1])
    xx2 = torch.minimum(trk[:, :, None, 2], det[:, None, :, 2])
    yy2 = torch.minimum(trk[:, :, None, 3], det[:, None, :, 3])
    inter = torch.clamp_min(xx2 - xx1, 0) * torch.clamp_min(yy2 - yy1, 0)
    a1 = (trk[..., 2] - trk[..., 0]) * (trk[..., 3] - trk[..., 1])
    a2 = (det[..., 2] - det[..., 0]) * (det[..., 3] - det[..., 1])
    return 1.0 - inter / (a1[:, :, None] + a2[:, None, :] - inter + _EPS)


def _thresholds(cfg: SFSortConfig, conf, det_valid):
    """(high, new-track, first-match) thresholds: floats, or (S, 1), (S, 1)
    and (S,) tensors under dynamic tuning."""
    if not cfg.dynamic_tuning:
        return cfg.high_th, cfg.new_track_th, cfg.match_th_first
    count = torch.clamp_min(((conf > cfg.cth) & det_valid).sum(dim=1, keepdim=True), 1)
    lnc = exact(torch.log10, count.to(torch.float32))
    hth = torch.clamp(cfg.high_th - cfg.high_th_m * lnc, 0.0, 1.0)
    nth = torch.maximum(cfg.new_track_th + cfg.new_track_th_m * lnc, hth).clamp_max(1.0)
    mth = torch.clamp(cfg.match_th_first - cfg.match_th_first_m * lnc, 0.0, 0.67)
    return hth, nth, mth[:, 0].contiguous()


def sfsort_step(cfg: SFSortConfig, state: SFSortState, dets: torch.Tensor,
                det_valid: torch.Tensor):
    """One frame of S sequences.

    dets: (S, D, 7) [x1, y1, x2, y2, conf, cls, det_ind], or (S, D, 8)
    [cx, cy, w, h, theta, conf, cls, det_ind] when ``cfg.is_obb``; padding
    rows with conf = -1; det_valid: (S, D) bool.  Returns (state, out
    (S, K, 8) or (S, K, 9), out_mask (S, K)).
    """
    obb = cfg.is_obb
    B = 5 if obb else 4
    D = dets.shape[1]
    frame = (state.frame_count + 1)[:, None]  # (S, 1)
    conf = dets[..., B]
    det_box = dets[..., :B].contiguous()
    hth, nth, mth = _thresholds(cfg, conf, det_valid)

    # purge stale lost tracks
    age = frame - state.last_frame
    status = state.status
    status = torch.where((status == LOST_CENTRAL) & (age > cfg.central_timeout), EMPTY, status)
    status = torch.where((status == LOST_MARGINAL) & (age > cfg.marginal_timeout), EMPTY, status)

    pool = status != EMPTY
    high = det_valid & (conf > hth)
    inter = det_valid & (conf > cfg.low_th) & (conf < hth)
    any_high = high.any(dim=1, keepdim=True)
    any_inter = inter.any(dim=1, keepdim=True)

    # pass 1: BBSI cost; pass 2: intermediate dets vs the pass-1 leftovers,
    # IoU only, and only when the frame had high detections
    if obb:
        iou = rotated_iou(state.bbox.contiguous(), det_box)
        cost1 = bbsi_cost_obb(state.bbox, det_box, iou)
        cost2 = 1.0 - iou
    else:
        cost1 = bbsi_cost(state.bbox, det_box)
        cost2 = iou_cost(state.bbox, det_box)
    capped = state.lap_capped.clone()
    r2c1 = masked_assignment(cost1.contiguous(), pool, high, mth, capped)
    m1 = (r2c1 >= 0) & any_high
    dm1 = scatter_det_flags(r2c1, m1, D)
    r2c2 = masked_assignment(cost2.contiguous(), pool & ~m1, inter, cfg.match_th_second, capped)
    m2 = (r2c2 >= 0) & any_high & any_inter

    matched = m1 | m2
    det_col = torch.clamp(torch.where(m1, r2c1, r2c2), 0, D - 1)
    meas = take(det_box, det_col)
    theta_vel = state.theta_vel
    if obb:
        # align the 4-way OBB parameterization to the track, then smooth the
        # angle with a damped velocity
        aligned = align_obb_to_ref(meas, state.bbox)
        prev_theta = state.bbox[..., 4]
        delta = wrap_angle(aligned[..., 4] - prev_theta)
        d = cfg.obb_theta_damping
        new_tv = d * theta_vel + (1.0 - d) * delta
        theta_vel = torch.where(matched, new_tv, theta_vel)
        meas = torch.cat([aligned[..., :4], wrap_angle(prev_theta + new_tv)[..., None]], -1)
    bbox = torch.where(matched[..., None], meas, state.bbox)
    det_cls = dets[..., B + 1]
    det_ind = dets[..., B + 2]
    conf_s = torch.where(matched, take(conf, det_col), state.conf)
    cls_s = torch.where(matched, take(det_cls, det_col), state.cls)
    det_ind_s = torch.where(matched, take(det_ind, det_col), state.det_ind)
    last_frame = torch.where(matched, frame, state.last_frame)
    status = torch.where(matched, ACTIVE, status)

    # the unmatched pool goes lost (central or marginal by its centre), or
    # is dropped when the frame had only intermediate detections
    unmatched = pool & ~matched
    if obb:
        u, v = bbox[..., 0], bbox[..., 1]
    else:
        u = (bbox[..., 0] + bbox[..., 2]) / 2.0
        v = (bbox[..., 1] + bbox[..., 3]) / 2.0
    m = state.margins
    central = (m[:, 0:1] < u) & (u < m[:, 1:2]) & (m[:, 2:3] < v) & (v < m[:, 3:4])
    lost_state = torch.where(central, LOST_CENTRAL, LOST_MARGINAL)
    goes_lost = torch.where(any_high, unmatched, unmatched & ~any_inter)
    already_lost = (status == LOST_CENTRAL) | (status == LOST_MARGINAL)
    status = torch.where(goes_lost & ~already_lost, lost_state, status)
    status = torch.where(unmatched & ~goes_lost & (status == ACTIVE), EMPTY, status)

    # new tracks from unmatched high detections above the new-track threshold
    new_det = high & ~dm1 & (conf > nth)
    n_new, free_rank, takes, slot_det = allocate(new_det, status == EMPTY)
    bbox = torch.where(takes[..., None], take(det_box, slot_det), bbox)
    status = torch.where(takes, ACTIVE, status)
    tid = torch.where(takes, state.next_id[:, None] + free_rank, state.tid)
    conf_s = torch.where(takes, take(conf, slot_det), conf_s)
    cls_s = torch.where(takes, take(det_cls, slot_det), cls_s)
    det_ind_s = torch.where(takes, take(det_ind, slot_det), det_ind_s)
    last_frame = torch.where(takes, frame, last_frame)
    theta_vel = torch.where(takes, 0.0, theta_vel)

    out_mask = (status == ACTIVE) & (last_frame == frame)
    out = torch.cat([bbox, tid[..., None].to(torch.float32), conf_s[..., None],
                     cls_s[..., None], det_ind_s[..., None]], dim=-1)
    new_state = SFSortState(
        bbox=bbox,
        theta_vel=theta_vel,
        status=status.to(torch.int32),
        tid=tid.to(torch.int32),
        conf=conf_s,
        cls=cls_s,
        det_ind=det_ind_s,
        last_frame=last_frame.to(torch.int32),
        frame_count=state.frame_count + 1,
        next_id=state.next_id + n_new,
        margins=state.margins,
        lap_capped=capped,
    )
    return new_state, out, out_mask


class SFSORT(BaseTracker):
    """Live tracker with the JAX ``SFSORT`` constructor surface and clamps."""

    supports_obb = True

    def __init__(
        self,
        device,
        high_th: float = 0.6,
        match_th_first: float = 0.67,
        new_track_th: float = 0.7,
        low_th: float = 0.1,
        match_th_second: float = 0.3,
        dynamic_tuning: bool = False,
        cth: float = 0.5,
        high_th_m: float = 0.0,
        new_track_th_m: float = 0.0,
        match_th_first_m: float = 0.0,
        marginal_timeout: int = 0,
        central_timeout: int = 0,
        obb_theta_damping: float = 0.8,
        frame_width=None,
        frame_height=None,
        horizontal_margin=None,
        vertical_margin=None,
        capacity: int = 256,
        **kwargs,
    ):
        super().__init__(device=device, **kwargs)

        def clamp(v, lo, hi):
            return max(lo, min(v, hi))

        high_th = clamp(high_th, 0.0, 1.0)
        self.cfg = SFSortConfig(
            high_th=high_th,
            match_th_first=clamp(match_th_first, 0.0, 0.67),
            new_track_th=clamp(new_track_th, high_th, 1.0),
            low_th=clamp(low_th, 0.0, high_th),
            match_th_second=clamp(match_th_second, 0.0, 1.0),
            dynamic_tuning=dynamic_tuning,
            cth=clamp(cth, low_th, 1.0),
            high_th_m=clamp(high_th_m, 0.02, 0.1) if dynamic_tuning else high_th_m,
            new_track_th_m=clamp(new_track_th_m, 0.02, 0.08) if dynamic_tuning else new_track_th_m,
            match_th_first_m=(clamp(match_th_first_m, 0.02, 0.08) if dynamic_tuning
                              else match_th_first_m),
            marginal_timeout=int(clamp(marginal_timeout, 0, 500)),
            central_timeout=int(clamp(central_timeout, 0, 1000)),
            is_obb=self.is_obb,
            obb_theta_damping=clamp(obb_theta_damping, 0.0, 1.0),
            capacity=capacity,
        )
        self._margin_cfg = (frame_width, frame_height, horizontal_margin, vertical_margin)

    def _set_detection_mode(self, is_obb: bool):
        super()._set_detection_mode(is_obb)
        self.cfg = dataclasses.replace(self.cfg, is_obb=is_obb)

    def _margins(self):
        """[left, right, top, bottom] of the central region, from the frame
        size (given, or the first image's) and the margins."""
        fw, fh, hm, vm = self._margin_cfg
        fw = fw if fw is not None else self.w
        fh = fh if fh is not None else self.h
        if fw is None or fh is None:
            return np.array(NO_MARGINS, np.float32)
        left, right = 0.0, float(fw)
        top, bottom = 0.0, float(fh)
        if hm is not None:
            left = float(np.clip(hm, 0, fw))
            right = float(np.clip(fw - hm, 0, fw))
        if vm is not None:
            top = float(np.clip(vm, 0, fh))
            bottom = float(np.clip(fh - vm, 0, fh))
        return np.array([left, right, top, bottom], np.float32)

    def _init_state(self):
        return init_state(self.cfg, 1, self.device, margins=self._margins())

    def _lost_mask(self, state):
        # central + marginal lost slots (show_kf_preds overlays)
        return (state.status[0] == LOST_CENTRAL) | (state.status[0] == LOST_MARGINAL)

    def _step(self, state, dets_padded, det_valid):
        state, out, out_mask = sfsort_step(self.cfg, state, dets_padded[None], det_valid[None])
        return state, out[0], out_mask[0]
