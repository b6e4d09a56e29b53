"""Sam2Mot: hybrid bbox + mask tracker, on the host.

The port's own copy of ``boxmot_tpu/trackers/sam2mot.py``, unchanged below
this paragraph but for its imports (the port's ``BaseTracker``, whose
``_preprocess`` it calls, and ``TrackResults``) and a ``device`` argument,
which it takes for the uniform ``create_tracker`` API and ignores: sam2mot
runs numpy and scipy on the host in both packages.  That is its design, not
a fallback: its inputs are segmentation masks of any resolution and its hot
math is set operations on ragged masks.

Sam2Mot: hybrid bbox + mask tracker.

Re-implementation of the reference Sam2Mot
(boxmot/trackers/hybrid/sam2mot/sam2mot.py:25-723): three-stage matching
(high-conf IoU on velocity-predicted boxes, low-conf on leftovers,
last-matched-bbox recovery), cross-object-interaction occlusion
resolution via mask IoU with confidence mean/variance arbitration,
frame-out recovery, untracked-region gating for new tracks, and
RELIABLE/PENDING/SUSPICIOUS/LOST/FRAME_OUT states.

Design note: unlike the bbox trackers, this stays a host-side numpy
tracker.  Its inputs are externally produced segmentation masks of
arbitrary, per-source resolution, and its hot math is mask set-ops on
ragged shapes — a poor fit for fixed-shape XLA programs and an
inherently IO-bound workflow in the reference too.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
from scipy.optimize import linear_sum_assignment

from boxmot_tpu_torch.trackers.base import BaseTracker
from boxmot_tpu_torch.trackers.track_results import TrackResults

RELIABLE, PENDING, SUSPICIOUS, LOST, FRAME_OUT = (
    "reliable",
    "pending",
    "suspicious",
    "lost",
    "frame_out",
)


@dataclass
class _Track:
    id: int
    bbox: np.ndarray
    mask: np.ndarray | None
    confidence: float
    state: str
    lost_frames: int
    age: int
    conf_history: deque
    last_seen_frame: int
    init_frame: int
    prev_bbox: np.ndarray | None = None
    velocity: np.ndarray | None = None
    is_dense: bool = False
    last_matched_frame: int | None = None
    last_matched_bbox: np.ndarray | None = None
    last_matched_density: float = 0.0
    skip_memory_current: bool = False
    cls: int = 0
    det_ind: int = -1


def _iou_matrix(a, b):
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    xx1 = np.maximum(a[:, None, 0], b[None, :, 0])
    yy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    xx2 = np.minimum(a[:, None, 2], b[None, :, 2])
    yy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(aa[:, None] + ab[None, :] - inter, 1e-6)


def mask_iou(m1, m2):
    if m1 is None or m2 is None or m1.shape != m2.shape:
        return 0.0
    inter = np.logical_and(m1, m2).sum()
    union = np.logical_or(m1, m2).sum()
    return float(inter) / max(float(union), 1e-6)


class Sam2Mot(BaseTracker):
    """Hybrid bbox + mask tracker with the reference constructor surface
    (sam2mot.py:220-274)."""

    supports_masks = True
    supports_obb = False

    def __init__(
        self,
        device=None,
        det_thresh: float = 0.3,
        max_age: int = 60,
        min_hits: int = 1,
        iou_threshold: float = 0.3,
        per_class: bool = False,
        tolerance_frames: int = 30,
        memory_window: int = 25,
        cost_weight: float = 0.5,
        tau_r: float = 0.8,
        tau_p: float = 0.5,
        tau_s: float = 0.3,
        density_threshold: float = 0.9,
        second_stage_iou_threshold: float = 0.3,
        frame_out_d_thre: float = 0.6,
        miou_threshold: float = 0.8,
        untracked_ratio_threshold: float = 0.5,
        new_track_thresh: float = 0.5,
        **kwargs,
    ):
        super().__init__(
            device="cpu",  # a host tracker: ``device`` is taken and ignored
            det_thresh=det_thresh,
            max_age=max_age,
            min_hits=min_hits,
            iou_threshold=iou_threshold,
            per_class=per_class,
        )
        self.tolerance_frames = tolerance_frames
        self.memory_window = memory_window
        self.tau_r = tau_r
        self.tau_p = tau_p
        self.tau_s = tau_s
        self.density_threshold = density_threshold
        self.second_stage_iou_threshold = second_stage_iou_threshold
        self.frame_out_d_thre = frame_out_d_thre
        self.miou_threshold = miou_threshold
        self.untracked_ratio_threshold = untracked_ratio_threshold
        self.new_track_thresh = new_track_thresh
        self._tracks: list[_Track] = []
        self._next_id = 1
        self._frame_count = 0

    def reset(self):
        self._tracks = []
        self._next_id = 1
        self._frame_count = 0

    # -- host-only tracker: override update directly --------------------

    def update(self, dets, img=None, embs=None, masks=None) -> TrackResults:
        dets, img = self._preprocess(dets, img)
        if dets is None or len(dets) == 0:
            dets = np.empty((0, 6), np.float32)
        rows, out_masks = self._update_impl(dets, img, masks=masks)
        return TrackResults(rows, masks=out_masks)

    def _classify(self, conf):
        if conf > self.tau_r:
            return RELIABLE
        if conf > self.tau_p:
            return PENDING
        if conf > self.tau_s:
            return SUSPICIOUS
        return LOST

    def _density(self, i, boxes):
        x1, y1, x2, y2 = boxes[i]
        area = max((x2 - x1) * (y2 - y1), 1e-6)
        ix1 = np.maximum(x1, boxes[:, 0])
        iy1 = np.maximum(y1, boxes[:, 1])
        ix2 = np.minimum(x2, boxes[:, 2])
        iy2 = np.minimum(y2, boxes[:, 3])
        inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
        inter[i] = 0
        return float(inter.sum() / area)

    def _two_stage(self, det_boxes, det_confs, tracks):
        n_dets, n_trks = len(det_boxes), len(tracks)
        if n_dets == 0 or n_trks == 0:
            return [], list(range(n_dets)), list(range(n_trks)), []
        trk_boxes = np.array(
            [t.bbox + t.velocity if t.velocity is not None else t.bbox for t in tracks]
        )
        high = np.where(det_confs >= self.det_thresh)[0]
        low = np.where(det_confs < self.det_thresh)[0]
        matches, mdets, mtrks = [], set(), set()

        if len(high):
            iou = _iou_matrix(det_boxes[high], trk_boxes)
            cost = np.where(iou > 0, 1 - iou, 1.0)
            for r, c in zip(*linear_sum_assignment(cost)):
                if cost[r, c] < 1.0:
                    matches.append((int(high[r]), int(c)))
                    mdets.add(int(high[r]))
                    mtrks.add(int(c))
        left_trks = [j for j in range(n_trks) if j not in mtrks]
        if len(low) and left_trks:
            iou = _iou_matrix(det_boxes[low], trk_boxes[left_trks])
            cost = np.where(iou > 0, 1 - iou, 1.0)
            for r, c in zip(*linear_sum_assignment(cost)):
                if iou[r, c] > 0.3:
                    matches.append((int(low[r]), int(left_trks[c])))
                    mdets.add(int(low[r]))
                    mtrks.add(int(left_trks[c]))

        u_dets = [i for i in range(n_dets) if i not in mdets]
        u_trks = [j for j in range(n_trks) if j not in mtrks]

        second = []
        if u_dets and u_trks:
            valid = [(j, tracks[j]) for j in u_trks if tracks[j].last_matched_bbox is not None]
            if valid:
                iou = _iou_matrix(
                    det_boxes[u_dets], np.array([t.last_matched_bbox for _, t in valid])
                )
                cost = np.where(iou > 0, 1 - iou, 1.0)
                got_d, got_t = set(), set()
                for r, c in zip(*linear_sum_assignment(cost)):
                    if cost[r, c] < 1.0 and (1 - cost[r, c]) > self.second_stage_iou_threshold:
                        second.append((int(u_dets[r]), int(valid[c][0])))
                        got_d.add(u_dets[r])
                        got_t.add(valid[c][0])
                u_dets = [d for d in u_dets if d not in got_d]
                u_trks = [t for t in u_trks if t not in got_t]
        return matches + second, u_dets, u_trks, second

    def _coi(self, tracks):
        """Cross-object interaction (sam2mot.py:133-207): heavily mask-
        overlapping pairs drop the occluded member's mask memory."""
        skip = []
        for i in range(len(tracks)):
            a = tracks[i]
            if a.mask is None or a.state == FRAME_OUT:
                continue
            for j in range(i + 1, len(tracks)):
                b = tracks[j]
                if b.mask is None or b.state == FRAME_OUT:
                    continue
                if a.bbox[2] <= b.bbox[0] or b.bbox[2] <= a.bbox[0]:
                    continue
                if a.bbox[3] <= b.bbox[1] or b.bbox[3] <= a.bbox[1]:
                    continue
                if mask_iou(a.mask, b.mask) <= self.miou_threshold:
                    continue

                def stats(t):
                    vals = list(t.conf_history)[-10:]
                    if len(vals) < 2:
                        return 0.0, 0.0
                    return float(np.mean(vals)), float(np.var(vals))

                mean_a, var_a = stats(a)
                mean_b, var_b = stats(b)
                if abs(mean_a - mean_b) >= abs(var_a - var_b):
                    occluded = a if mean_a < mean_b else b
                else:
                    occluded = a if var_a > var_b else b
                occluded.skip_memory_current = True
                if occluded.id not in skip:
                    skip.append(occluded.id)
        return skip

    def _update_impl(self, dets, img, embs=None, masks=None):
        self._frame_count += 1
        frame_id = self._frame_count
        H, W = (img.shape[:2]) if img is not None else (1080, 1920)

        det_boxes = dets[:, :4] if len(dets) else np.zeros((0, 4))
        det_confs = dets[:, 4] if len(dets) else np.zeros(0)
        det_cls = dets[:, 5].astype(int) if len(dets) else np.zeros(0, int)
        det_masks = masks if (masks is not None and len(masks) == len(dets)) else None
        mH, mW = (det_masks.shape[1:3] if det_masks is not None else (H, W))
        s = min(mH / H, mW / W)
        pad_x = (mW - int(W * s)) / 2.0
        pad_y = (mH - int(H * s)) / 2.0

        def to_mask_coords(bbox):
            return (
                max(0, int(bbox[0] * s + pad_x)),
                max(0, int(bbox[1] * s + pad_y)),
                min(mW, int(bbox[2] * s + pad_x)),
                min(mH, int(bbox[3] * s + pad_y)),
            )

        for t in self._tracks:
            t.prev_bbox = None if t.bbox is None else t.bbox.copy()
            t.age += 1

        active = [t for t in self._tracks if t.state != LOST]
        frame_out, normal = [], []
        for t in active:
            if (
                t.last_matched_frame is not None
                and t.last_matched_frame <= frame_id - 10
                and not t.is_dense
                and t.age > 1
            ):
                t.state = FRAME_OUT
                t.mask = None
                frame_out.append(t)
            else:
                normal.append(t)

        all_matches, u_dets, _, second = self._two_stage(det_boxes, det_confs, normal)
        second_set = set(second)
        matched_ids = set()
        reconstruct = []

        for det_idx, trk_idx in all_matches:
            t = normal[trk_idx]
            bbox = det_boxes[det_idx]
            conf = det_confs[det_idx]
            density = self._density(det_idx, det_boxes)
            t.last_matched_density = density
            t.is_dense = density > self.frame_out_d_thre
            t.last_matched_frame = frame_id
            t.last_matched_bbox = bbox.copy()
            matched_ids.add(t.id)

            if (det_idx, trk_idx) in second_set:
                if density < self.density_threshold:
                    reconstruct.append((t, det_idx))
            else:
                if t.mask is not None and det_masks is not None:
                    x1, y1, x2, y2 = to_mask_coords(bbox)
                    cropped = np.zeros_like(t.mask)
                    cropped[y1:y2, x1:x2] = t.mask[y1:y2, x1:x2]
                    t.mask = cropped
                if t.state == PENDING and conf > self.tau_r and density < self.density_threshold:
                    reconstruct.append((t, det_idx))

            new_vel = bbox - t.bbox
            t.velocity = (
                0.6 * t.velocity + 0.4 * new_vel if t.velocity is not None else new_vel
            )
            t.bbox = bbox.copy()
            t.confidence = conf
            t.conf_history.append(conf)
            t.last_seen_frame = frame_id
            t.lost_frames = 0
            t.cls = det_cls[det_idx]
            t.det_ind = det_idx
            if det_masks is not None:
                t.mask = det_masks[det_idx]
            new_state = self._classify(conf)
            if new_state != LOST:
                t.state = new_state

        if len(active) > 1:
            skip_ids = self._coi(active)
            for t in active:
                if t.id in skip_ids and t.skip_memory_current:
                    t.mask = None
                    t.skip_memory_current = False

        for t, det_idx in reconstruct:
            if det_masks is not None:
                t.mask = det_masks[det_idx]
            t.state = RELIABLE
            t.bbox = det_boxes[det_idx].copy()
            t.confidence = det_confs[det_idx]
            t.conf_history.append(det_confs[det_idx])
            t.det_ind = det_idx

        for t in self._tracks:
            if t.id not in matched_ids:
                t.lost_frames += 1
                if t.lost_frames > self.tolerance_frames:
                    t.state = LOST

        # stage 3: frame-out recovery
        if frame_out and u_dets:
            fo_boxes = np.array(
                [
                    t.last_matched_bbox if t.last_matched_bbox is not None else np.zeros(4)
                    for t in frame_out
                ]
            )
            has = np.array([t.last_matched_bbox is not None for t in frame_out])
            iou = _iou_matrix(det_boxes[u_dets], fo_boxes)
            iou[:, ~has] = 0
            cost = np.where(iou > 0, 1 - iou, 1.0)
            taken = []
            for r, c in zip(*linear_sum_assignment(cost)):
                if cost[r, c] < 1.0:
                    det_idx = u_dets[r]
                    t = frame_out[c]
                    bbox = det_boxes[det_idx]
                    density = self._density(det_idx, det_boxes)
                    t.state = RELIABLE
                    t.bbox = bbox.copy()
                    t.confidence = det_confs[det_idx]
                    t.conf_history.append(det_confs[det_idx])
                    t.last_seen_frame = frame_id
                    t.lost_frames = 0
                    t.last_matched_frame = frame_id
                    t.last_matched_bbox = bbox.copy()
                    t.last_matched_density = density
                    t.is_dense = density > self.frame_out_d_thre
                    t.cls = det_cls[det_idx]
                    t.det_ind = det_idx
                    if det_masks is not None:
                        t.mask = det_masks[det_idx]
                    matched_ids.add(t.id)
                    taken.append(det_idx)
            u_dets = [d for d in u_dets if d not in taken]

        # new tracks gated by the untracked region
        if u_dets:
            untracked = np.ones((mH, mW), np.uint8)
            for t in self._tracks:
                if t.mask is not None and t.state != LOST and t.mask.shape == (mH, mW):
                    untracked[t.mask > 0] = 0
            for t in active:
                gb = None
                if t.mask is None or not np.any(t.mask):
                    gb = t.last_matched_bbox if t.last_matched_bbox is not None else t.bbox
                elif t.is_dense and t.last_matched_bbox is not None:
                    gb = t.last_matched_bbox
                if gb is not None:
                    x1, y1, x2, y2 = to_mask_coords(gb)
                    if x2 > x1 and y2 > y1:
                        untracked[y1:y2, x1:x2] = 0

            for det_idx in u_dets:
                bbox = det_boxes[det_idx]
                conf = det_confs[det_idx]
                if conf < self.new_track_thresh:
                    continue
                x1, y1, x2, y2 = to_mask_coords(bbox)
                area = (x2 - x1) * (y2 - y1)
                if area <= 0 or untracked[y1:y2, x1:x2].sum() / area <= self.untracked_ratio_threshold:
                    continue
                density = self._density(det_idx, det_boxes)
                t = _Track(
                    id=self._next_id,
                    bbox=bbox.copy(),
                    mask=det_masks[det_idx] if det_masks is not None else None,
                    confidence=conf,
                    state=RELIABLE,
                    lost_frames=0,
                    age=1,
                    conf_history=deque(maxlen=self.memory_window),
                    last_seen_frame=frame_id,
                    init_frame=frame_id,
                    last_matched_frame=frame_id,
                    last_matched_bbox=bbox.copy(),
                    last_matched_density=density,
                    is_dense=density > self.frame_out_d_thre,
                    cls=det_cls[det_idx],
                    det_ind=det_idx,
                )
                t.conf_history.append(conf)
                self._tracks.append(t)
                matched_ids.add(t.id)
                self._next_id += 1

        self._tracks = [t for t in self._tracks if t.lost_frames <= self.tolerance_frames]

        rows, out_masks = [], []
        for t in self._tracks:
            if t.id not in matched_ids:
                continue
            if t.age < self.min_hits and self._frame_count > self.min_hits:
                continue
            rows.append([*t.bbox, t.id, t.confidence, t.cls, t.det_ind])
            out_masks.append(t.mask)
        if not rows:
            return np.empty((0, 8)), None
        rows = np.array(rows, float)
        if any(m is not None and m.shape == (mH, mW) and np.any(m) for m in out_masks):
            stacked = np.zeros((len(out_masks), mH, mW), np.uint8)
            for i, m in enumerate(out_masks):
                if m is not None and m.shape == (mH, mW):
                    stacked[i] = m
            return rows, stacked
        return rows, None
