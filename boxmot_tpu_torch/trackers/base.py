"""Host-side shell of the live tracker API (counterpart of
boxmot_tpu/trackers/base.py, with its visualization mixin).

It keeps what cannot run in the batched step: input unwrapping,
detection-layout inference, first-frame setup (the detection layout, and
the frame size for centroid association), padding to a static
detection bucket, per-class states renumbered by the shared
``GlobalIdAllocator``, and ``TrackResults`` wrapping.
``update(dets, img, embs, masks)`` keeps the JAX tracker's contract: (N, 6) axis-aligned detections give
(M, 8) rows [x1, y1, x2, y2, id, conf, cls, det_ind]; (N, 7) oriented
detections [cx, cy, w, h, theta, conf, cls] switch a tracker that supports
them to OBB mode on the first frame and give (M, 9) rows
[cx, cy, w, h, theta, id, conf, cls, det_ind].  ``embs`` (N, F) are the
detections' appearance embeddings; an appearance tracker reads the frame's
image and its embeddings from ``_frame_inputs``.  With ``per_class`` every
class bank gets the whole frame's ``embs`` and reads its first n rows for
its n detections, as the JAX appearance trackers do (their ``update`` keeps
the frame's embeddings, which their ``_step`` reads in every class bank).
``masks`` are accepted and ignored, as by every JAX tracker but sam2mot,
which overrides ``update`` and takes only ``_preprocess`` from here.

``plot_results`` (``trackers/visualization.py``, a copy of the JAX mixin)
draws the tracks of the latest ``update`` from a host history of its output
rows, and with ``show_kf_preds`` the predicted boxes of the lost slots
(``_lost_mask``): their rows of the step's (K, cols) output come back in
the same device-to-host copy as the emitted rows, so drawing adds no sync.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from boxmot_tpu_torch.trackers.per_class_ids import GlobalIdAllocator
from boxmot_tpu_torch.trackers.track_results import TrackResults
from boxmot_tpu_torch.trackers.visualization import VisualizationMixin
from boxmot_tpu_torch.utils.device import resolve_device

# the JAX shell's buckets; the auction kernel holds up to 512 detection
# columns (ops.lap.MAX_COLS)
_DET_BUCKETS = (16, 32, 64, 128, 256, 512)


def det_bucket(n: int) -> int:
    """Static padding size for n detections."""
    for b in _DET_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"too many detections for one frame: {n} (at most {_DET_BUCKETS[-1]})")


class DetectionLayout:
    """Column schema of AABB vs OBB detections (mirror of the JAX class)."""

    def __init__(self, is_obb: bool):
        self.is_obb = is_obb
        self.det_cols = 7 if is_obb else 6
        self.box_cols = 5 if is_obb else 4
        self.conf_idx = self.box_cols
        self.cls_idx = self.box_cols + 1
        self.output_cols = 9 if is_obb else 8


AABB_LAYOUT = DetectionLayout(False)
OBB_LAYOUT = DetectionLayout(True)


def infer_detection_layout(dets):
    """The layout of a (N, 6) or (N, 7) array; None for anything else."""
    if dets is None or not isinstance(dets, np.ndarray) or dets.ndim != 2:
        return None
    if dets.shape[1] == 6:
        return AABB_LAYOUT
    if dets.shape[1] == 7:
        return OBB_LAYOUT
    return None


class BaseTracker(VisualizationMixin):
    """Shared host shell; subclasses provide ``_init_state`` and ``_step``,
    and set ``supports_obb`` when their step has an OBB branch and
    ``_id_emit_offset`` when they emit ids that differ from their internal
    ``next_id`` counter (HybridSORT emits tid + 1)."""

    supports_obb = False
    _id_emit_offset = 0

    def __init__(self, device, det_thresh: float = 0.3, max_age: int = 30, max_obs: int = 50,
                 min_hits: int = 3, iou_threshold: float = 0.3, per_class: bool = False,
                 nr_classes: int = 80, asso_func: str = "iou", is_obb: bool = False, **kwargs):
        # the JAX shell's association and age options, with its defaults; a
        # tracker that does not use them ignores them, as there
        self.device = resolve_device(device)
        self.det_thresh = det_thresh
        self.max_age = max_age
        self.max_obs = max_obs if max_obs > max_age else max_age + 5  # the display history
        self.min_hits = min_hits
        self.iou_threshold = iou_threshold
        self.asso_func_name = asso_func
        self.per_class = per_class
        self.nr_classes = nr_classes
        self.is_obb = is_obb
        self.layout = OBB_LAYOUT if is_obb else AABB_LAYOUT
        self._first_dets_processed = False
        self.frame_count = 0
        self.h = None
        self.w = None
        self._state = None
        self._img = None
        self._frame_inputs = (None, None, None)  # (img, embs, dets) of the step being run
        self._per_class_states = {} if per_class else None
        self._pc_ids = GlobalIdAllocator() if per_class else None
        # lost-track KF predictions from the latest update (show_kf_preds)
        self._lost_display_rows: list = []

    def _init_state(self):
        raise NotImplementedError

    def _step(self, state, dets_padded, det_valid):
        """Advance one frame: (state, out (K, output_cols), out_mask (K,))."""
        raise NotImplementedError

    def update(self, dets, img=None, embs=None, masks=None) -> TrackResults:
        """Track one frame of (N, 6) or (N, 7) detections; ``embs`` is
        ignored by motion-only trackers and ``masks`` by all."""
        dets, img = self._preprocess(dets, img)
        self._img = img
        self._lost_display_rows = []  # refilled by _run_class each frame
        results = TrackResults(self._do_update(dets, embs))
        self._record_display(results, max_obs=self.max_obs)
        return results

    def _lost_mask(self, state):
        """(K,) device mask of alive-but-unmatched slots, whose output rows
        carry the KF-predicted box of the frame (the JAX shell's rule:
        ``active & (tsu > 0)``); trackers with a status column override it,
        and None means no such slots are drawn."""
        if hasattr(state, "active") and hasattr(state, "tsu"):
            return state.active[0] & (state.tsu[0] > 0)
        return None

    def _preprocess(self, dets, img):
        """Unwrap the detections to float32 numpy and, on the first frame,
        set the detection layout (refusing OBB where unsupported) and the
        frame size."""
        if hasattr(dets, "data"):
            dets = dets.data
        dets = np.asarray(dets, dtype=np.float32) if dets is not None else None
        if not self._first_dets_processed and dets is not None:
            layout = infer_detection_layout(dets)
            if layout is not None:
                if layout.is_obb and not self.supports_obb:
                    raise AssertionError(f"{type(self).__name__} does not support OBB detections.")
                self._set_detection_mode(layout.is_obb)
                self._first_dets_processed = True
        if self.h is None and img is not None:
            self.h, self.w = img.shape[0:2]
            self._set_frame_size(float(self.w), float(self.h))
        return dets, img

    def _set_frame_size(self, w: float, h: float):
        """First-frame hook for trackers whose association needs the frame
        size (the centroid family)."""

    def _set_detection_mode(self, is_obb: bool):
        if is_obb != self.is_obb:
            self.is_obb = is_obb
            self.layout = OBB_LAYOUT if is_obb else AABB_LAYOUT
            self._state = None  # the state's shape depends on the mode

    def reset(self):
        self._state = None
        if self.per_class:
            self._per_class_states = {}
            self._pc_ids = GlobalIdAllocator()
        self.frame_count = 0

    def _validate(self, dets):
        # AssertionError, as the JAX shell and the reference raise
        if dets.ndim != 2:
            raise AssertionError("Unsupported 'dets' dimensions, valid number of dimensions is two")
        if dets.shape[1] != self.layout.det_cols:
            raise AssertionError(
                f"Unsupported 'dets' 2nd dimension length, valid length is {self.layout.det_cols}"
            )

    def _pad_dets(self, dets):
        """Append det indices and pad to a static bucket: padding rows carry
        conf = -1 and unit boxes (x2, y2 or w, h = 1), so no geometry
        produces NaN."""
        n = len(dets)
        cols = self.layout.det_cols
        padded = np.zeros((det_bucket(max(n, 1)), cols + 1), np.float32)
        padded[:, 2:4] = 1.0
        padded[:, self.layout.conf_idx] = -1.0
        if n:
            padded[:n, :cols] = dets
            padded[:n, -1] = np.arange(n, dtype=np.float32)
        return padded

    def _do_update(self, dets, embs=None):
        if dets is None or len(dets) == 0:
            dets = np.empty((0, self.layout.det_cols), np.float32)
        self._validate(dets)
        if not self.per_class:
            return self._run_class(None, dets, embs)

        outputs = []
        frame_count = self.frame_count
        for cls_id in range(self.nr_classes):
            self.frame_count = frame_count
            cls_mask = dets[:, self.layout.cls_idx] == cls_id
            out = self._run_class(cls_id, dets[cls_mask], embs)
            if out.size > 0:
                outputs.append(out)
        self.frame_count = frame_count + 1
        if outputs:
            return np.vstack(outputs)
        return np.empty((0, self.layout.output_cols), np.float32)

    def _run_class(self, cls_id, dets, embs=None):
        if cls_id is None:
            state = self._state if self._state is not None else self._init_state()
        else:
            state = self._per_class_states.get(cls_id)
            if state is None:
                # each class bank counts its ids in a disjoint raw range; the
                # GlobalIdAllocator renumbers them at emission
                state = self._init_state()
                state = dataclasses.replace(state, next_id=state.next_id + cls_id * 1_000_000)
            prev_next = int(state.next_id[0]) + self._id_emit_offset

        self._frame_inputs = (self._img, embs, dets)
        padded = torch.from_numpy(self._pad_dets(dets)).to(self.device)
        state, out, out_mask = self._step(state, padded, padded[:, self.layout.conf_idx] >= 0.0)

        if cls_id is None:
            self._state = state
        else:
            self._per_class_states[cls_id] = state
        self.frame_count += 1

        # one device-to-host copy: the (K, cols) rows, the emitted mask and
        # the lost mask (show_kf_preds) as two more columns
        lost = self._lost_mask(state)
        flags = [out_mask] if lost is None else [out_mask, lost & ~out_mask]
        host = torch.cat([out, torch.stack(flags, 1).to(out.dtype)], 1).cpu().numpy()
        cols = out.shape[1]
        all_np = host[:, :cols]
        out_np = all_np[host[:, cols] > 0]
        id_col = self.layout.box_cols
        if cls_id is not None:
            self._pc_ids.observe_created(prev_next, int(state.next_id[0]) + self._id_emit_offset)
            if out_np.size:
                out_np[:, id_col] = self._pc_ids.remap(out_np[:, id_col])
        if lost is not None:
            lost_np = all_np[host[:, cols + 1] > 0]
            if len(lost_np):
                if cls_id is not None:
                    lost_np[:, id_col] = self._pc_ids.remap(lost_np[:, id_col])
                self._lost_display_rows.append(lost_np)
        return out_np
