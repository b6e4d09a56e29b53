"""Host-side shell of the live tracker API (counterpart of
boxmot_tpu/trackers/base.py, without its visualization mixin).

It keeps what cannot run in the batched step: input unwrapping,
detection-layout inference, first-frame setup, padding to a static
detection bucket, per-class states renumbered by the shared
``GlobalIdAllocator``, and ``TrackResults`` wrapping.  ``update(dets, img)``
keeps the JAX tracker's contract: (N, 6) axis-aligned detections give
(M, 8) rows [x1, y1, x2, y2, id, conf, cls, det_ind]; (N, 7) oriented
detections [cx, cy, w, h, theta, conf, cls] switch a tracker that supports
them to OBB mode on the first frame and give (M, 9) rows
[cx, cy, w, h, theta, id, conf, cls, det_ind].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from boxmot_tpu_torch.trackers.per_class_ids import GlobalIdAllocator
from boxmot_tpu_torch.trackers.track_results import TrackResults
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


class BaseTracker:
    """Shared host shell; subclasses provide ``_init_state`` and ``_step``,
    and set ``supports_obb`` when their step has an OBB branch."""

    supports_obb = False

    def __init__(self, device, per_class: bool = False, nr_classes: int = 80,
                 is_obb: bool = False, **kwargs):
        # the JAX shell's association/age options are accepted and unused
        # by the motion-only trackers, as there
        self.device = resolve_device(device)
        self.per_class = per_class
        self.nr_classes = nr_classes
        self.is_obb = is_obb
        self.layout = OBB_LAYOUT if is_obb else AABB_LAYOUT
        self._first_dets_processed = False
        self.frame_count = 0
        self.h = None
        self.w = None
        self._state = None
        self._per_class_states = {} if per_class else None
        self._pc_ids = GlobalIdAllocator() if per_class else None

    def _init_state(self):
        raise NotImplementedError

    def _step(self, state, dets_padded, det_valid):
        """Advance one frame: (state, out (K, output_cols), out_mask (K,))."""
        raise NotImplementedError

    def update(self, dets, img=None, embs=None) -> TrackResults:
        """Track one frame of (N, 6) or (N, 7) detections; ``embs`` is
        ignored by motion-only trackers."""
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
        return TrackResults(self._do_update(dets))

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

    def _do_update(self, dets):
        if dets is None or len(dets) == 0:
            dets = np.empty((0, self.layout.det_cols), np.float32)
        self._validate(dets)
        if not self.per_class:
            return self._run_class(None, dets)

        outputs = []
        frame_count = self.frame_count
        for cls_id in range(self.nr_classes):
            self.frame_count = frame_count
            out = self._run_class(cls_id, dets[dets[:, self.layout.cls_idx] == cls_id])
            if out.size > 0:
                outputs.append(out)
        self.frame_count = frame_count + 1
        if outputs:
            return np.vstack(outputs)
        return np.empty((0, self.layout.output_cols), np.float32)

    def _run_class(self, cls_id, dets):
        if cls_id is None:
            state = self._state if self._state is not None else self._init_state()
        else:
            state = self._per_class_states.get(cls_id)
            if state is None:
                # each class bank counts its ids in a disjoint raw range; the
                # GlobalIdAllocator renumbers them at emission
                state = self._init_state()
                state = dataclasses.replace(state, next_id=state.next_id + cls_id * 1_000_000)
            prev_next = int(state.next_id[0])

        padded = torch.from_numpy(self._pad_dets(dets)).to(self.device)
        state, out, out_mask = self._step(state, padded, padded[:, self.layout.conf_idx] >= 0.0)

        if cls_id is None:
            self._state = state
        else:
            self._per_class_states[cls_id] = state
        self.frame_count += 1

        out_np = out.cpu().numpy()[out_mask.cpu().numpy()]
        if cls_id is not None:
            self._pc_ids.observe_created(prev_next, int(state.next_id[0]))
            if out_np.size:
                out_np = out_np.copy()
                id_col = self.layout.box_cols
                out_np[:, id_col] = self._pc_ids.remap(out_np[:, id_col])
        return out_np
