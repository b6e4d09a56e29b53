"""Oriented-box benchmark evaluation, MMOT layout (counterpart of
boxmot_tpu/engine/eval_obb.py).

OBB detections (the ground truth as detections) are replayed on the device
through an oriented tracker, or, for a ``name:cpp`` tracker, frame by frame
on the repo's native OBB core of that tracker, on the host
(``track_sequence_obb_native``; bytetrack, ocsort and sfsort have one, and
the others raise the JAX function's ``AssertionError`` at their first
frame).  The corner-format rows and the class-averaged HOTA/CLEAR/Identity
with rotated-IoU matching come from the port's own copies of the JAX
package's host modules (``data.mmot``, ``engine.metrics.mot_metrics``).
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np

from boxmot_tpu_torch.data.mmot import MmotDataset
from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.metrics.mot_metrics import evaluate_obb_results, obb_to_corners
from boxmot_tpu_torch.engine.replay import replay_sequences_outputs
from boxmot_tpu_torch.engine.results import ValidationResult
from boxmot_tpu_torch.trackers.zoo import check_ported, create_tracker, parse_tracker_spec
from boxmot_tpu_torch.utils.device import resolve_device


def _frame_corner_rows(f: int, out: np.ndarray) -> np.ndarray:
    """A frame's tracks (M, >= 8) [cx, cy, w, h, theta, id, conf, cls, ...]
    -> corner-format rows (M, 13) [frame, id, x1..y4, conf, cls, vis = 1]."""
    return np.column_stack([
        np.full(len(out), f + 1, np.float32), out[:, 5], obb_to_corners(out[:, :5]),
        out[:, 6], out[:, 7], np.ones(len(out), np.float32),
    ])


def _stack(rows: list) -> np.ndarray:
    return np.concatenate(rows) if rows else np.zeros((0, 13), np.float32)


def corner_rows(outs: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Replay outputs (F, K, 9) [cx, cy, w, h, theta, id, conf, cls, det_ind]
    of one sequence -> corner-format rows (M, 13) [frame, id, x1..y4, conf,
    cls, vis = 1]."""
    return _stack([_frame_corner_rows(f, outs[f][masks[f]]) for f in range(len(outs))
                   if masks[f].any()])


def mmot_obb_dets(data_root: Path) -> dict:
    """{sequence: per-frame (Ni, 7) [cx, cy, w, h, theta, conf, cls]} of an
    MMOT split, from its ground truth (the detections run_eval_obb replays)."""
    return {seq.name: seq.gt_as_obb_dets() for seq in MmotDataset(data_root)}


def track_sequence_obb(cfg, dets_per_frame, *, device) -> np.ndarray:
    """Replay per-frame (Ni, 7) OBB detections; corner-format rows (M, 13)."""
    return corner_rows(*replay_sequences_outputs(cfg, [{"dets": dets_per_frame}],
                                                 device=device)[0])


def track_sequence_obb_native(tracker_type: str, dets_per_frame,
                              tracker_params: dict | None = None) -> np.ndarray:
    """``track_sequence_obb`` on the native OBB core of ``tracker_type``
    (``backend="cpp"``), frame by frame on the host; corner-format rows (M,
    13)."""
    trk = create_tracker(tracker_type, backend="cpp", evolve_param_dict=tracker_params or None)
    rows = []
    for f, dets in enumerate(dets_per_frame):
        out = np.asarray(trk.update(np.asarray(dets, np.float32).reshape(-1, 7)))
        if len(out):
            rows.append(_frame_corner_rows(f, out))
    return _stack(rows)


def run_eval_obb(
    data_root: Path,
    tracker_type: str = "bytetrack",
    *,
    device="cuda",
    tracker_params: dict | None = None,
    output_dir: Path | None = None,
    per_class: bool = True,
    verbose: bool = False,
) -> ValidationResult:
    """Evaluate an oriented tracker over an MMOT split on ``device``.

    Every sequence replays in one batch per (frame, detection) bucket; a
    ``name:cpp`` tracker replays each sequence on its native OBB core on the
    host instead (``device`` unused).  Returns class-averaged metrics
    ({"combined", "per_class", "per_seq"}) when ``per_class``, else the
    metrics over all classes.
    """
    device = resolve_device(device)
    dataset = MmotDataset(data_root)
    if len(dataset) == 0:
        raise ValueError(f"no MMOT sequences under {data_root}")
    tracker_type, backend = parse_tracker_spec(tracker_type)
    check_ported(tracker_type)
    params = dict(tracker_params or {})
    seqs = list(dataset)
    if backend == "cpp":
        all_rows = [track_sequence_obb_native(tracker_type, s.gt_as_obb_dets(), params)
                    for s in seqs]
    else:
        cfg = build_replay_config(tracker_type, **{**params, "is_obb": True})
        outputs = replay_sequences_outputs(cfg, [{"dets": s.gt_as_obb_dets()} for s in seqs],
                                           device=device)
        all_rows = [corner_rows(outs, masks) for outs, masks in outputs]

    with tempfile.TemporaryDirectory() as tmp:
        res_root = Path(output_dir) if output_dir else Path(tmp)
        res_root.mkdir(parents=True, exist_ok=True)
        seq_lengths = {}
        all_classes: set[int] = set()
        for seq, rows in zip(seqs, all_rows):
            np.savetxt(res_root / f"{seq.name}.txt", rows, delimiter=",", fmt="%.10g")
            seq_lengths[seq.name] = seq.seq_length
            all_classes.update(seq.classes())
            if verbose:
                print(f"tracked {seq.name}: {len(rows)} rows")

        gt_root = Path(data_root) / "mot"
        if per_class and all_classes:
            per_cls = {c: evaluate_obb_results(gt_root, res_root, seq_lengths=seq_lengths,
                                               cls_id=c)["combined"]
                       for c in sorted(all_classes)}
            combined = {k: float(np.mean([c[k] for c in per_cls.values()]))
                        for k in ("HOTA", "MOTA", "IDF1")}
            return ValidationResult({"per_class": per_cls, "combined": combined, "per_seq": {}})
        return ValidationResult(evaluate_obb_results(gt_root, res_root, seq_lengths=seq_lengths))
