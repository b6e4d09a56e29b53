"""Oriented-box benchmark evaluation, MMOT layout (counterpart of the device
branch of boxmot_tpu/engine/eval_obb.py).

OBB detections (the ground truth as detections) are replayed on the device
through an oriented tracker; the corner-format rows and the class-averaged
HOTA/CLEAR/Identity with rotated-IoU matching come from the port's own
copies of the JAX package's host modules (``data.mmot``,
``engine.metrics.mot_metrics``).  The native ``:cpp`` backend of the JAX
function is not ported.
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
from boxmot_tpu_torch.utils.device import resolve_device


def corner_rows(outs: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Replay outputs (F, K, 9) [cx, cy, w, h, theta, id, conf, cls, det_ind]
    of one sequence -> corner-format rows (M, 13) [frame, id, x1..y4, conf,
    cls, vis = 1]."""
    rows = []
    for f in range(len(outs)):
        out = outs[f][masks[f]]
        if not len(out):
            continue
        rows.append(np.column_stack([
            np.full(len(out), f + 1, np.float32), out[:, 5], obb_to_corners(out[:, :5]),
            out[:, 6], out[:, 7], np.ones(len(out), np.float32),
        ]))
    return np.concatenate(rows) if rows else np.zeros((0, 13), np.float32)


def mmot_obb_dets(data_root: Path) -> dict:
    """{sequence: per-frame (Ni, 7) [cx, cy, w, h, theta, conf, cls]} of an
    MMOT split, from its ground truth (the detections run_eval_obb replays)."""
    return {seq.name: seq.gt_as_obb_dets() for seq in MmotDataset(data_root)}


def track_sequence_obb(cfg, dets_per_frame, *, device) -> np.ndarray:
    """Replay per-frame (Ni, 7) OBB detections; corner-format rows (M, 13)."""
    return corner_rows(*replay_sequences_outputs(cfg, [{"dets": dets_per_frame}],
                                                 device=device)[0])


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

    Every sequence replays in one batch per (frame, detection) bucket.
    Returns class-averaged metrics ({"combined", "per_class", "per_seq"})
    when ``per_class``, else the metrics over all classes.
    """
    device = resolve_device(device)
    dataset = MmotDataset(data_root)
    if len(dataset) == 0:
        raise ValueError(f"no MMOT sequences under {data_root}")
    cfg = build_replay_config(tracker_type, **{**(tracker_params or {}), "is_obb": True})
    seqs = list(dataset)
    outputs = replay_sequences_outputs(cfg, [{"dets": s.gt_as_obb_dets()} for s in seqs],
                                       device=device)

    with tempfile.TemporaryDirectory() as tmp:
        res_root = Path(output_dir) if output_dir else Path(tmp)
        res_root.mkdir(parents=True, exist_ok=True)
        seq_lengths = {}
        all_classes: set[int] = set()
        for seq, (outs, masks) in zip(seqs, outputs):
            rows = corner_rows(outs, masks)
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
