"""A copy of ``boxmot_tpu/motion/calibration.py``.

KF noise calibration from ground-truth tracks and cached detections.

Native rebuild of the reference calibration
(boxmot/motion/kalman_filters/calibration.py:94-724): estimate per-
parameterization Kalman Q (process) and R (measurement) noise from a
MOT-format training set.

  * Q: GT tracks become measurement sequences z_t; a constant-velocity
    one-step prediction z_t-1 + (z_t-1 - z_t-2) gives position residual
    variances, and second differences give velocity (acceleration)
    variances (calibration.py:379-398).
  * R: cached detections Hungarian-matched to GT at IoU >= thresh; the
    covariance of measurement residuals det_z - gt_z is R
    (calibration.py:257-377).  Without detections, R falls back to the
    Q position diagonal (GT proxy).
  * std weights: sqrt(mean R variance) / mean box height gives the
    _std_weight_position scale the XYAH/XYWH layouts consume; same for
    velocity (calibration.py:512-516).

Estimation is plain numpy (one pass over small GT tables); the outputs
plug into make_*_layout(std_weight_position=..., std_weight_velocity=...)
or custom q/r diagonals.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import numpy as np

KF_TYPES = ("xywh", "xyah", "xysr", "xyhr")

# tracker -> KF parameterization (calibration.py:14-36)
TRACKER_KF_TYPE = {
    "botsort": "xywh",
    "bytetrack": "xyah",
    "strongsort": "xyah",
    "ocsort": "xysr",
    "deepocsort": "xysr",
    "hybridsort": "xysr",
    "boosttrack": "xyhr",
    "occluboost": "xyhr",
}


def tracker_kf_type(tracker_name: str) -> str | None:
    return TRACKER_KF_TYPE.get(tracker_name.lower())


def _cxywh_to_measurement(cxywh: np.ndarray, kf_type: str) -> np.ndarray:
    cx, cy, w, h = cxywh[..., 0], cxywh[..., 1], cxywh[..., 2], cxywh[..., 3]
    if kf_type == "xywh":
        return np.stack([cx, cy, w, h], axis=-1)
    if kf_type == "xyah":
        return np.stack([cx, cy, w / np.maximum(h, 1e-6), h], axis=-1)
    if kf_type == "xysr":
        return np.stack([cx, cy, w * h, w / np.maximum(h, 1e-6)], axis=-1)
    if kf_type == "xyhr":
        return np.stack([cx, cy, h, w / np.maximum(h, 1e-6)], axis=-1)
    raise ValueError(f"Unknown kf_type: {kf_type}")


def _measurement_labels(kf_type: str) -> list[str]:
    return {
        "xywh": ["cx", "cy", "w", "h"],
        "xyah": ["cx", "cy", "a", "h"],
        "xysr": ["cx", "cy", "s", "r"],
        "xyhr": ["cx", "cy", "h", "r"],
    }[kf_type]


def _dims(kf_type: str) -> tuple[int, int]:
    if kf_type == "xysr":
        return 7, 4
    if kf_type in KF_TYPES:
        return 8, 4
    raise ValueError(f"Unknown kf_type: {kf_type}")


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def _load_gt(seq_dir: Path) -> np.ndarray:
    gt_file = seq_dir / "gt" / "gt.txt"
    if not gt_file.exists():
        raise FileNotFoundError(f"no gt/gt.txt under {seq_dir}")
    return np.loadtxt(gt_file, delimiter=",", ndmin=2)


def build_tracks_from_sequence(
    seq_dir: Path, kf_type: str = "xywh", min_detections: int = 5
) -> tuple[list[tuple[np.ndarray, int]], np.ndarray, np.ndarray]:
    """GT rows -> per-id measurement sequences (calibration.py:186-232).

    Returns (tracks [(z_seq (T, 4), cls_id)], widths, heights).
    """
    gt = _load_gt(seq_dir)
    ws, hs = gt[:, 4], gt[:, 5]
    tracks = []
    for tid in np.unique(gt[:, 1].astype(int)):
        rows = gt[gt[:, 1].astype(int) == tid]
        rows = rows[np.argsort(rows[:, 0])]
        if len(rows) < min_detections:
            continue
        cxywh = np.stack(
            [
                rows[:, 2] + rows[:, 4] / 2,
                rows[:, 3] + rows[:, 5] / 2,
                rows[:, 4],
                rows[:, 5],
            ],
            axis=-1,
        )
        z = _cxywh_to_measurement(cxywh, kf_type)
        cls_id = int(rows[0, 7]) if rows.shape[1] > 7 else 0
        tracks.append((z, cls_id))
    return tracks, ws, hs


def _estimate_process_noise(tracks) -> tuple[np.ndarray, np.ndarray]:
    """Constant-velocity prediction residual + acceleration variances
    (calibration.py:379-398)."""
    pos_residuals, accel = [], []
    for z_seq, _cls in tracks:
        if len(z_seq) < 3:
            continue
        velocity = np.diff(z_seq, axis=0)
        z_pred = z_seq[1:-1] + velocity[:-1]
        pos_residuals.append(z_seq[2:] - z_pred)
        accel.append(np.diff(z_seq, n=2, axis=0))
    if not pos_residuals:
        raise RuntimeError("No valid tracks with >= 3 detections found.")
    return (
        np.var(np.vstack(pos_residuals), axis=0),
        np.var(np.vstack(accel), axis=0),
    )


def estimate_R_from_detections(
    gt_root: Path,
    dets_root: Path,
    kf_type: str = "xywh",
    iou_threshold: float = 0.5,
) -> np.ndarray:
    """Hungarian-match cached det rows (frame, x1, y1, x2, y2, conf, cls)
    to GT and return cov(det_z - gt_z) (calibration.py:257-377)."""
    from scipy.optimize import linear_sum_assignment

    residuals = []
    det_files = sorted(Path(dets_root).glob("*.npy"))
    if not det_files:
        raise FileNotFoundError(f"No .npy detection files found in {dets_root}")
    for det_file in det_files:
        seq_dir = Path(gt_root) / det_file.stem
        if not seq_dir.is_dir():
            continue
        dets = np.load(det_file)
        try:
            gt = _load_gt(seq_dir)
        except FileNotFoundError:
            continue
        for frame_id in np.unique(gt[:, 0].astype(int)):
            gt_f = gt[gt[:, 0].astype(int) == frame_id]
            gt_xyxy = np.stack(
                [gt_f[:, 2], gt_f[:, 3], gt_f[:, 2] + gt_f[:, 4], gt_f[:, 3] + gt_f[:, 5]],
                axis=-1,
            )
            det_f = dets[dets[:, 0].astype(int) == frame_id]
            if len(det_f) == 0:
                continue
            det_xyxy = det_f[:, 1:5]
            iou = _iou_matrix(det_xyxy, gt_xyxy)
            ri, ci = linear_sum_assignment(1 - iou)
            for d, g in zip(ri, ci):
                if iou[d, g] < iou_threshold:
                    continue
                to_c = lambda b: np.stack(
                    [
                        (b[0] + b[2]) / 2,
                        (b[1] + b[3]) / 2,
                        b[2] - b[0],
                        b[3] - b[1],
                    ]
                )
                det_z = _cxywh_to_measurement(to_c(det_xyxy[d]), kf_type)
                gt_z = _cxywh_to_measurement(to_c(gt_xyxy[g]), kf_type)
                residuals.append(det_z - gt_z)
    if not residuals:
        raise RuntimeError("No det-GT matches found. Check IoU threshold and paths.")
    return np.cov(np.array(residuals), rowvar=False)


def estimate_kf_noise(
    train_root: Path,
    kf_type: str = "xywh",
    dets_root: Path | None = None,
    min_detections: int = 5,
    iou_threshold: float = 0.5,
    per_class: bool = False,
    verbose: bool = False,
) -> dict:
    """Estimate Q/R and std weights from a MOT tree (dirs with gt/gt.txt)."""
    train_root = Path(train_root)
    dim_x, dim_z = _dims(kf_type)
    log = print if verbose else (lambda *a, **k: None)

    all_tracks, all_ws, all_hs = [], [], []
    for seq_dir in sorted(train_root.iterdir()):
        if not seq_dir.is_dir():
            continue
        try:
            tracks, ws, hs = build_tracks_from_sequence(
                seq_dir, kf_type=kf_type, min_detections=min_detections
            )
        except FileNotFoundError:
            continue
        all_tracks.extend(tracks)
        all_ws.append(ws)
        all_hs.append(hs)
    if not all_tracks:
        raise RuntimeError("No valid tracks found in any sequence.")

    mean_w = float(np.concatenate(all_ws).mean())
    mean_h = float(np.concatenate(all_hs).mean())
    q_pos, q_vel = _estimate_process_noise(all_tracks)

    Q = np.zeros((dim_x, dim_x))
    for i in range(min(len(q_pos), dim_z)):
        Q[i, i] = q_pos[i]
    for i in range(min(len(q_vel), dim_x - dim_z)):
        Q[dim_z + i, dim_z + i] = q_vel[i]

    if dets_root is not None:
        R = estimate_R_from_detections(
            train_root, dets_root, kf_type=kf_type, iou_threshold=iou_threshold
        )
        source = "det-vs-GT"
    else:
        R = np.diag(q_pos[:dim_z])
        source = "GT-only"

    std_wpos = float(np.sqrt(np.abs(np.diag(R)).mean()) / mean_h)
    std_wvel = float(np.sqrt(np.abs(q_vel).mean()) / mean_h)
    log(f"kf_type={kf_type} labels={_measurement_labels(kf_type)}")
    log(f"Q pos diag: {q_pos}\nQ vel diag: {q_vel}\nR diag: {np.diag(R)}")
    log(f"std_weight_position={std_wpos:.6f} std_weight_velocity={std_wvel:.6f}")

    result = {
        "kf_type": kf_type,
        "std_weight_position": std_wpos,
        "std_weight_velocity": std_wvel,
        "Q": Q,
        "R": R,
        "Q_vel_diag": q_vel,
        "source": source,
        "mean_w": mean_w,
        "mean_h": mean_h,
    }

    if per_class:
        by_cls = defaultdict(list)
        for t in all_tracks:
            by_cls[t[1]].append(t)
        per_cls = {}
        for cls_id in sorted(by_cls):
            if len(by_cls[cls_id]) < 3:
                continue
            try:
                cq_pos, cq_vel = _estimate_process_noise(by_cls[cls_id])
            except RuntimeError:
                continue
            cQ = np.zeros((dim_x, dim_x))
            for i in range(min(len(cq_pos), dim_z)):
                cQ[i, i] = cq_pos[i]
            for i in range(min(len(cq_vel), dim_x - dim_z)):
                cQ[dim_z + i, dim_z + i] = cq_vel[i]
            per_cls[cls_id] = {
                "Q": cQ,
                "R": np.diag(cq_pos[:dim_z]),
                "n_tracks": len(by_cls[cls_id]),
            }
        result["per_class"] = per_cls
    return result


def save_kf_noise(result: dict, path: Path) -> None:
    """JSON-serialize an estimate (arrays become lists)."""

    def conv(v):
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, dict):
            return {str(k): conv(x) for k, x in v.items()}
        return v

    Path(path).write_text(json.dumps({k: conv(v) for k, v in result.items()}, indent=1))
