"""MMOT-OBB dataset layout: corner-format GT + npy frames.

The port's own copy of ``MmotDataset`` and what it uses from
``boxmot_tpu/data/mmot.py``, unchanged.  GT/tracker rows are corner format
[frame, id, x1..y4, conf, cls, vis] with class at column 11 (the
reference's trackeval/datasets/mot_challenge_obb.py:244).

Layout on disk:

    <root>/<split>/
        mot/<seq>.txt       corner-format ground truth
        npy/<seq>/*.npy     (H, W, C) uint8 frames (optional for replay)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def corners_to_xywha(corners: np.ndarray) -> np.ndarray:
    """(N, 8) corner rows [x1,y1,...,x4,y4] -> (N, 5) [cx,cy,w,h,angle].

    Inverse of metrics.obb_to_corners: corner 1->2 spans the width edge,
    corner 2->3 the height edge; the angle is the width edge direction.
    """
    c = np.asarray(corners, np.float64).reshape(-1, 4, 2)
    center = c.mean(axis=1)
    e_w = c[:, 1] - c[:, 0]
    e_h = c[:, 2] - c[:, 1]
    w = np.linalg.norm(e_w, axis=1)
    h = np.linalg.norm(e_h, axis=1)
    angle = np.arctan2(e_w[:, 1], e_w[:, 0])
    return np.stack([center[:, 0], center[:, 1], w, h, angle], axis=1).astype(
        np.float32
    )


class MmotSequence:
    """One OBB sequence: GT rows + optional npy frame paths."""

    def __init__(self, split_root: Path, name: str):
        self.root = Path(split_root)
        self.name = name
        self.gt_path = self.root / "mot" / f"{name}.txt"
        frame_dir = self.root / "npy" / name
        self.img_paths = (
            sorted(frame_dir.glob("*.npy")) if frame_dir.is_dir() else []
        )

    @property
    def gt(self) -> np.ndarray:
        """(N, 13) [frame, id, x1..y4, conf, cls, vis] corner rows."""
        return np.loadtxt(self.gt_path, delimiter=",", ndmin=2)

    @property
    def seq_length(self) -> int:
        if self.img_paths:
            return len(self.img_paths)
        gt = self.gt
        return int(gt[:, 0].max()) if gt.size else 0

    def classes(self) -> list[int]:
        gt = self.gt
        return sorted(set(gt[:, 11].astype(int))) if gt.size else []

    def gt_as_obb_dets(self, conf: float = 0.99) -> list[np.ndarray]:
        """Per-frame (Ni, 7) [cx,cy,w,h,angle,conf,cls] detections from
        the ground truth (the gt-as-dets replay used when no cached
        detector output exists)."""
        gt = self.gt
        n = self.seq_length
        out = [np.zeros((0, 7), np.float32) for _ in range(n)]
        if not gt.size:
            return out
        frames = gt[:, 0].astype(int)
        for t in range(1, n + 1):
            rows = gt[frames == t]
            if not len(rows):
                continue
            xywha = corners_to_xywha(rows[:, 2:10])
            out[t - 1] = np.column_stack(
                [xywha, np.full(len(rows), conf, np.float32),
                 rows[:, 11].astype(np.float32)]
            ).astype(np.float32)
        return out


class MmotDataset:
    """A split directory of MMOT OBB sequences."""

    def __init__(self, split_root: Path):
        self.root = Path(split_root)
        mot_dir = self.root / "mot"
        if not mot_dir.is_dir():
            raise FileNotFoundError(f"no mot/ GT directory under {self.root}")
        self.names = sorted(p.stem for p in mot_dir.glob("*.txt"))

    def __len__(self) -> int:
        return len(self.names)

    def __iter__(self):
        for name in self.names:
            yield MmotSequence(self.root, name)
