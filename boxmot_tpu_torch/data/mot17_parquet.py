"""A copy of ``boxmot_tpu/data/mot17_parquet.py``.

MOT17 bootstrap from parquet shards into the MOTChallenge layout.

Role mirror of boxmot/data/mot17_parquet.py:40-345 (HuggingFace parquet
-> MOT tree + public-det npy caches; ablation = renumbered second half
of train).  This environment has no network egress, so the download step
is optional: point ``parquet_root`` at a local snapshot of the dataset
repo (the ``images/<split>/<seq>/img1/*.jpg`` tree plus
``data/seqinfo/seqinfo.parquet``, ``data/gt/<split>-*.parquet``, and
``data/detections/<det>/<split>-*.parquet`` shards) and the same tree is
materialized.

Parquet schemas (column names shared with the upstream dataset repo):

- seqinfo: sequence, split, seq_length, fps, width, height
- gt:      sequence, frame, track_id, bbox_left, bbox_top, bbox_width,
           bbox_height, conf, class_id, visibility
- det:     sequence, frame, bbox_left, bbox_top, bbox_width,
           bbox_height, score
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.logging import LOGGER

DETECTORS = ("DPM", "FRCNN", "SDP")


def ablation_start(seq_length: int) -> int:
    """First original frame of the ablation split (second half of train,
    ByteTrack convention: seqLength // 2 + 2; frames renumbered from 1)."""
    return seq_length // 2 + 2


def _find_shard(root: Path, relative: str) -> Path | None:
    """Resolve a parquet shard allowing the -0000x-of-0000y suffix."""
    exact = root / relative
    if exact.exists():
        return exact
    parent = exact.parent
    if not parent.is_dir():
        return None
    matches = sorted(parent.glob(exact.stem + "*" + exact.suffix))
    return matches[0] if matches else None


def _frame_window(split: str, seq_length: int) -> tuple[int, int]:
    if split == "ablation":
        return ablation_start(seq_length), seq_length
    return 1, seq_length


def _renumber(df, frame_start: int, frame_end: int):
    df = df[(df["frame"] >= frame_start) & (df["frame"] <= frame_end)].copy()
    df["frame"] = df["frame"] - frame_start + 1
    return df


def _write_seqinfo(path: Path, name: str, row, length: int) -> None:
    path.write_text(
        "\n".join(
            [
                "[Sequence]",
                f"name={name}",
                "imDir=img1",
                f"frameRate={int(row['fps'])}",
                f"seqLength={length}",
                f"imWidth={int(row['width'])}",
                f"imHeight={int(row['height'])}",
                "imExt=.jpg",
                "",
            ]
        )
    )


def setup_mot17_from_parquet(
    dest: Path,
    split: str = "ablation",
    detector: str = "FRCNN",
    parquet_root: Path | None = None,
    cache_root: Path | None = None,
    overwrite: bool = False,
) -> Path:
    """Materialize ``dest/<split>/MOT17-XX-<det>/{img1,gt,det,seqinfo.ini}``.

    ``parquet_root`` must hold the local dataset snapshot; when None,
    ``dest/.parquet_cache`` is tried (a previously fetched snapshot).
    When ``cache_root`` is given, public detections are also written as
    (N, 7) [frame, x1, y1, x2, y2, conf, cls] npy caches in this
    framework's cache layout (data/cache.py det_cache_path).

    Returns the split directory.
    """
    import pandas as pd

    detector = detector.upper()
    if detector not in DETECTORS:
        raise ValueError(f"detector must be one of {DETECTORS}, got {detector!r}")

    split_dir = Path(dest) / split
    marker = split_dir / ".parquet_setup_complete"
    if marker.exists() and not overwrite:
        return split_dir

    root = Path(parquet_root) if parquet_root else Path(dest) / ".parquet_cache"
    seqinfo_shard = _find_shard(root, "data/seqinfo/seqinfo.parquet")
    if seqinfo_shard is None:
        raise FileNotFoundError(
            f"no seqinfo parquet under {root}; provide parquet_root with a "
            "local snapshot (no network egress in this environment)"
        )
    seqinfo = pd.read_parquet(seqinfo_shard)

    img_split = "train" if split in ("train", "ablation", "val") else "test"
    gt_split = "train" if split == "ablation" else split
    gt_shard = _find_shard(root, f"data/gt/{gt_split}.parquet")
    det_shard = _find_shard(
        root, f"data/detections/{detector.lower()}/{gt_split}.parquet"
    )
    gt_df = pd.read_parquet(gt_shard) if gt_shard else None
    det_df = pd.read_parquet(det_shard) if det_shard else None

    split_dir.mkdir(parents=True, exist_ok=True)
    for _, row in seqinfo[seqinfo["split"] == img_split].iterrows():
        seq = row["sequence"]
        seq_full = f"{seq}-{detector}"
        seq_dir = split_dir / seq_full
        total = int(row["seq_length"])
        frame_start, frame_end = _frame_window(split, total)
        length = frame_end - frame_start + 1
        seq_dir.mkdir(parents=True, exist_ok=True)

        img1 = seq_dir / "img1"
        shared = root / "images" / img_split / seq / "img1"
        if not img1.exists() and shared.is_dir():
            if split == "ablation":
                img1.mkdir(parents=True)
                for new_idx in range(1, length + 1):
                    src = shared / f"{frame_start + new_idx - 1:06d}.jpg"
                    if src.exists():
                        (img1 / f"{new_idx:06d}.jpg").symlink_to(src.resolve())
            else:
                img1.symlink_to(shared.resolve())

        _write_seqinfo(seq_dir / "seqinfo.ini", seq_full, row, length)

        if gt_df is not None:
            rows = _renumber(
                gt_df[gt_df["sequence"] == seq], frame_start, frame_end
            )
            if len(rows):
                (seq_dir / "gt").mkdir(exist_ok=True)
                cols = ["frame", "track_id", "bbox_left", "bbox_top",
                        "bbox_width", "bbox_height", "conf", "class_id",
                        "visibility"]
                rows[cols].to_csv(seq_dir / "gt" / "gt.txt", index=False,
                                  header=False, float_format="%.6g")

        if det_df is not None:
            rows = _renumber(
                det_df[det_df["sequence"] == seq], frame_start, frame_end
            )
            if len(rows):
                (seq_dir / "det").mkdir(exist_ok=True)
                out = pd.DataFrame(
                    {
                        "frame": rows["frame"],
                        "id": -1,
                        "l": rows["bbox_left"],
                        "t": rows["bbox_top"],
                        "w": rows["bbox_width"],
                        "h": rows["bbox_height"],
                        "s": rows["score"],
                        "a": -1,
                        "b": -1,
                        "c": -1,
                    }
                )
                out.to_csv(seq_dir / "det" / "det.txt", index=False,
                           header=False, float_format="%.6g")
            if cache_root is not None and len(rows):
                from .cache import det_cache_path

                npy = det_cache_path(
                    Path(cache_root), f"mot17_public_{detector.lower()}", seq_full
                )
                npy.parent.mkdir(parents=True, exist_ok=True)
                x1 = rows["bbox_left"].to_numpy(np.float32)
                y1 = rows["bbox_top"].to_numpy(np.float32)
                w = rows["bbox_width"].to_numpy(np.float32)
                h = rows["bbox_height"].to_numpy(np.float32)
                arr = np.stack(
                    [
                        rows["frame"].to_numpy(np.float32),
                        x1, y1, x1 + w, y1 + h,
                        rows["score"].to_numpy(np.float32),
                        np.zeros(len(rows), np.float32),  # class 0 = person
                    ],
                    axis=1,
                )
                np.save(npy, arr)

    # Only mark complete when every shard this split needs was present;
    # a partial snapshot must retry on the next call, not short-circuit.
    needs_gt = split != "test"
    complete = (det_df is not None) and (gt_df is not None or not needs_gt)
    if complete:
        marker.touch()
        LOGGER.info("MOT17 parquet setup complete: %s", split_dir)
    else:
        LOGGER.warning(
            "MOT17 parquet setup partial (missing %s shard) — will retry "
            "next run: %s",
            "gt" if gt_df is None and needs_gt else "det",
            split_dir,
        )
    return split_dir
