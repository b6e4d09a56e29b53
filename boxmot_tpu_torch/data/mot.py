"""MOT Challenge dataset access.

The port's own copy of ``MOTDataset`` and what it uses from
``boxmot_tpu/data/mot.py``, unchanged: index `<root>/<seq>` directories,
read seqinfo.ini, and expose per-frame ground truth / public detections as
numpy arrays.  Images are never touched by replay.
"""

from __future__ import annotations

import configparser
import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class SeqInfo:
    name: str
    seq_length: int
    frame_rate: int = 30
    im_width: int = 1920
    im_height: int = 1080
    im_dir: str = "img1"
    im_ext: str = ".jpg"


def read_seqinfo(seq_dir: Path) -> SeqInfo:
    path = Path(seq_dir) / "seqinfo.ini"
    cp = configparser.ConfigParser()
    cp.read(path)
    s = cp["Sequence"]
    return SeqInfo(
        name=s.get("name", Path(seq_dir).name),
        seq_length=int(s.get("seqLength")),
        frame_rate=int(float(s.get("frameRate", "30"))),
        im_width=int(s.get("imWidth", "1920")),
        im_height=int(s.get("imHeight", "1080")),
        im_dir=s.get("imDir", "img1"),
        im_ext=s.get("imExt", ".jpg"),
    )


def load_mot_txt(path: Path) -> np.ndarray:
    """Load a MOT txt (gt or det) as a float array, (N, >=7).

    Columns: frame, id, left, top, width, height, conf[, class, visibility].
    """
    path = Path(path)
    if not path.exists():
        return np.zeros((0, 9), np.float64)
    rows = np.loadtxt(path, delimiter=",", ndmin=2, dtype=np.float64)
    if rows.size == 0:
        return np.zeros((0, 9), np.float64)
    return rows


class MOTSequence:
    """One sequence directory: seqinfo + gt + public detections."""

    def __init__(self, seq_dir: Path):
        self.dir = Path(seq_dir)
        self.info = read_seqinfo(self.dir)
        self.name = self.info.name
        # Like the reference (data/dataset.py:280: sequences index
        # <seq>/img1), the effective length is the number of frame images
        # when present — fixtures ship fewer frames than seqinfo claims.
        imgs = (
            sorted(self.img_dir.glob(f"*{self.info.im_ext}"))
            if self.img_dir.is_dir()
            else []
        )
        self.img_paths = imgs
        self.seq_length = len(imgs) if imgs else self.info.seq_length

    @property
    def img_dir(self) -> Path:
        return self.dir / self.info.im_dir

    def gt(self) -> np.ndarray:
        return load_mot_txt(self.dir / "gt" / "gt.txt")

    def public_dets(self) -> np.ndarray:
        return load_mot_txt(self.dir / "det" / "det.txt")

    def dets_per_frame(self, source: np.ndarray | None = None, cls: float = 0.0):
        """Group detections by frame into tracker input format.

        Returns a list of (Ni, 6) float32 arrays [x1,y1,x2,y2,conf,cls]
        indexed by frame 1..seq_length.
        """
        rows = self.public_dets() if source is None else source
        out = [np.zeros((0, 6), np.float32) for _ in range(self.seq_length)]
        if rows.size == 0:
            return out
        frames = rows[:, 0].astype(int)
        for f in range(1, self.seq_length + 1):
            sel = rows[frames == f]
            if len(sel) == 0:
                continue
            x1 = sel[:, 2]
            y1 = sel[:, 3]
            x2 = sel[:, 2] + sel[:, 4]
            y2 = sel[:, 3] + sel[:, 5]
            conf = sel[:, 6]
            out[f - 1] = np.stack(
                [x1, y1, x2, y2, conf, np.full(len(sel), cls)], axis=-1
            ).astype(np.float32)
        return out


class MOTDataset:
    """A split directory containing sequence subdirectories."""

    def __init__(self, root: Path, names=None):
        """names: optional collection restricting iteration to the given
        sequence names (harnesses that share one on-disk workdir across
        differently-scoped runs must filter here, not just in their own
        config dicts — the walk is otherwise whatever is on disk)."""
        self.root = Path(root)
        keep = None if names is None else set(names)
        self.sequences = [
            MOTSequence(p)
            for p in sorted(self.root.iterdir())
            if p.is_dir()
            and (p / "seqinfo.ini").exists()
            and (keep is None or p.name in keep)
        ]

    def __iter__(self):
        return iter(self.sequences)

    def __len__(self):
        return len(self.sequences)
