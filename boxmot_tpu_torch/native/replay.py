"""Native (C++) replay of detection caches (counterpart of
``boxmot_tpu/native/replay.py``), on the host in both packages.

* in-process: ``replay_sequence_native`` drives a ctypes ``NativeTracker``
  over per-frame detections and returns the (N, 9) MOT rows that
  ``run_eval`` scores;
* subprocess: ``replay_cache_cpp`` runs the ``boxmot_replay`` executable on
  a detection cache file (``BOXMOT_PROGRESS`` lines, then a JSON summary).
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

import numpy as np

from boxmot_tpu_torch.engine.mot_io import convert_to_mot_format
from boxmot_tpu_torch.native import _BUILD_DIR, get_library
from boxmot_tpu_torch.native.trackers import _NATIVE_KEYS

PROGRESS_PREFIX = "BOXMOT_PROGRESS\t"


def replay_sequence_native(
    tracker_type: str,
    dets_per_frame,
    tracker_params: dict | None = None,
    frame_offset: int = 0,
    embs_per_frame=None,
) -> np.ndarray:
    """Replay one sequence on a native core; returns (N, 9) MOT rows.

    ``embs_per_frame`` replays cached appearance embeddings through the
    cores' appearance paths."""
    from boxmot_tpu_torch.trackers.zoo import create_tracker

    trk = create_tracker(tracker_type, backend="cpp", device="cpu",
                         evolve_param_dict=tracker_params or None)
    rows = []
    for f, dets in enumerate(dets_per_frame):
        dets = np.asarray(dets, np.float32).reshape(-1, 6)
        embs = None
        if embs_per_frame is not None:
            embs = np.asarray(embs_per_frame[f], np.float32)
        out = trk.update(dets, embs=embs)
        if out.shape[0]:
            rows.append(convert_to_mot_format(np.asarray(out), frame_offset + f + 1))
    if rows:
        return np.concatenate(rows, axis=0)
    return np.empty((0, 9), np.float32)


def replay_executable_path() -> Path:
    """Path to the boxmot_replay executable, building on demand; raises
    where it cannot be built."""
    get_library()  # the on-demand cmake build makes both
    exe = _BUILD_DIR / "boxmot_replay"
    if not exe.exists():
        raise RuntimeError(f"the native build made no boxmot_replay ({exe})")
    return exe


def replay_cache_cpp(
    tracker_type: str,
    dets_cache: Path | str,
    out_txt: Path | str,
    tracker_params: dict | None = None,
    seq_len: int = 0,
    min_conf: float | None = None,
    progress=None,
) -> dict:
    """Run the replay executable on a detection cache.

    Returns the executable's JSON summary ({"frames": F, "rows": N});
    ``progress(frame, total)`` receives BOXMOT_PROGRESS updates.
    """
    exe = replay_executable_path()
    # "_obb" variants share their base tracker's config keys
    keys = _NATIVE_KEYS.get(tracker_type.removesuffix("_obb"))
    if keys is None:
        raise ValueError(f"no native core for tracker {tracker_type!r}")
    params = dict(tracker_params or {})
    params = {
        {"Q_xy_scaling": "q_xy_scaling", "Q_s_scaling": "q_s_scaling"}.get(k, k): v
        for k, v in params.items()
    }
    cfg = ";".join(f"{k}={float(params[k])}" for k in keys if params.get(k) is not None)
    Path(out_txt).parent.mkdir(parents=True, exist_ok=True)
    cmd = [
        str(exe),
        tracker_type,
        str(dets_cache),
        str(out_txt),
        cfg,
        str(int(seq_len)),
        str(min_conf if min_conf is not None else -1.0),
    ]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    summary = {}
    for line in proc.stdout:
        line = line.strip()
        if line.startswith(PROGRESS_PREFIX):
            if progress is not None:
                _, frame, total = line.split("\t")
                progress(int(frame), int(total))
        elif line.startswith("{"):
            summary = json.loads(line)
    proc.wait()
    if proc.returncode != 0:
        err = proc.stderr.read() if proc.stderr else ""
        raise RuntimeError(f"boxmot_replay failed (rc={proc.returncode}): {err.strip()}")
    return summary
