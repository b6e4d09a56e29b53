"""The comparisons that decide ``correct``: what the timed path produced
against the plain reference, number by number.  Each number is the worst
over everything compared; ``harness.decide`` holds it to its limit in
``limits/<cell>.json``.

Detection rows are compared padded, so that a detection kept on one side
only shows as a real box against the padding's unit box (confidence -1).
Emitted tracks are compared exactly: fed the same inputs, the reference
tracker runs the program's operations in the program's order on the same
device (the port's kernels equal their plain twins bit for bit), so the
tracks are the same to the bit or differ in a decision."""

from __future__ import annotations

import numpy as np
import torch


def _sorted(rows: np.ndarray) -> np.ndarray:
    """Rows (N, 8) [x1, y1, x2, y2, id, conf, cls, det_ind] sorted by id."""
    return rows[np.argsort(rows[:, 4], kind="stable")]


def rows_differ(got: np.ndarray, want: np.ndarray) -> bool:
    """Whether one frame's emitted rows differ in any bit: the same tracks,
    each with the same box, confidence, class and detection index."""
    return got.shape != want.shape or not np.array_equal(_sorted(got), _sorted(want))


def live_detections(got, want) -> dict:
    """Per window frame, the program's (dets (D, 7), valid, embs (D, F)) against
    the reference's for its pool frame, padding rows included: the largest
    box gap (px, frame coordinates), confidence gap and embedding element
    gap."""
    box = conf = emb = 0.0
    for (gd, _, ge), (wd, _, we) in zip(got, want):
        gd, ge, wd, we = (t.cpu() if torch.is_tensor(t) else t for t in (gd, ge, wd, we))
        box = max(box, float((gd[:, :4] - wd[:, :4]).abs().max()))
        conf = max(conf, float((gd[:, 4] - wd[:, 4]).abs().max()))
        emb = max(emb, float((ge - we).abs().max()))
    return {"det_gap_px": box, "det_conf_gap": conf, "emb_gap": emb}


def live_tracks(got: list, want: list) -> dict:
    """The compared frames whose emitted rows differ from the reference's."""
    return {"track_frames_differ": sum(rows_differ(np.asarray(g, np.float32),
                                                   np.asarray(w, np.float32))
                                       for g, w in zip(got, want))}


def replay_outputs(got: list, outs: np.ndarray, masks: np.ndarray) -> dict:
    """One replay call's results [(outs (n, K, 8), masks (n, K)) a sequence]
    against the reference's (S, n, K, 8) and (S, n, K): the frames of all
    sequences whose emitted rows differ (a missing or cut sequence counts
    all its frames)."""
    differ = 0
    S, n = outs.shape[:2]
    for s in range(S):
        if s >= len(got) or got[s][0].shape[0] != n:
            differ += n
            continue
        go, gm = got[s]
        same = (gm == masks[s]).all(axis=1) & np.where(
            masks[s][..., None], go == outs[s], True).all(axis=(1, 2))
        differ += sum(rows_differ(go[f][gm[f]], outs[s, f][masks[s, f]])
                      for f in np.nonzero(~same)[0])
    return {"frames_differ": differ}


def worst(readings: list[dict]) -> dict:
    """The largest reading of each number over several comparisons."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out
