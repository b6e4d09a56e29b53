"""HOTA / CLEAR / Identity tracking metrics.

The port's own copy of ``boxmot_tpu/engine/metrics/mot_metrics.py``,
unchanged below this paragraph, so that the port's evals give the JAX
package's numbers without importing it.  A CPU test holds the two equal.

Self-contained reimplementation of the TrackEval metric family the
reference shells out to (boxmot/engine/eval/trackeval/runner.py:67-339
downloads and wraps the external `trackeval` package; that package is
not available here, so the metrics are computed natively).  Algorithms
follow the published definitions (Luiten et al., IJCV 2021 for HOTA;
CLEAR-MOT; IDF1) with TrackEval's exact tie-breaking and preprocessing
conventions so scores are comparable with the reference's tables.

All computation is host-side numpy + scipy — the inputs are tiny
(per-frame id lists and similarity matrices).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

EPS = np.finfo(float).eps

# MOT Challenge class conventions (TrackEval MotChallenge2DBox).
PEDESTRIAN = 1
DISTRACTOR_CLASSES = (2, 7, 8, 12)  # person_on_vehicle, static_person, distractor, reflection


def _iou_xywh(g, t):
    """IoU between (N,4) and (M,4) tlwh boxes."""
    if len(g) == 0 or len(t) == 0:
        return np.zeros((len(g), len(t)))
    g1 = np.concatenate([g[:, :2], g[:, :2] + g[:, 2:4]], axis=1)
    t1 = np.concatenate([t[:, :2], t[:, :2] + t[:, 2:4]], axis=1)
    xx1 = np.maximum(g1[:, None, 0], t1[None, :, 0])
    yy1 = np.maximum(g1[:, None, 1], t1[None, :, 1])
    xx2 = np.minimum(g1[:, None, 2], t1[None, :, 2])
    yy2 = np.minimum(g1[:, None, 3], t1[None, :, 3])
    inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
    ag = (g[:, 2] * g[:, 3])[:, None]
    at = (t[:, 2] * t[:, 3])[None, :]
    union = ag + at - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class SeqEvalData:
    """Per-sequence, per-frame ids + similarity after MOT preprocessing."""

    def __init__(self, gt_ids, trk_ids, sims, num_gt_ids, num_trk_ids):
        self.gt_ids = gt_ids  # list of (Ng_t,) int arrays, relabeled 0..num_gt_ids-1
        self.trk_ids = trk_ids
        self.sims = sims  # list of (Ng_t, Nt_t) float arrays
        self.num_gt_ids = num_gt_ids
        self.num_trk_ids = num_trk_ids
        self.num_gt_dets = int(sum(len(x) for x in gt_ids))
        self.num_trk_dets = int(sum(len(x) for x in trk_ids))


def preprocess_sequence(
    gt_rows: np.ndarray,
    trk_rows: np.ndarray,
    seq_length: int,
    do_preproc: bool = True,
) -> SeqEvalData:
    """MOT-Challenge preprocessing (TrackEval convention):

    1. per frame, Hungarian-match tracker dets to raw gt at IoU >= 0.5 and
       drop tracker dets matched to distractor-class gt;
    2. keep only pedestrian gt with the 'consider' flag set.

    gt_rows: (N, >=9) [frame, id, l, t, w, h, consider, class, vis]
    trk_rows: (M, >=7) [frame, id, l, t, w, h, conf, ...]
    """
    gt_f = gt_rows[:, 0].astype(int) if gt_rows.size else np.zeros(0, int)
    tr_f = trk_rows[:, 0].astype(int) if trk_rows.size else np.zeros(0, int)

    gt_ids_per_t, trk_ids_per_t, sims = [], [], []
    for t in range(1, seq_length + 1):
        g = gt_rows[gt_f == t] if gt_rows.size else np.zeros((0, 9))
        r = trk_rows[tr_f == t] if trk_rows.size else np.zeros((0, 7))
        g_boxes = g[:, 2:6]
        r_boxes = r[:, 2:6]
        sim = _iou_xywh(g_boxes, r_boxes)

        keep_trk = np.ones(len(r), bool)
        if do_preproc and len(g) and len(r):
            g_cls = g[:, 7].astype(int) if g.shape[1] > 7 else np.ones(len(g), int)
            matching = sim.copy()
            matching[matching < 0.5 - EPS] = 0
            mr, mc = linear_sum_assignment(-matching)
            ok = matching[mr, mc] > 0 + EPS
            mr, mc = mr[ok], mc[ok]
            distractor = np.isin(g_cls[mr], DISTRACTOR_CLASSES)
            keep_trk[mc[distractor]] = False

        if do_preproc and len(g):
            g_cls = g[:, 7].astype(int) if g.shape[1] > 7 else np.ones(len(g), int)
            consider = g[:, 6] != 0 if g.shape[1] > 6 else np.ones(len(g), bool)
            keep_gt = consider & (g_cls == PEDESTRIAN)
        else:
            keep_gt = np.ones(len(g), bool)

        g = g[keep_gt]
        r = r[keep_trk]
        sim = sim[keep_gt][:, keep_trk]
        gt_ids_per_t.append(g[:, 1].astype(int))
        trk_ids_per_t.append(r[:, 1].astype(int))
        sims.append(sim)

    # Relabel ids to contiguous [0, n)
    def relabel(ids_per_t):
        uniq = np.unique(np.concatenate(ids_per_t)) if any(len(x) for x in ids_per_t) else np.zeros(0, int)
        lut = {v: i for i, v in enumerate(uniq)}
        return [np.array([lut[v] for v in ids], int) for ids in ids_per_t], len(uniq)

    gt_ids_per_t, n_gt = relabel(gt_ids_per_t)
    trk_ids_per_t, n_trk = relabel(trk_ids_per_t)
    return SeqEvalData(gt_ids_per_t, trk_ids_per_t, sims, n_gt, n_trk)


def _rotated_iou_polys(gt_polys: np.ndarray, trk_polys: np.ndarray) -> np.ndarray:
    """Rotated IoU between corner polygons (N, 8) x (M, 8) via
    cv2.minAreaRect + rotatedRectangleIntersection — exact mirror of the
    OBB TrackEval similarity (mot_challenge_obb.py:58-86)."""
    import cv2

    n, m = len(gt_polys), len(trk_polys)
    out = np.zeros((n, m), np.float32)
    if n == 0 or m == 0:
        return out
    g_rects = [cv2.minAreaRect(p.reshape(4, 2).astype(np.float32)) for p in gt_polys]
    t_rects = [cv2.minAreaRect(p.reshape(4, 2).astype(np.float32)) for p in trk_polys]
    g_areas = [r[1][0] * r[1][1] for r in g_rects]
    t_areas = [r[1][0] * r[1][1] for r in t_rects]
    for i in range(n):
        if g_areas[i] <= EPS:
            continue
        for j in range(m):
            if t_areas[j] <= EPS:
                continue
            ret, inter = cv2.rotatedRectangleIntersection(g_rects[i], t_rects[j])
            if ret == cv2.INTERSECT_NONE or inter is None or len(inter) == 0:
                continue
            ia = float(cv2.contourArea(inter))
            union = g_areas[i] + t_areas[j] - ia
            if union > EPS:
                out[i, j] = ia / union
    return out


def obb_to_corners(xywha: np.ndarray) -> np.ndarray:
    """(N, 5) [cx, cy, w, h, theta_rad] -> (N, 8) corner polygons."""
    import cv2

    out = np.zeros((len(xywha), 8), np.float32)
    for i, (cx, cy, w, h, a) in enumerate(np.asarray(xywha, np.float64)):
        pts = cv2.boxPoints(((cx, cy), (max(w, 1e-4), max(h, 1e-4)), np.degrees(a)))
        out[i] = pts.reshape(-1)
    return out


def preprocess_sequence_obb(
    gt_rows: np.ndarray,
    trk_rows: np.ndarray,
    seq_length: int,
    cls_id: int | None = None,
) -> SeqEvalData:
    """OBB MOT preprocessing (CustomMotChallengeOBB semantics,
    mot_challenge_obb.py:197-319): corner-format rows
    [frame, id, x1..y4 (cols 2-9), conf, cls]; per-frame class filtering
    only (no distractor removal), rotated-IoU similarity.
    """
    gt_f = gt_rows[:, 0].astype(int) if gt_rows.size else np.zeros(0, int)
    tr_f = trk_rows[:, 0].astype(int) if trk_rows.size else np.zeros(0, int)

    gt_ids_per_t, trk_ids_per_t, sims = [], [], []
    for t in range(1, seq_length + 1):
        g = gt_rows[gt_f == t] if gt_rows.size else np.zeros((0, 12))
        r = trk_rows[tr_f == t] if trk_rows.size else np.zeros((0, 12))
        if cls_id is not None:
            if len(g) and g.shape[1] > 11:
                g = g[g[:, 11].astype(int) == cls_id]
            if len(r) and r.shape[1] > 11:
                r = r[r[:, 11].astype(int) == cls_id]
        sim = _rotated_iou_polys(g[:, 2:10], r[:, 2:10])
        gt_ids_per_t.append(g[:, 1].astype(int))
        trk_ids_per_t.append(r[:, 1].astype(int))
        sims.append(sim)

    def relabel(ids_per_t):
        uniq = (
            np.unique(np.concatenate(ids_per_t))
            if any(len(x) for x in ids_per_t)
            else np.zeros(0, int)
        )
        lut = {v: i for i, v in enumerate(uniq)}
        return [np.array([lut[v] for v in ids], int) for ids in ids_per_t], len(uniq)

    gt_ids_per_t, n_gt = relabel(gt_ids_per_t)
    trk_ids_per_t, n_trk = relabel(trk_ids_per_t)
    return SeqEvalData(gt_ids_per_t, trk_ids_per_t, sims, n_gt, n_trk)


# ---------------------------------------------------------------------------
# CLEAR
# ---------------------------------------------------------------------------


def clear_metrics(data: SeqEvalData, threshold: float = 0.5) -> dict:
    TP = FN = FP = IDSW = 0
    MOTP_sum = 0.0
    Frag = 0
    gt_id_count = np.zeros(data.num_gt_ids)
    gt_matched_count = np.zeros(data.num_gt_ids)
    gt_frag_count = np.zeros(data.num_gt_ids)
    prev_tracker_id = np.full(data.num_gt_ids, np.nan)
    prev_timestep_tracker_id = np.full(data.num_gt_ids, np.nan)

    for gt_ids_t, trk_ids_t, sim in zip(data.gt_ids, data.trk_ids, data.sims):
        gt_id_count[gt_ids_t] += 1
        if len(gt_ids_t) == 0:
            FP += len(trk_ids_t)
            continue
        if len(trk_ids_t) == 0:
            FN += len(gt_ids_t)
            prev_timestep_tracker_id[:] = np.nan
            continue

        score_mat = (
            trk_ids_t[None, :] == prev_timestep_tracker_id[gt_ids_t[:, None]]
        ).astype(float)
        score_mat = 1000 * score_mat + sim
        score_mat[sim < threshold - EPS] = 0
        mr, mc = linear_sum_assignment(-score_mat)
        ok = score_mat[mr, mc] > 0 + EPS
        mr, mc = mr[ok], mc[ok]

        matched_gt = gt_ids_t[mr]
        matched_trk = trk_ids_t[mc]
        prev_match = prev_tracker_id[matched_gt]
        is_idsw = (~np.isnan(prev_match)) & (matched_trk != prev_match)
        IDSW += int(is_idsw.sum())

        gt_matched_count[matched_gt] += 1
        not_prev_tracked = np.isnan(prev_timestep_tracker_id[matched_gt])
        was_tracked_before = ~np.isnan(prev_tracker_id[matched_gt])
        Frag += int((not_prev_tracked & was_tracked_before).sum())
        gt_frag_count[matched_gt] += (not_prev_tracked & was_tracked_before)

        prev_tracker_id[matched_gt] = matched_trk
        prev_timestep_tracker_id[:] = np.nan
        prev_timestep_tracker_id[matched_gt] = matched_trk

        nm = len(mr)
        TP += nm
        FN += len(gt_ids_t) - nm
        FP += len(trk_ids_t) - nm
        MOTP_sum += float(sim[mr, mc].sum())

    tracked_ratio = gt_matched_count[gt_id_count > 0] / np.maximum(
        1, gt_id_count[gt_id_count > 0]
    )
    MT = int((tracked_ratio > 0.8).sum())
    ML = int((tracked_ratio < 0.2).sum())
    PT = int(len(tracked_ratio) - MT - ML)
    return {
        "CLR_TP": TP,
        "CLR_FN": FN,
        "CLR_FP": FP,
        "IDSW": IDSW,
        "MOTP_sum": MOTP_sum,
        "Frag": Frag,
        "MT": MT,
        "PT": PT,
        "ML": ML,
        "CLR_gt_count": TP + FN,
    }


def clear_finalize(c: dict) -> dict:
    num_gt = max(1, c["CLR_gt_count"])
    tp = c["CLR_TP"]
    out = dict(c)
    out["MOTA"] = 1.0 - (c["CLR_FN"] + c["CLR_FP"] + c["IDSW"]) / num_gt
    out["MOTP"] = c["MOTP_sum"] / max(1, tp)
    out["CLR_Re"] = tp / num_gt
    out["CLR_Pr"] = tp / max(1, tp + c["CLR_FP"])
    return out


# ---------------------------------------------------------------------------
# Identity (IDF1)
# ---------------------------------------------------------------------------


def identity_metrics(data: SeqEvalData, threshold: float = 0.5) -> dict:
    n_gt, n_trk = data.num_gt_ids, data.num_trk_ids
    potential = np.zeros((n_gt, n_trk))
    gt_id_count = np.zeros(n_gt)
    trk_id_count = np.zeros(n_trk)
    for gt_ids_t, trk_ids_t, sim in zip(data.gt_ids, data.trk_ids, data.sims):
        if len(gt_ids_t) and len(trk_ids_t):
            ok = sim >= threshold - EPS
            gi, ti = np.nonzero(ok)
            np.add.at(potential, (gt_ids_t[gi], trk_ids_t[ti]), 1)
        gt_id_count[gt_ids_t] += 1
        trk_id_count[trk_ids_t] += 1

    num_gt_dets = data.num_gt_dets
    num_trk_dets = data.num_trk_dets
    if n_gt and n_trk:
        size = n_gt + n_trk
        fn_mat = np.zeros((size, size))
        fp_mat = np.zeros((size, size))
        fn_mat[:n_gt, :] = gt_id_count[:, None]
        fp_mat[:, :n_trk] = trk_id_count[None, :]
        cost = fn_mat + fp_mat
        cost[:n_gt, :n_trk] -= 2 * potential
        mr, mc = linear_sum_assignment(cost)
        real = (mr < n_gt) & (mc < n_trk)
        IDTP = int(potential[mr[real], mc[real]].sum())
    else:
        IDTP = 0
    return {
        "IDTP": IDTP,
        "IDFN": num_gt_dets - IDTP,
        "IDFP": num_trk_dets - IDTP,
    }


def identity_finalize(c: dict) -> dict:
    out = dict(c)
    denom = c["IDTP"] + 0.5 * c["IDFN"] + 0.5 * c["IDFP"]
    out["IDF1"] = c["IDTP"] / max(1e-10, denom)
    out["IDR"] = c["IDTP"] / max(1e-10, c["IDTP"] + c["IDFN"])
    out["IDP"] = c["IDTP"] / max(1e-10, c["IDTP"] + c["IDFP"])
    return out


# ---------------------------------------------------------------------------
# HOTA
# ---------------------------------------------------------------------------

ALPHAS = np.arange(0.05, 0.99, 0.05)  # 19 thresholds


def hota_metrics(data: SeqEvalData) -> dict:
    n_gt, n_trk = data.num_gt_ids, data.num_trk_ids
    nA = len(ALPHAS)
    if n_gt == 0 or n_trk == 0:
        fn = data.num_gt_dets
        fp = data.num_trk_dets
        return {
            "HOTA_TP": np.zeros(nA),
            "HOTA_FN": np.full(nA, float(fn)),
            "HOTA_FP": np.full(nA, float(fp)),
            "AssA": np.zeros(nA),
            "AssRe": np.zeros(nA),
            "AssPr": np.zeros(nA),
            "LocA_sum": np.zeros(nA),
        }

    potential = np.zeros((n_gt, n_trk))
    gt_id_count = np.zeros((n_gt, 1))
    trk_id_count = np.zeros((1, n_trk))
    for gt_ids_t, trk_ids_t, sim in zip(data.gt_ids, data.trk_ids, data.sims):
        if len(gt_ids_t) and len(trk_ids_t):
            denom = sim.sum(0)[None, :] + sim.sum(1)[:, None] - sim
            sim_iou = np.zeros_like(sim)
            m = denom > 0 + EPS
            sim_iou[m] = sim[m] / denom[m]
            np.add.at(
                potential,
                (gt_ids_t[:, None], trk_ids_t[None, :]),
                sim_iou,
            )
        gt_id_count[gt_ids_t] += 1
        trk_id_count[0, trk_ids_t] += 1

    global_alignment = potential / np.maximum(
        1e-10, gt_id_count + trk_id_count - potential
    )

    TP = np.zeros(nA)
    FN = np.zeros(nA)
    FP = np.zeros(nA)
    LocA_sum = np.zeros(nA)
    matches_counts = [np.zeros((n_gt, n_trk)) for _ in range(nA)]

    for gt_ids_t, trk_ids_t, sim in zip(data.gt_ids, data.trk_ids, data.sims):
        if len(gt_ids_t) == 0:
            FP += len(trk_ids_t)
            continue
        if len(trk_ids_t) == 0:
            FN += len(gt_ids_t)
            continue
        score_mat = global_alignment[gt_ids_t[:, None], trk_ids_t[None, :]] * sim
        mr, mc = linear_sum_assignment(-score_mat)
        for a, alpha in enumerate(ALPHAS):
            ok = sim[mr, mc] >= alpha - EPS
            amr, amc = mr[ok], mc[ok]
            nm = len(amr)
            TP[a] += nm
            FN[a] += len(gt_ids_t) - nm
            FP[a] += len(trk_ids_t) - nm
            LocA_sum[a] += float(sim[amr, amc].sum())
            matches_counts[a][gt_ids_t[amr], trk_ids_t[amc]] += 1

    AssA = np.zeros(nA)
    AssRe = np.zeros(nA)
    AssPr = np.zeros(nA)
    for a in range(nA):
        mcnt = matches_counts[a]
        ass_a = mcnt / np.maximum(1.0, gt_id_count + trk_id_count - mcnt)
        AssA[a] = float((mcnt * ass_a).sum()) / max(1.0, TP[a])
        ass_re = mcnt / np.maximum(1.0, gt_id_count)
        AssRe[a] = float((mcnt * ass_re).sum()) / max(1.0, TP[a])
        ass_pr = mcnt / np.maximum(1.0, trk_id_count)
        AssPr[a] = float((mcnt * ass_pr).sum()) / max(1.0, TP[a])

    return {
        "HOTA_TP": TP,
        "HOTA_FN": FN,
        "HOTA_FP": FP,
        "AssA": AssA,
        "AssRe": AssRe,
        "AssPr": AssPr,
        "LocA_sum": LocA_sum,
    }


def hota_finalize(c: dict) -> dict:
    out = dict(c)
    TP, FN, FP = c["HOTA_TP"], c["HOTA_FN"], c["HOTA_FP"]
    DetA = TP / np.maximum(1e-10, TP + FN + FP)
    DetRe = TP / np.maximum(1e-10, TP + FN)
    DetPr = TP / np.maximum(1e-10, TP + FP)
    HOTA_a = np.sqrt(DetA * c["AssA"])
    out["DetA"] = float(DetA.mean())
    out["DetRe"] = float(DetRe.mean())
    out["DetPr"] = float(DetPr.mean())
    out["AssA_mean"] = float(np.asarray(c["AssA"]).mean())
    out["AssRe_mean"] = float(np.asarray(c["AssRe"]).mean())
    out["AssPr_mean"] = float(np.asarray(c["AssPr"]).mean())
    out["LocA"] = float(
        np.mean(np.asarray(c["LocA_sum"]) / np.maximum(1e-10, TP))
    )
    out["HOTA"] = float(HOTA_a.mean())
    out["HOTA_alpha"] = HOTA_a
    return out


# ---------------------------------------------------------------------------
# Multi-sequence combination (TrackEval COMBINED_SEQ semantics)
# ---------------------------------------------------------------------------


def combine_clear(per_seq: list[dict]) -> dict:
    keys = ["CLR_TP", "CLR_FN", "CLR_FP", "IDSW", "MOTP_sum", "Frag", "MT", "PT", "ML", "CLR_gt_count"]
    return {k: sum(c[k] for c in per_seq) for k in keys}


def combine_identity(per_seq: list[dict]) -> dict:
    return {k: sum(c[k] for c in per_seq) for k in ["IDTP", "IDFN", "IDFP"]}


def combine_hota(per_seq: list[dict]) -> dict:
    TP = sum(np.asarray(c["HOTA_TP"]) for c in per_seq)
    FN = sum(np.asarray(c["HOTA_FN"]) for c in per_seq)
    FP = sum(np.asarray(c["HOTA_FP"]) for c in per_seq)
    LocA_sum = sum(np.asarray(c["LocA_sum"]) for c in per_seq)
    # AssA/Re/Pr combine weighted by per-seq TP (TrackEval combine_sequences).
    def wavg(key):
        num = sum(np.asarray(c[key]) * np.asarray(c["HOTA_TP"]) for c in per_seq)
        return num / np.maximum(1.0, TP)

    return {
        "HOTA_TP": TP,
        "HOTA_FN": FN,
        "HOTA_FP": FP,
        "AssA": wavg("AssA"),
        "AssRe": wavg("AssRe"),
        "AssPr": wavg("AssPr"),
        "LocA_sum": LocA_sum,
    }


def evaluate_sequences(seq_data: dict[str, SeqEvalData]) -> dict:
    """Full evaluation: per-sequence + combined HOTA/CLEAR/Identity."""
    per_seq = {}
    clear_cs, id_cs, hota_cs = [], [], []
    for name, data in seq_data.items():
        c = clear_metrics(data)
        i = identity_metrics(data)
        h = hota_metrics(data)
        clear_cs.append(c)
        id_cs.append(i)
        hota_cs.append(h)
        per_seq[name] = {
            **clear_finalize(c),
            **identity_finalize(i),
            **hota_finalize(h),
        }
    combined = {
        **clear_finalize(combine_clear(clear_cs)),
        **identity_finalize(combine_identity(id_cs)),
        **hota_finalize(combine_hota(hota_cs)),
    }
    return {"per_seq": per_seq, "combined": combined}


def evaluate_obb_results(gt_root, results_root, seq_lengths=None, cls_id=None):
    """Offline OBB evaluation of saved tracker outputs
    (CustomMotChallengeOBB end-to-end, mot_challenge_obb.py:108-325).

    gt_root: directory of <seq>.txt corner-format ground-truth files (or
    MOT-style <seq>/gt/gt.txt); results_root: directory of <seq>.txt
    tracker outputs in the same layout. seq_lengths: optional
    {seq: n_frames}; defaults to the max frame index seen.
    """
    from pathlib import Path

    gt_root = Path(gt_root)
    results_root = Path(results_root)
    seq_data = {}
    gt_files = sorted(gt_root.glob("*.txt"))
    if not gt_files:
        gt_files = sorted(gt_root.glob("*/gt/gt.txt"))
    if not gt_files:
        raise FileNotFoundError(f"no OBB ground-truth files under {gt_root}")
    for gt_file in gt_files:
        seq = gt_file.stem if gt_file.parent == gt_root else gt_file.parent.parent.name
        res_file = results_root / f"{seq}.txt"
        gt = np.loadtxt(gt_file, delimiter=",", ndmin=2)
        trk = (
            np.loadtxt(res_file, delimiter=",", ndmin=2)
            if res_file.exists() and res_file.stat().st_size
            else np.zeros((0, 12))
        )
        n = None if seq_lengths is None else seq_lengths.get(seq)
        if n is None:
            n = int(max(gt[:, 0].max() if gt.size else 0,
                        trk[:, 0].max() if trk.size else 0))
        seq_data[seq] = preprocess_sequence_obb(gt, trk, n, cls_id=cls_id)
    return evaluate_sequences(seq_data)
