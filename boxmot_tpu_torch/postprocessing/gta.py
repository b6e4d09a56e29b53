"""A copy of ``boxmot_tpu/postprocessing/gta.py``.

Offline Global Tracklet Association (GTA).

Port of boxmot/postprocessing/gta.py:66-1340 (Sun et al., ACCV 2024
Workshop: split mixed-identity tracklets with DBSCAN over ReID
embeddings, then hierarchically merge same-identity tracklets by average
pairwise cosine distance under temporal and spatial constraints) —
implemented with numpy + scikit-learn only.

Tracklets come from MOT result rows plus per-frame embeddings; the
embedding lookup uses the det_ind column written by the trackers, so the
same det/emb caches that feed replay also feed GTA.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
from scipy.spatial.distance import cdist

from boxmot_tpu_torch.postprocessing.base import Postprocessor


@dataclasses.dataclass
class Tracklet:
    track_id: int
    times: list
    scores: list
    bboxes: list  # [x, y, w, h]
    classes: list
    features: list
    parent_id: int = None

    def __post_init__(self):
        if self.parent_id is None:
            self.parent_id = self.track_id

    def extract(self, start: int, end: int) -> "Tracklet":
        sub = Tracklet(
            self.track_id,
            self.times[start : end + 1],
            self.scores[start : end + 1],
            self.bboxes[start : end + 1],
            self.classes[start : end + 1],
            self.features[start : end + 1],
        )
        sub.parent_id = self.track_id
        return sub

    def merge_from(self, other: "Tracklet"):
        self.times += other.times
        self.scores += other.scores
        self.bboxes += other.bboxes
        self.classes += other.classes
        self.features += other.features
        order = np.argsort(self.times, kind="stable")
        self.times = [self.times[k] for k in order]
        self.scores = [self.scores[k] for k in order]
        self.bboxes = [self.bboxes[k] for k in order]
        self.classes = [self.classes[k] for k in order]
        self.features = [self.features[k] for k in order]


def find_consecutive_segments(track_times):
    if not track_times:
        return []
    segments = []
    start = end = 0
    for i in range(1, len(track_times)):
        if track_times[i] == track_times[end] + 1:
            end = i
        else:
            segments.append((start, end))
            start = end = i
    segments.append((start, end))
    return segments


def query_subtracks(seg1, seg2, track1, track2):
    """All consecutive-run subtracks of both tracklets, sorted by start
    frame (gta.py:218-276)."""
    subs = [track1.extract(s, e) for s, e in seg1]
    subs += [track2.extract(s, e) for s, e in seg2]
    subs.sort(key=lambda t: t.times[0])
    return subs


def get_distance(t1: Tracklet, t2: Tracklet) -> float:
    """Average pairwise cosine distance; 1.0 on temporal overlap."""
    if t1.track_id == t2.track_id:
        return 0.0
    if set(t1.times) & set(t2.times):
        return 1.0
    a = np.stack(t1.features).astype(np.float64)
    b = np.stack(t2.features).astype(np.float64)
    a = a / np.clip(np.linalg.norm(a, axis=1, keepdims=True), 1e-8, None)
    b = b / np.clip(np.linalg.norm(b, axis=1, keepdims=True), 1e-8, None)
    return float((1.0 - a @ b.T).mean())


def get_spatial_constraints(tid2track, factor):
    cx_all, cy_all = [], []
    for track in tid2track.values():
        for x, y, w, h in (b[:4] for b in track.bboxes):
            cx_all.append(x + w / 2)
            cy_all.append(y + h / 2)
    if not cx_all:
        return 0.0, 0.0
    return (
        (max(cx_all) - min(cx_all)) * factor,
        (max(cy_all) - min(cy_all)) * factor,
    )


def check_spatial_constraints(t1, t2, max_x_range, max_y_range):
    subs = query_subtracks(
        find_consecutive_segments(t1.times), find_consecutive_segments(t2.times), t1, t2
    )
    if len(subs) < 2:
        return True
    prev = subs[0]
    for cur in subs[1:]:
        if prev.parent_id == cur.parent_id:
            prev = cur
            continue
        x1, y1, w1, h1 = prev.bboxes[-1][:4]
        x2, y2, w2, h2 = cur.bboxes[0][:4]
        if (
            abs((x1 + w1 / 2) - (x2 + w2 / 2)) > max_x_range
            or abs((y1 + h1 / 2) - (y2 + h2 / 2)) > max_y_range
        ):
            return False
        prev = cur
    return True


def detect_id_switch(embs, eps=0.7, min_samples=10, max_clusters=None):
    """DBSCAN over (scaled) embeddings, noise reassignment, cluster-count
    cap (gta.py:424-498)."""
    from sklearn.cluster import DBSCAN
    from sklearn.preprocessing import StandardScaler

    embs = np.asarray(embs)
    if len(embs) > 15000:
        embs = embs[::2]
    embs_scaled = StandardScaler().fit_transform(embs)
    labels = DBSCAN(eps=eps, min_samples=min_samples, metric="cosine").fit(
        embs_scaled
    ).labels_.copy()

    uniq = np.unique(labels)
    uniq = uniq[uniq != -1]
    if -1 in labels and len(uniq) > 0:
        centers = np.array([embs_scaled[labels == u].mean(axis=0) for u in uniq])
        for idx in np.where(labels == -1)[0]:
            labels[idx] = uniq[
                np.argmin(cdist([embs_scaled[idx]], centers, metric="cosine"))
            ]
    uniq = np.unique(labels)
    uniq = uniq[uniq != -1]
    n = len(uniq)
    if max_clusters and n > max_clusters:
        while n > max_clusters:
            centers = np.array([embs_scaled[labels == u].mean(axis=0) for u in uniq])
            dmat = cdist(centers, centers, metric="cosine")
            np.fill_diagonal(dmat, np.inf)
            i, j = np.unravel_index(np.argmin(dmat), dmat.shape)
            labels[labels == uniq[j]] = uniq[i]
            uniq = np.unique(labels)
            uniq = uniq[uniq != -1]
            n = len(uniq)
    return n > 1, labels


def split_tracklets(tmp_trklets, eps=0.7, max_k=3, min_samples=10, len_thres=100):
    new_id = max(tmp_trklets.keys()) + 1 if tmp_trklets else 1
    out = {}
    for tid in sorted(tmp_trklets):
        trk = tmp_trklets[tid]
        if len(trk.times) < len_thres:
            out[tid] = trk
            continue
        embs = np.stack(trk.features)
        switch, clusters = detect_id_switch(
            embs, eps=eps, min_samples=min_samples, max_clusters=max_k
        )
        if not switch:
            out[tid] = trk
            continue
        for label in set(clusters):
            if label == -1:
                continue
            mask = clusters == label
            idxs = np.where(mask)[0]
            out[new_id] = Tracklet(
                new_id,
                [trk.times[i] for i in idxs],
                [trk.scores[i] for i in idxs],
                [trk.bboxes[i] for i in idxs],
                [trk.classes[i] for i in idxs],
                [trk.features[i] for i in idxs],
            )
            new_id += 1
    return out


def merge_tracklets(tracklets, merge_dist_thres, max_x_range, max_y_range):
    """Hierarchical agglomerative merge (gta.py:575-666)."""
    if len(tracklets) <= 1:
        return tracklets
    tids = list(tracklets.keys())
    n = len(tids)
    dist = np.ones((n, n))
    np.fill_diagonal(dist, np.inf)
    for i in range(n):
        for j in range(i + 1, n):
            d = get_distance(tracklets[tids[i]], tracklets[tids[j]])
            dist[i, j] = dist[j, i] = d

    while True:
        if dist.size == 0 or dist.min() >= merge_dist_thres:
            break
        ia, ib = np.unravel_index(np.argmin(dist), dist.shape)
        ta, tb = tracklets[tids[ia]], tracklets[tids[ib]]
        if set(ta.times) & set(tb.times) or not check_spatial_constraints(
            ta, tb, max_x_range, max_y_range
        ):
            dist[ia, ib] = dist[ib, ia] = merge_dist_thres
            continue
        ta.merge_from(tb)
        del tracklets[tids[ib]]
        dist = np.delete(np.delete(dist, ib, axis=0), ib, axis=1)
        if ib < ia:
            ia -= 1
        tids = list(tracklets.keys())
        for k in range(dist.shape[0]):
            if k == ia:
                dist[k, k] = np.inf
            else:
                d = get_distance(tracklets[tids[ia]], tracklets[tids[k]])
                dist[ia, k] = dist[k, ia] = d
    return tracklets


def build_tracklets(mot_rows: np.ndarray, embs_per_frame) -> dict:
    """MOT rows (frame, id, x, y, w, h, conf, cls, det_ind) + per-frame
    embedding arrays -> {tid: Tracklet} (gta.py:1249-1340)."""
    out = {}
    for row in mot_rows:
        frame, tid = int(row[0]), int(row[1])
        det_ind = int(row[8]) if len(row) > 8 else -1
        feat = None
        if 0 < frame <= len(embs_per_frame):
            embs = embs_per_frame[frame - 1]
            if 0 <= det_ind < len(embs):
                feat = embs[det_ind]
        if feat is None:
            continue
        trk = out.setdefault(tid, Tracklet(tid, [], [], [], [], []))
        trk.times.append(frame)
        trk.scores.append(float(row[6]))
        trk.bboxes.append([float(v) for v in row[2:6]])
        trk.classes.append(int(row[7]) if len(row) > 7 else 0)
        trk.features.append(np.asarray(feat, np.float32))
    return out


def tracklets_to_rows(tracklets: dict) -> np.ndarray:
    rows = []
    for tid, trk in tracklets.items():
        for i in range(len(trk.times)):
            rows.append(
                [
                    trk.times[i],
                    tid,
                    *trk.bboxes[i][:4],
                    trk.scores[i],
                    trk.classes[i],
                    -1,
                ]
            )
    rows = np.array(rows, float).reshape(-1, 9)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


class GTAPostprocessor(Postprocessor):
    """Offline split + connect over MOT files with embedding lookups.

    Needs an embedding source: a callable seq_name -> per-frame embedding
    list (e.g. wired to the generated caches).
    """

    name = "gta"

    def __init__(
        self,
        emb_source=None,
        use_split: bool = True,
        use_connect: bool = True,
        eps: float = 0.7,
        max_k: int = 3,
        min_samples: int = 10,
        len_thres: int = 100,
        spatial_factor: float = 1.0,
        merge_dist_thres: float = 0.4,
    ):
        self.emb_source = emb_source
        self.use_split = use_split
        self.use_connect = use_connect
        self.eps = eps
        self.max_k = max_k
        self.min_samples = min_samples
        self.len_thres = len_thres
        self.spatial_factor = spatial_factor
        self.merge_dist_thres = merge_dist_thres

    def __call__(self, rows, embs_per_frame=None):
        tracklets = build_tracklets(rows, embs_per_frame or [])
        if not tracklets:
            return rows
        if self.use_split:
            tracklets = split_tracklets(
                tracklets,
                eps=self.eps,
                max_k=self.max_k,
                min_samples=self.min_samples,
                len_thres=self.len_thres,
            )
        if self.use_connect:
            mx, my = get_spatial_constraints(tracklets, self.spatial_factor)
            tracklets = merge_tracklets(tracklets, self.merge_dist_thres, mx, my)
        return tracklets_to_rows(tracklets)

    def run(self, mot_results_folder: Path):
        if self.emb_source is None:
            raise ValueError("GTA needs an emb_source: seq_name -> per-frame embs")
        for path in sorted(Path(mot_results_folder).glob("*.txt")):
            rows = np.loadtxt(path, delimiter=",", ndmin=2)
            if rows.size == 0:
                continue
            out = self(rows, self.emb_source(path.stem))
            np.savetxt(path, out, fmt="%d,%d,%d,%d,%d,%d,%.6f,%d,%d")


def gta(mot_results_folder, emb_source, **kwargs):
    GTAPostprocessor(emb_source=emb_source, **kwargs).run(mot_results_folder)
