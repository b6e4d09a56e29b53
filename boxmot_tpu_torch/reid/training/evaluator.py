"""ReID ranking evaluation: CMC / mAP with optional k-reciprocal re-ranking.

Counterpart of ``boxmot_tpu/reid/training/evaluator.py``.  The numpy half
(``compute_distance_matrix``, ``evaluate_rank``, ``re_ranking``) is a copy
of the original's.  ``extract_features`` runs the port's backbone (a
module that carries its weights, in eval mode) on ``device`` over the
dataset's crops, in batches of 32, with ``flip_tta`` averaging the
horizontally flipped crops' features; the JAX function pads the last batch
for its compile cache, which eager PyTorch does not need.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_distance_matrix(qf: np.ndarray, gf: np.ndarray, metric: str = "cosine"):
    if metric == "cosine":
        qn = qf / np.clip(np.linalg.norm(qf, axis=1, keepdims=True), 1e-12, None)
        gn = gf / np.clip(np.linalg.norm(gf, axis=1, keepdims=True), 1e-12, None)
        return 1.0 - qn @ gn.T
    if metric == "euclidean":
        q2 = np.sum(qf**2, axis=1)[:, None]
        g2 = np.sum(gf**2, axis=1)[None, :]
        return np.sqrt(np.clip(q2 + g2 - 2 * qf @ gf.T, 0, None))
    raise ValueError(f"unknown metric {metric!r}")


def evaluate_rank(
    distmat: np.ndarray,
    q_pids,
    g_pids,
    q_camids,
    g_camids,
    max_rank: int = 50,
):
    """Market-1501 protocol CMC + mAP (evaluator.py:65-137)."""
    q_pids = np.asarray(q_pids)
    g_pids = np.asarray(g_pids)
    q_camids = np.asarray(q_camids)
    g_camids = np.asarray(g_camids)
    num_q, num_g = distmat.shape
    max_rank = min(max_rank, num_g)
    indices = np.argsort(distmat, axis=1)

    all_cmc, all_ap = [], []
    for qi in range(num_q):
        order = indices[qi]
        # exclude same-pid same-cam gallery entries
        remove = (g_pids[order] == q_pids[qi]) & (g_camids[order] == q_camids[qi])
        keep = ~remove
        matches = (g_pids[order] == q_pids[qi])[keep].astype(np.int32)
        if not matches.any():
            continue  # query has no valid gallery match
        cmc = matches.cumsum()
        cmc = (cmc >= 1).astype(np.float32)
        all_cmc.append(cmc[:max_rank])
        # average precision
        num_rel = matches.sum()
        prec = matches.cumsum() / (np.arange(len(matches)) + 1)
        all_ap.append(float((prec * matches).sum() / num_rel))

    if not all_cmc:
        return np.zeros(max_rank), 0.0
    cmc = np.stack(
        [np.pad(c, (0, max_rank - len(c)), constant_values=c[-1] if len(c) else 0) for c in all_cmc]
    ).mean(axis=0)
    return cmc, float(np.mean(all_ap))


def re_ranking(distmat_qg, distmat_qq, distmat_gg, k1=20, k2=6, lambda_value=0.3):
    """k-reciprocal encoding re-ranking (Zhong et al., CVPR 2017;
    evaluator.py:138-200)."""
    nq = distmat_qq.shape[0]
    ng = distmat_gg.shape[0]
    original = np.concatenate(
        [
            np.concatenate([distmat_qq, distmat_qg], axis=1),
            np.concatenate([distmat_qg.T, distmat_gg], axis=1),
        ],
        axis=0,
    ).astype(np.float32)
    original = original / np.maximum(original.max(), 1e-12)
    V = np.zeros_like(original)
    n = nq + ng
    ranks = np.argsort(original, axis=1)

    for i in range(n):
        forward_k = ranks[i, : k1 + 1]
        backward = ranks[forward_k, : k1 + 1]
        fi = np.where(backward == i)[0]
        k_recip = forward_k[fi]
        # expand with half-k reciprocal neighbors
        expanded = k_recip.copy()
        for cand in k_recip:
            ck = ranks[cand, : int(np.around(k1 / 2)) + 1]
            cb = ranks[ck, : int(np.around(k1 / 2)) + 1]
            cfi = np.where(cb == cand)[0]
            cand_recip = ck[cfi]
            if len(np.intersect1d(cand_recip, k_recip)) > 2 / 3 * len(cand_recip):
                expanded = np.append(expanded, cand_recip)
        expanded = np.unique(expanded)
        weight = np.exp(-original[i, expanded])
        V[i, expanded] = weight / weight.sum()

    if k2 != 1:
        V = np.stack([V[ranks[i, :k2]].mean(axis=0) for i in range(n)])

    inv_index = [np.where(V[:, j] != 0)[0] for j in range(n)]
    jaccard = np.zeros((nq, n), np.float32)
    for i in range(nq):
        mins = np.zeros(n, np.float32)
        nz_i = np.where(V[i] != 0)[0]
        for j in nz_i:
            rows = inv_index[j]
            mins[rows] += np.minimum(V[i, j], V[rows, j])
        jaccard[i] = 1 - mins / (2 - mins)

    final = jaccard * (1 - lambda_value) + original[:nq] * lambda_value
    return final[:, nq:]


@torch.no_grad()
def extract_features(model, items, hw=(256, 128), batch_size: int = 32, flip_tta: bool = False,
                     device=None):
    """The backbone over dataset items -> (feats, pids, camids) as numpy."""
    from boxmot_tpu_torch.reid.datasets import load_image, standardize  # noqa: PLC0415

    first = next(model.parameters())
    device = first.device if device is None else torch.device(device)
    model = model.eval().to(device)
    feats, pids, camids = [], [], []
    for i in range(0, len(items), batch_size):
        chunk = items[i:i + batch_size]
        batch = standardize(np.stack([load_image(p, hw) for p, _, _ in chunk]))
        x = torch.from_numpy(batch).permute(0, 3, 1, 2).contiguous().to(device, first.dtype)
        out = model(x)
        if flip_tta:
            out = (out + model(torch.flip(x, dims=[3]))) / 2.0
        feats.append(out.float().cpu().numpy())
        pids.extend(p for _, p, _ in chunk)
        camids.extend(c for _, _, c in chunk)
    return np.concatenate(feats), np.asarray(pids), np.asarray(camids)


def evaluate_reid(model, dataset, hw=(256, 128), rerank: bool = False, flip_tta: bool = False,
                  device=None) -> dict:
    """rank-1, rank-5 and mAP of ``model`` on ``dataset``'s query and gallery."""
    qf, q_pids, q_cams = extract_features(model, dataset.query, hw, flip_tta=flip_tta,
                                          device=device)
    gf, g_pids, g_cams = extract_features(model, dataset.gallery, hw, flip_tta=flip_tta,
                                          device=device)
    dist = compute_distance_matrix(qf, gf)
    if rerank:
        dist = re_ranking(dist, compute_distance_matrix(qf, qf), compute_distance_matrix(gf, gf))
    cmc, mAP = evaluate_rank(dist, q_pids, g_pids, q_cams, g_cams)
    return {"rank1": float(cmc[0]), "rank5": float(cmc[min(4, len(cmc) - 1)]), "mAP": mAP}
