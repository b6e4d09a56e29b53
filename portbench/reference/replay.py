"""The plain reference of a replay cell: the sequences packed into padded
(S, F, D, ...) arrays (the buckets of ``boxmot_tpu_torch/engine/replay.py``)
and the tracker's step (a frozen copy, its plain path: no kernel of the
port) run over every frame of all sequences in lockstep."""

from __future__ import annotations

import numpy as np
import torch

from portbench import products
from portbench.reference import trackers

FRAME_BUCKETS = (64, 128, 256, 512, 1024, 2048)
DET_BUCKETS = (8, 16, 32, 64, 128, 256)


def bucket(n: int, buckets) -> int:
    return next(b for b in buckets if n <= b)


def pack(seqs: list[dict], feat_dim: int):
    """(dets (S, F, D, 7) [x1, y1, x2, y2, conf, cls, row index], padding a
    unit box with conf -1; embs (S, F, D, feat_dim), zero padding; warps (S,
    F, 2, 3), the identity after a sequence's own; frames of each)."""
    n_frames = [len(s["dets"]) for s in seqs]
    F = bucket(max(n_frames), FRAME_BUCKETS)
    D = bucket(max(max(len(d) for d in s["dets"]) for s in seqs), DET_BUCKETS)
    S = len(seqs)
    dets = np.zeros((S, F, D, 7), np.float32)
    dets[..., 2:4] = 1.0
    dets[..., 4] = -1.0
    embs = np.zeros((S, F, D, feat_dim), np.float32)
    warps = np.broadcast_to(np.eye(2, 3, dtype=np.float32), (S, F, 2, 3)).copy()
    for s, seq in enumerate(seqs):
        for f, d in enumerate(seq["dets"]):
            dets[s, f, :len(d), :6] = d[:, :6]
            dets[s, f, :len(d), 6] = np.arange(len(d))
            embs[s, f, :len(d)] = seq["embs"][f]
        warps[s, :len(seq["warps"])] = seq["warps"]
    return dets, embs, warps, n_frames


def replay(cfg: dict, seqs: list[dict], device, record_oru: list | None = None,
           record_products: tuple | None = None):
    """(outs (S, n, K, 8), masks (S, n, K), lap_capped (S,)) on the host of
    every sequence, n the longest sequence's frames.  With ``record_oru``,
    each call of the ORU appends its layout's (dx, dz, name) and its rejoin
    and gap as host arrays (the inputs K4's work is counted from).  With
    ``record_products`` (steps, kept), the ``torch.bmm`` results of those
    steps go to ``kept[step]`` (``portbench/products.py``)."""
    name = cfg["tracker"]["name"]
    config, init_state, step = trackers.resolve(name)
    tcfg = config(**cfg["tracker"]["params"])
    dets, embs, warps, n_frames = pack(seqs, tcfg.feat_dim)
    dets, embs, warps = (torch.from_numpy(a).to(device) for a in (dets, embs, warps))
    S, n = dets.shape[0], max(n_frames)
    module = __import__(f"portbench.reference.frozen.trackers.{name}", fromlist=["_"])
    real = getattr(module, "oru_replay", None)
    if record_oru is not None and real is not None:
        def recording(layout, mean, cov, fm, fc, lm, z2, rejoin, gap, replayed):
            record_oru.append(((layout.dx, layout.dz, layout.name), rejoin.cpu().numpy(),
                               gap.cpu().numpy()))
            return real(layout, mean, cov, fm, fc, lm, z2, rejoin, gap, replayed)
        module.oru_replay = recording
    try:
        state = init_state(tcfg, S, device)
        if record_products is not None:
            step = products.recording(step, *record_products)
        valid = dets[..., 4] >= 0.0
        outs, masks = [], []
        with torch.no_grad():
            for f in range(n):
                state, out, mask = step(tcfg, state, dets[:, f], valid[:, f], embs[:, f],
                                        warps[:, f])
                outs.append(out)
                masks.append(mask)
        return (torch.stack(outs, 1).cpu().numpy(), torch.stack(masks, 1).cpu().numpy(),
                state.lap_capped.cpu().numpy())
    finally:
        if real is not None:
            module.oru_replay = real

