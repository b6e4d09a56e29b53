"""The one traffic generator: every mix is a data file under ``traffic/``
whose ``kind`` picks the function here and whose other keys are its
parameters.  Everything is drawn from ``--seed`` with numpy's PCG64, so a
seed gives the same traffic on every machine.  The counts that set the
work (players, rows, sequences, frames) are the same multiset for every
seed, dealt in another order, so that seeds change the content and not the
amount of work.  (Patterns: ``chip_smoke.py``'s seeded textured frames and
``boxmot_tpu_torch/data/synth.py``'s moving boxes; copied, not imported.)
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def _dealt(values: list[int], n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` counts cycling through ``values``, shuffled: one multiset for
    every seed."""
    return rng.permutation(np.resize(np.asarray(values, np.int64), n))


def _unit(x: np.ndarray) -> np.ndarray:
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _texture(rng, h: int, w: int, cell: int, base, spread: float) -> np.ndarray:
    """(h, w, 3) float32: a colour ``base`` with blocky noise of ``cell``-pixel
    cells and fine per-pixel grain."""
    coarse = rng.normal(0.0, spread, ((h + cell - 1) // cell, (w + cell - 1) // cell, 3))
    img = np.repeat(np.repeat(coarse, cell, 0), cell, 1)[:h, :w]
    return (img + np.asarray(base, np.float32) + rng.normal(0.0, spread / 3, (h, w, 3))).astype(
        np.float32)


def live_frames(p: dict, seed: int) -> list[np.ndarray]:
    """``p["pool_frames"]`` consecutive (height, width, 3) uint8 BGR frames of
    ``p["players"]`` textured players moving on a textured pitch with lines,
    the camera panning slowly: the pool a live run cycles through in order."""
    rng = _rng(seed, 1)
    H, W, n = int(p["height"]), int(p["width"]), int(p["pool_frames"])
    margin = 64
    pitch = _texture(rng, H + 2 * margin, W + 2 * margin, 16, (60, 130, 70), 18.0)
    for x in range(0, W + 2 * margin, int(p["line_spacing"])):
        pitch[:, x:x + 3] = 235.0
    pitch[(H + 2 * margin) // 2:(H + 2 * margin) // 2 + 3] = 235.0
    k = int(p["players"])
    ph = rng.uniform(*p["player_height"], k)
    pw = ph * rng.uniform(*p["aspect"], k)
    pos = np.stack([rng.uniform(0, W - pw), rng.uniform(0, H - ph)], 1)
    vel = rng.normal(0.0, p["speed"], (k, 2))
    kits = [_texture(rng, int(h) + 1, int(w) + 1, 6, rng.uniform(20, 235, 3), 25.0)
            for h, w in zip(ph, pw)]
    frames = []
    for f in range(n):
        cam = np.array([np.sin(f / 40.0), np.cos(f / 55.0)]) * margin * 0.9 + margin
        x0, y0 = int(cam[0]), int(cam[1])
        img = pitch[y0:y0 + H, x0:x0 + W].copy()
        for i in range(k):
            x, y = int(pos[i, 0]), int(pos[i, 1])
            kit = kits[i]
            img[max(y, 0):y + kit.shape[0], max(x, 0):x + kit.shape[1]] = kit[
                max(-y, 0):H - y, max(-x, 0):W - x]
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
        vel = 0.9 * vel + rng.normal(0.0, p["speed"] * 0.3, (k, 2))
        pos += vel
        lim = np.stack([W - pw, H - ph], 1)
        vel = np.where((pos < 0) | (pos > lim), -vel, vel)
        pos = np.clip(pos, 0, lim)
    return frames


def replay_sequences(p: dict, seed: int) -> list[dict]:
    """``p["sequences"]`` cached-detection sequences of ``p["frames"]`` frames,
    as ``engine.replay.replay_sequences_outputs`` takes them: per frame (N, 6)
    [x1, y1, x2, y2, conf, cls] float32 rows and (N, feat_dim) unit
    embeddings, and an (F, 2, 3) camera warp a frame.

    Each sequence has its players (a count dealt from ``p["players"]``) in
    ``teams`` teams, each player with a unit embedding of its own that shares
    ``team_share`` of its square with its team's (players in one kit look
    alike, SportsMOT's difficulty), starting within ``spread`` of the frame
    around a ball that wanders, and pulled towards it (``pull``), so that
    players crowd, cross and occlude each other; a detected player's row is
    its box with noise and its embedding with noise, renormalized.  Players are missed
    (``miss``), occluded to a low confidence (``low_conf_share``, drawn in
    ``low_conf``) and joined by clutter rows (``clutter`` a frame, low
    confidence, random boxes and embeddings); rows are shuffled and at most
    ``max_rows`` a frame, and one frame of each sequence is filled to
    ``max_rows`` with clutter, so that every sequence falls into the same
    (frames, ``max_rows``) bucket.  The camera pans a little every frame and
    the boxes move with it; the warp maps the previous frame's coordinates to
    this frame's."""
    rng = _rng(seed, 2)
    S, F, D, E = (int(p[k]) for k in ("sequences", "frames", "max_rows", "feat_dim"))
    W, H = float(p["width"]), float(p["height"])
    players = _dealt(list(range(p["players"][0], p["players"][1] + 1)), S, rng)
    seqs = []
    for s in range(S):
        k = int(players[s])
        kits = _unit(rng.standard_normal((p["teams"], E), dtype=np.float32))
        own = _unit(rng.standard_normal((k, E), dtype=np.float32))
        share = np.float32(p["team_share"])
        ident = _unit(np.sqrt(share) * kits[np.arange(k) % p["teams"]] + np.sqrt(1 - share) * own)
        ph = rng.uniform(*p["player_height"], k)
        pw = ph * rng.uniform(*p["aspect"], k)
        ball = np.array([rng.uniform(0.3, 0.7) * W, rng.uniform(0.3, 0.7) * H])
        spread = np.array([W, H]) * p["spread"]
        pos = np.clip(ball + rng.uniform(-0.5, 0.5, (k, 2)) * spread - np.stack([pw, ph], 1) / 2,
                      0, np.stack([W - pw, H - ph], 1))
        vel = rng.normal(0.0, p["speed"], (k, 2))
        full = int(rng.integers(F))
        dets, embs, warps = [], [], np.zeros((F, 2, 3), np.float32)
        for f in range(F):
            pan = rng.normal(0.0, p["pan"], 2)
            lin = np.eye(2) + rng.normal(0.0, p["warp_jitter"], (2, 2))
            warps[f] = np.concatenate([lin, -pan[:, None]], 1)
            seen = rng.random(k) >= p["miss"]
            low = rng.random(k) < p["low_conf_share"]
            conf = np.where(low, rng.uniform(*p["low_conf"], k), rng.uniform(*p["high_conf"], k))
            noise = rng.normal(0.0, p["box_noise"], (k, 4)) * np.stack([pw, ph, pw, ph], 1)
            boxes = np.concatenate([pos, pos + np.stack([pw, ph], 1)], 1) + noise
            e = ident + rng.standard_normal((k, E), dtype=np.float32) * np.float32(
                p["emb_noise"] / np.sqrt(E))
            n_clut = D - int(seen.sum()) if f == full else int(rng.integers(0, p["clutter"] + 1))
            n_clut = min(n_clut, D - int(seen.sum()))
            cw = rng.uniform(*p["player_height"], n_clut) * rng.uniform(*p["aspect"], n_clut)
            ch = cw / rng.uniform(*p["aspect"], n_clut)
            cxy = np.stack([rng.uniform(0, W - cw), rng.uniform(0, H - ch)], 1)
            rows = np.concatenate([
                np.concatenate([boxes[seen], conf[seen, None]], 1),
                np.concatenate([cxy, cxy + np.stack([cw, ch], 1),
                                rng.uniform(*p["clutter_conf"], n_clut)[:, None]], 1)])
            emb = np.concatenate([e[seen], rng.standard_normal((n_clut, E), dtype=np.float32)])
            order = rng.permutation(len(rows))
            rows = np.concatenate([rows, np.zeros((len(rows), 1))], 1)[order].astype(np.float32)
            emb = emb[order]
            dets.append(rows)
            embs.append(_unit(emb))
            ball = np.clip(ball + rng.normal(0.0, p["speed"], 2), [0, 0], [W, H])
            centre = pos + np.stack([pw, ph], 1) / 2
            vel = (0.9 * vel + rng.normal(0.0, p["speed"] * 0.3, (k, 2))
                   + p["pull"] * (ball - centre))
            pos = pos + vel - pan
            lim = np.stack([W - pw, H - ph], 1)
            vel = np.where((pos < 0) | (pos > lim), -vel, vel)
            pos = np.clip(pos, 0, lim)
        seqs.append({"dets": dets, "embs": embs, "warps": warps})
    return seqs


KINDS = {"live_frames": live_frames, "replay_sequences": replay_sequences}


def make(traffic: dict, seed: int):
    """The traffic of a mix file's parameters and a seed."""
    return KINDS[traffic["kind"]](traffic["params"], seed)
