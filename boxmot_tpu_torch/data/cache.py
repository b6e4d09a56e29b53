"""Detection, embedding, warp and mask cache paths and per-frame loading.

The port's own copy of ``det_cache_path``, ``emb_cache_path``,
``load_cached_dets_per_frame``, ``load_cached_embs_per_frame``,
``warp_cache_path``, ``load_cached_warps_per_frame``, ``mask_cache_path``,
``pack_masks``, ``unpack_masks`` and ``load_cached_masks_per_frame`` from
``boxmot_tpu/data/cache.py``, unchanged.  The cache layout is the
reference's

    <root>/<detector>/dets/<seq>.npy                       (frame, x1, y1, x2, y2, conf, cls)
    <root>/<detector>/embs/<reid>/<preprocess>/<seq>.npy   (frame, feature...)
    <root>/warps/<cmc_method>/<seq>.npy                    (frame, w00, w01, w02, w10, w11, w12)
    <root>/<detector>/masks/seg/<seq>.npy                  (frame, bit-packed 160 x 160 mask)

with the embedding rows aligned row for row with the detection rows.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def det_cache_path(root: Path, detector: str, seq: str) -> Path:
    return Path(root) / detector / "dets" / f"{seq}.npy"


def emb_cache_path(root: Path, detector: str, reid: str, seq: str,
                   preprocess: str = "resize") -> Path:
    """Copy of ``boxmot_tpu.data.cache.emb_cache_path``."""
    return Path(root) / detector / "embs" / reid / preprocess / f"{seq}.npy"


def load_cached_dets_per_frame(path: Path, n_frames: int):
    """(N, 7) [frame, x1, y1, x2, y2, conf, cls] cache -> per-frame list."""
    rows = np.load(path)
    out = [np.zeros((0, 6), np.float32) for _ in range(n_frames)]
    if rows.size == 0:
        return out
    frames = rows[:, 0].astype(int)
    for f in range(1, n_frames + 1):
        sel = rows[frames == f]
        if len(sel):
            out[f - 1] = sel[:, 1:7].astype(np.float32)
    return out


def load_cached_embs_per_frame(path: Path, n_frames: int):
    """(N, 1 + F) cache -> per-frame list of (Ni, F) embeddings (copy of
    ``boxmot_tpu.data.cache.load_cached_embs_per_frame``)."""
    rows = np.load(path)
    feat = rows.shape[1] - 1 if rows.size else 1
    out = [np.zeros((0, feat), np.float32) for _ in range(n_frames)]
    if rows.size == 0:
        return out
    frames = rows[:, 0].astype(int)
    for f in range(1, n_frames + 1):
        sel = rows[frames == f]
        if len(sel):
            out[f - 1] = sel[:, 1:].astype(np.float32)
    return out


def warp_cache_path(root: Path, cmc_method: str, seq: str) -> Path:
    """Camera-motion warp cache: one (2, 3) affine warp per frame (copy of
    ``boxmot_tpu.data.cache.warp_cache_path``)."""
    return Path(root) / "warps" / cmc_method / f"{seq}.npy"


def load_cached_warps_per_frame(path: Path, n_frames: int) -> np.ndarray:
    """(N, 7) [frame, w00, w01, w02, w10, w11, w12] cache -> (n_frames, 2, 3)
    float32 warps; frames missing from the cache get the identity (copy of
    ``boxmot_tpu.data.cache.load_cached_warps_per_frame``)."""
    rows = np.load(path)
    out = np.broadcast_to(np.eye(2, 3, dtype=np.float32), (n_frames, 2, 3)).copy()
    if rows.size == 0:
        return out
    frames = rows[:, 0].astype(int)
    keep = (frames >= 1) & (frames <= n_frames)
    out[frames[keep] - 1] = rows[keep, 1:7].astype(np.float32).reshape(-1, 2, 3)
    return out


def mask_cache_path(root: Path, detector: str, seq: str) -> Path:
    """Segmentation mask cache aligned row-for-row with the det cache
    (reference layout: <root>/<detector>/masks/seg/<seq>.npy,
    cache.py:468)."""
    return Path(root) / detector / "masks" / "seg" / f"{seq}.npy"


MASK_SIDE = 160  # cached mask resolution (reference cache.py:936: 160x160)
_MASK_PACKED = MASK_SIDE * (MASK_SIDE // 8) + 1  # + frame column


def pack_masks(frame: int, masks: np.ndarray) -> np.ndarray:
    """(N, H, W) binary masks -> (N, 1 + 160*20) float32 rows: frame id
    followed by the bit-packed 160x160 downsample (cache.py:930-943)."""
    masks = np.asarray(masks)
    n = masks.shape[0]
    if n == 0:
        return np.zeros((0, _MASK_PACKED), np.float32)
    small = np.empty((n, MASK_SIDE, MASK_SIDE), np.uint8)
    H, W = masks.shape[1:3]
    ys = (np.arange(MASK_SIDE) * (H / MASK_SIDE)).astype(int).clip(0, H - 1)
    xs = (np.arange(MASK_SIDE) * (W / MASK_SIDE)).astype(int).clip(0, W - 1)
    for i in range(n):
        small[i] = (masks[i][np.ix_(ys, xs)] > 0).astype(np.uint8)
    packed = np.packbits(small, axis=-1).reshape(n, -1)
    rows = np.empty((n, _MASK_PACKED), np.float32)
    rows[:, 0] = frame
    rows[:, 1:] = packed
    return rows


def unpack_masks(rows: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Packed rows -> (N, H, W) bool masks upsampled to the frame size."""
    rows = np.asarray(rows)
    n = rows.shape[0]
    H, W = hw
    if n == 0:
        return np.zeros((0, H, W), bool)
    packed = rows[:, 1:].astype(np.uint8).reshape(n, MASK_SIDE, MASK_SIDE // 8)
    small = np.unpackbits(packed, axis=-1)[:, :, :MASK_SIDE]
    ys = (np.arange(H) * (MASK_SIDE / H)).astype(int).clip(0, MASK_SIDE - 1)
    xs = (np.arange(W) * (MASK_SIDE / W)).astype(int).clip(0, MASK_SIDE - 1)
    return small[:, ys][:, :, xs].astype(bool)


def load_cached_masks_per_frame(path: Path, n_frames: int, hw: tuple[int, int]):
    """Mask cache -> per-frame list of (Ni, H, W) bool masks, row-aligned
    with the detection cache."""
    rows = np.load(path)
    out = [np.zeros((0, *hw), bool) for _ in range(n_frames)]
    if rows.size == 0:
        return out
    frames = rows[:, 0].astype(int)
    for f in range(1, n_frames + 1):
        sel = rows[frames == f]
        if len(sel):
            out[f - 1] = unpack_masks(sel, hw)
    return out
