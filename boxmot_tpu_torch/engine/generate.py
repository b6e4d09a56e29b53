"""Cache generation: detections, segmentation masks, embeddings and warps.

Counterpart of ``boxmot_tpu/engine/generate.py`` (``load_frame``,
``_generate_dets``, ``_fill_embeddings``, ``_fill_warps``,
``run_generate``), which mirrors the reference generate workflow
(boxmot/engine/eval/cache.py:434-1328).  For each sequence it writes a
resumable detection cache (from a detector backend, or the public det.txt
rows as detector "public"); when the detector returns instance masks, a
bit-packed mask cache row for row with the detections; with a ReID model,
an embedding cache aligned with the *cached* detection rows (so an
embeddings-only re-run fills the embeddings of an existing det cache
without detecting again); and with ``cmc_method``, one camera-motion warp
a frame.  Every cache resumes at frame granularity.  The caches are the
ones the port's ``run_eval`` and the JAX package's read.

The models run where the caller built them: a detector and ``ReID`` on the
card unless asked for the CPU (the yololite predictor runs NMS as kernel
K6, ``ReID`` cuts its crops with kernel K5), and ECC on ``device``.  Three
departures from the JAX function, each where it misleads or fails:
``frame_group > 1`` with ``batch_size`` set warns that the grouping is off
(the JAX package ignores the grouping without a word; the caches are the
same); a detector that returns oriented boxes raises a ``ValueError``
before anything is written (the JAX writer reshapes their 8 columns into
7 and raises, or writes garbled rows when the count divides); and an
embeddings-only fill leaves a named detector's det cache as it is (the JAX
function appends the public det.txt rows to it where it holds fewer).
"""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
import torch

from boxmot_tpu_torch.data.cache import (
    _MASK_PACKED,
    AppendableNpyWriter,
    det_cache_path,
    emb_cache_path,
    load_cached_dets_per_frame,
    mask_cache_path,
    pack_masks,
    warp_cache_path,
)
from boxmot_tpu_torch.data.frame_cache import FrameCache, read_frame
from boxmot_tpu_torch.data.mot import MOTDataset
from boxmot_tpu_torch.engine.results import GenerateResult
from boxmot_tpu_torch.motion.cmc import create_cmc
from boxmot_tpu_torch.utils.autobatch import AutoBatcher
from boxmot_tpu_torch.utils.callbacks import safe_seq_progress_callback


def load_frame(path: Path) -> np.ndarray:
    """Read an image as BGR uint8 (the tracker-facing convention), through
    the one shared decoder, so cache hits and disk reads agree (``.npy``
    frames of OBB layouts too)."""
    return read_frame(Path(path))


def _generate_dets(
    seq, dpath, detector_model, mpath=None, read=load_frame, progress=None,
):
    """Detector-driven det (+ optional packed-mask) caches, resumable at
    frame granularity: rows for frame f are written only once all rows of
    frames < f are present.  Oriented detections raise before a write."""
    n_frames = min(seq.seq_length, len(seq.img_paths))
    writer = mask_writer = None
    # Find the resume frame by replaying the cached frame column.
    start_frame = 0
    if dpath.exists():
        cached = np.load(dpath, mmap_mode="r")
        start_frame = int(cached[:, 0].max()) if len(cached) else 0
        del cached
    for f in range(start_frame, n_frames):
        img = read(seq.img_paths[f])
        result = detector_model(img)
        dets = result.as_dets()
        if getattr(result, "is_obb", False) or (len(dets) and dets.shape[1] != 6):
            raise ValueError(
                f"{seq.name} frame {f + 1}: the detector returned oriented boxes "
                f"({dets.shape[1]} columns a detection); the detection cache holds "
                "axis-aligned (frame, x1, y1, x2, y2, conf, cls) rows only")
        rows = np.column_stack(
            [np.full(len(dets), f + 1, np.float32), dets]
        ) if len(dets) else np.zeros((0, 7), np.float32)
        if writer is None:
            writer = AppendableNpyWriter(dpath, 7)
        writer.append(rows)
        if getattr(result, "masks", None) is not None:
            if mask_writer is None and mpath is not None:
                mask_writer = AppendableNpyWriter(mpath, _MASK_PACKED)
            if mask_writer is not None:
                mask_writer.append(pack_masks(f + 1, result.masks))
        if progress is not None:
            progress(seq.name, f + 1, n_frames)
    if writer is None:
        writer = AppendableNpyWriter(dpath, 7)
    writer.close()
    if mask_writer is not None:
        mask_writer.close()
    return writer.rows


def _fill_embeddings(
    seq, dets_per_frame, epath, reid_model, frame_cache=True, progress=None,
    batch_size: int = 0, auto_batch: bool = True, frame_group: int = 1,
):
    """Embedding cache aligned row-for-row with dets_per_frame (which may
    come from det.txt or from an existing det cache).

    ``frame_group > 1`` sends that many frames' crops through one backbone
    batch (``ReID.get_features_multi``); a crop's feature is the same
    either way, within the backbone's rounding.  With ``batch_size`` the
    frames go one by one through the ``AutoBatcher`` instead, and a
    ``frame_group`` above 1 warns.
    """
    n_total = sum(len(d) for d in dets_per_frame)
    feat = reid_model.feature_dim
    ew = AppendableNpyWriter(epath, 1 + feat)
    cache = (
        FrameCache(list(seq.img_paths), fallback=load_frame)
        if frame_cache and ew.rows < n_total
        else None
    )
    read = cache.read_image if cache is not None else load_frame
    batcher = AutoBatcher(batch_size, auto=auto_batch) if batch_size else None
    if frame_group > 1 and batcher is not None:
        warnings.warn(f"frame_group={frame_group} is ignored when batch_size is set "
                      f"({batch_size}): the frames are embedded one by one", stacklevel=3)
    done_rows = ew.rows
    acc = 0

    def _write(f, d, feats):
        nonlocal acc, done_rows
        start = max(done_rows - acc, 0)
        rows = np.column_stack(
            [np.full(len(d) - start, f + 1, np.float32), feats[start:]]
        )
        ew.append(rows)
        acc += len(d)
        done_rows = ew.rows
        if progress is not None:
            progress(seq.name, f + 1, len(dets_per_frame))

    group: list[tuple[int, np.ndarray]] = []

    def _flush_group():
        if not group:
            return
        imgs = [read(seq.img_paths[f]) for f, _ in group]
        feats_list = reid_model.get_features_multi(
            [d[:, :4] for _, d in group], imgs
        )
        for (f, d), feats in zip(group, feats_list):
            _write(f, d, feats)
        group.clear()

    for f, d in enumerate(dets_per_frame):
        if len(d) == 0:
            continue
        if acc + len(d) <= done_rows:
            acc += len(d)
            continue
        if f >= len(seq.img_paths):
            break
        if (
            frame_group > 1
            and batcher is None
            and hasattr(reid_model, "get_features_multi")
            and done_rows <= acc  # group only fully-uncached frames
        ):
            group.append((f, d))
            if len(group) >= frame_group:
                _flush_group()
            continue
        img = read(seq.img_paths[f])
        boxes = d[:, :4]
        if batcher is not None:
            feats = batcher.map(lambda b: reid_model.get_features(b, img), boxes)
        else:
            feats = reid_model.get_features(boxes, img)
        _write(f, d, feats)
    _flush_group()
    ew.close()
    if cache is not None:
        cache.clear()
    return done_rows


def _fill_warps(seq, wpath, cmc, read=load_frame, progress=None):
    """Per-frame camera-motion warps, resumable at frame granularity; the
    estimator is sequential, so a resumed run re-primes it on the frames
    already cached."""
    writer = AppendableNpyWriter(wpath, 7)
    n_frames = min(seq.seq_length, len(seq.img_paths))
    start = writer.rows
    if start >= n_frames:
        writer.close()
        return start
    for f in range(n_frames):
        img = read(seq.img_paths[f])
        warp = cmc.apply(img)
        warp = warp.cpu().numpy() if torch.is_tensor(warp) else np.asarray(warp, np.float32)
        if f >= start:
            writer.append(
                np.concatenate([[np.float32(f + 1)], warp.ravel()])[None]
            )
        if progress is not None:
            progress(seq.name, f + 1, n_frames)
    writer.close()
    return n_frames


def _public_dets(dpath, dets_per_frame) -> int:
    """The public detections' cache, resumed row by row."""
    n_total = sum(len(d) for d in dets_per_frame)
    writer = AppendableNpyWriter(dpath, 7)
    if writer.rows < n_total:
        done = writer.rows
        acc = 0
        for f, d in enumerate(dets_per_frame):
            if acc + len(d) <= done:
                acc += len(d)
                continue
            start = max(done - acc, 0)
            rows = np.column_stack(
                [np.full(len(d) - start, f + 1, np.float32), d[start:]]
            )
            writer.append(rows)
            acc += len(d)
            done = writer.rows
    writer.close()
    return n_total


def run_generate(
    data_root: Path,
    cache_root: Path,
    detector: str = "public",
    detector_model=None,
    reid_model=None,
    reid_name: str | None = None,
    preprocess: str = "resize",
    verbose: bool = False,
    frame_cache: bool = True,
    progress=None,
    batch_size: int = 0,
    auto_batch: bool = True,
    frame_group: int = 1,
    cmc_method: str | None = None,
    device="cuda",
) -> GenerateResult:
    """Generate det / mask / emb / warp caches for every sequence.

    * ``detector_model``: a detector backend (``boxmot_tpu_torch.detectors``);
      when given, detections (and masks, for seg models) come from
      inference; otherwise the sequence's public det.txt rows are cached.
    * Embeddings-only fill: when the det cache already exists, the emb
      stage aligns to the *cached* rows, so ``run_generate(...,
      reid_model=m)`` on a det-cached tree fills embeddings without
      detecting again (reference cache.py:1024); without a
      ``detector_model`` the cache of a ``detector`` other than "public" is
      read, never extended.
    * ``batch_size``/``auto_batch``: ReID crop batching with OOM backoff
      (reference inference.py:332-388); 0 = one call per frame.
    * ``frame_group``: >1 batches that many frames' crops into one
      backbone batch (sparse-scene throughput; see _fill_embeddings).
    * ``cmc_method``: warps from ``motion/cmc.py::create_cmc``, ECC on
      ``device`` (the card unless the caller asks for the CPU).

    Returns {seq_name: {"dets": n_rows, "embs": n_rows, "masks": n_rows
    (, "warps": n_frames)}}.
    """
    progress = safe_seq_progress_callback(progress)
    dataset = MOTDataset(data_root)
    if len(dataset) == 0:
        raise ValueError(f"no MOT sequences under {data_root}")
    stats = {}
    for seq in dataset:
        dpath = det_cache_path(cache_root, detector, seq.name)
        mpath = mask_cache_path(cache_root, detector, seq.name)

        if detector_model is not None:
            n_rows = _generate_dets(
                seq, dpath, detector_model, mpath=mpath, progress=progress
            )
        elif detector != "public" and dpath.exists():
            # a named detector's cache, for an embeddings-only fill: left as
            # it is (the JAX function appends det.txt rows to it wherever it
            # holds fewer rows than det.txt)
            n_rows = int(np.load(dpath, mmap_mode="r").shape[0])
        else:
            n_rows = _public_dets(dpath, seq.dets_per_frame())
        stats[seq.name] = {
            "dets": n_rows,
            "embs": 0,
            "masks": int(np.load(mpath, mmap_mode="r").shape[0]) if mpath.exists() else 0,
        }

        if reid_model is not None:
            # Embeddings-only fill: align to the cached det rows (the det
            # cache always exists at this point), so a second pass over a
            # det-cached tree never detects again.
            dets_per_frame = load_cached_dets_per_frame(dpath, seq.seq_length)
            rname = reid_name or getattr(reid_model, "model_name", "reid")
            epath = emb_cache_path(cache_root, detector, rname, seq.name, preprocess)
            stats[seq.name]["embs"] = _fill_embeddings(
                seq, dets_per_frame, epath, reid_model,
                frame_cache=frame_cache, progress=progress,
                batch_size=batch_size, auto_batch=auto_batch,
                frame_group=frame_group,
            )
        if cmc_method:
            wpath = warp_cache_path(cache_root, cmc_method, seq.name)
            stats[seq.name]["warps"] = _fill_warps(
                seq, wpath, create_cmc(cmc_method, device=device), progress=progress
            )
        if verbose:
            print(f"generated {seq.name}: {stats[seq.name]}")
    return GenerateResult(stats)
