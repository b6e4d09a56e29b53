"""Benchmark evaluation: replay cached detections -> MOT rows -> metrics
(counterpart of the device branch and the host-tracker branch of
boxmot_tpu/engine/eval.py::run_eval).

Detections, ground truth and the HOTA/CLEAR/Identity metric stack are the
port's own copies of the JAX package's host modules (``data``,
``engine.metrics``, ``engine.mot_io``, ``engine.results``); the replay runs
on ``device``, the card unless the caller asks for the CPU.  sam2mot, a
host tracker in both packages, runs its per-frame ``update`` loop instead,
with segmentation masks from the mask cache when there is one.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from boxmot_tpu_torch.configs import get_tracker_defaults
from boxmot_tpu_torch.data.cache import (
    det_cache_path,
    emb_cache_path,
    load_cached_dets_per_frame,
    load_cached_embs_per_frame,
    load_cached_masks_per_frame,
    load_cached_warps_per_frame,
    mask_cache_path,
    warp_cache_path,
)
from boxmot_tpu_torch.data.mot import MOTDataset
from boxmot_tpu_torch.engine.metrics.mot_metrics import evaluate_sequences, preprocess_sequence
from boxmot_tpu_torch.engine.mot_io import convert_to_mot_format, write_mot_results
from boxmot_tpu_torch.engine.replay import replay_sequences_batched
from boxmot_tpu_torch.engine.results import ValidationResult
from boxmot_tpu_torch.trackers.boosttrack import BoostTrackConfig
from boxmot_tpu_torch.trackers.botsort import BotSortConfig
from boxmot_tpu_torch.trackers.bytetrack import ByteTrackConfig
from boxmot_tpu_torch.trackers.deepocsort import DeepOcSortConfig
from boxmot_tpu_torch.trackers.hybridsort import HybridSortConfig
from boxmot_tpu_torch.trackers.occluboost import OccluBoostConfig
from boxmot_tpu_torch.trackers.ocsort import OcSortConfig
from boxmot_tpu_torch.trackers.sfsort import SFSortConfig
from boxmot_tpu_torch.trackers.strongsort import StrongSortConfig
from boxmot_tpu_torch.trackers.zoo import check_ported, create_tracker
from boxmot_tpu_torch.utils.device import resolve_device


_TRACKER_CONFIGS = {"bytetrack": ByteTrackConfig, "sfsort": SFSortConfig, "ocsort": OcSortConfig,
                    "botsort": BotSortConfig, "deepocsort": DeepOcSortConfig,
                    "boosttrack": BoostTrackConfig, "occluboost": OccluBoostConfig,
                    "strongsort": StrongSortConfig, "hybridsort": HybridSortConfig}


def build_replay_config(tracker_type: str, **params):
    """Replay config from the YAML tier + explicit overrides, merged by field
    name as in the JAX package.  The YAML keys that are not config fields
    (ByteTrack's and BoT-SORT's ``track_buffer`` and ``frame_rate``, SFSORT's
    margins, OC-SORT's and DeepOCSORT's ``Q_xy_scaling`` and ``Q_s_scaling``,
    DeepOCSORT's ``iou_thresh``, BoT-SORT's, BoostTrack's and OccluBoost's
    ``use_cmc`` and ``cmc_method``, OccluBoost's ``gta_smooth_tau``) are dropped, so
    the ByteTrack replay keeps the config defaults ``det_thresh`` 0.45 and
    ``max_time_lost`` 25, BoT-SORT's ``max_time_lost`` stays 30 and
    DeepOCSORT's ``iou_threshold`` 0.3, which the pinned metrics depend on.
    A host tracker (sam2mot) has no replay config: it raises, as in JAX."""
    check_ported(tracker_type)
    if tracker_type not in _TRACKER_CONFIGS:
        raise ValueError(f"No replay config for tracker {tracker_type!r}; "
                         f"available: {sorted(_TRACKER_CONFIGS)}")
    cfg_cls = _TRACKER_CONFIGS[tracker_type]
    merged = {**get_tracker_defaults(tracker_type), **params}
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    return cfg_cls(**{k: v for k, v in merged.items() if k in fields})


def run_eval(
    data_root: Path,
    tracker_type: str = "bytetrack",
    *,
    device="cuda",
    tracker_params: dict | None = None,
    output_dir: Path | None = None,
    min_det_conf: float | None = None,
    cache_root: Path | None = None,
    detector: str = "public",
    reid: str | None = None,
    preprocess: str = "resize",
    cmc_method: str | None = None,
    seq_names=None,
    verbose: bool = False,
) -> ValidationResult:
    """Evaluate a tracker over every sequence under ``data_root`` on ``device``.

    Detections come from each sequence's public det.txt or, when
    ``cache_root`` is given, from the generated detection cache; with
    ``reid`` the appearance trackers also read the embedding cache of that
    ReID model (and ``preprocess``), row-aligned with the detections, and
    without it ``with_reid`` defaults to False, as in the JAX ``run_eval``.
    ``cmc_method`` replays the cached camera-motion warps of that method
    (sequences without a warp file replay identities).  A host tracker
    (sam2mot) runs ``create_tracker(...).update`` frame by frame on the host,
    with each frame's masks from the mask cache under ``cache_root`` where
    there is one, as the JAX ``run_eval`` does.  Returns the metric
    dicts ({"per_seq": ..., "combined": ...}) with HOTA, MOTA, IDF1.
    """
    device = resolve_device(device)
    dataset = MOTDataset(data_root, names=seq_names)
    if len(dataset) == 0:
        raise ValueError(f"no MOT sequences found under {data_root}")
    tracker_params = dict(tracker_params or {})
    check_ported(tracker_type)
    host_tracker = tracker_type not in _TRACKER_CONFIGS
    if reid is None and not host_tracker:
        # no embedding cache: the appearance terms off
        tracker_params.setdefault("with_reid", False)
    cfg = None if host_tracker else build_replay_config(tracker_type, **tracker_params)
    # motion-only configs carry no feat_dim; their cached embeddings are not read
    load_embs = reid is not None and cache_root is not None and hasattr(cfg, "feat_dim")

    seqs = list(dataset)
    inputs = []
    for seq in seqs:
        embs = warps = None
        if cache_root is not None:
            dets = load_cached_dets_per_frame(
                det_cache_path(cache_root, detector, seq.name), seq.seq_length
            )
            if load_embs:
                embs = load_cached_embs_per_frame(
                    emb_cache_path(cache_root, detector, reid, seq.name, preprocess),
                    seq.seq_length,
                )
        else:
            dets = seq.dets_per_frame()
        if min_det_conf is not None:
            keep = [d[:, 4] >= min_det_conf for d in dets]
            dets = [d[k] for d, k in zip(dets, keep)]
            if embs is not None:
                embs = [e[k] for e, k in zip(embs, keep)]
        if cmc_method and cache_root is not None:
            wpath = warp_cache_path(cache_root, cmc_method, seq.name)
            if wpath.exists():
                warps = load_cached_warps_per_frame(wpath, seq.seq_length)
        inputs.append({"dets": dets, "embs": embs, "warps": warps})

    if host_tracker:
        all_rows = [_host_rows(tracker_type, tracker_params, seq, inp["dets"], cache_root,
                               detector, device) for seq, inp in zip(seqs, inputs)]
    else:
        all_rows = replay_sequences_batched(cfg, inputs, device=device)
    seq_data = {}
    for seq, mot_rows in zip(seqs, all_rows):
        if output_dir is not None:
            write_mot_results(Path(output_dir) / f"{seq.name}.txt", mot_rows)
        seq_data[seq.name] = preprocess_sequence(
            seq.gt(), mot_rows.astype(np.float64), seq.seq_length
        )
        if verbose:
            print(f"replayed {seq.name}: {len(mot_rows)} track rows")
    results = evaluate_sequences(seq_data)
    if verbose:
        c = results["combined"]
        print(f"HOTA {100 * c['HOTA']:.2f}  MOTA {100 * c['MOTA']:.2f}  IDF1 {100 * c['IDF1']:.2f}")
    return ValidationResult(results)


def _host_rows(tracker_type, tracker_params, seq, dets, cache_root, detector, device):
    """MOT rows of a host tracker (sam2mot) over one sequence: a per-frame
    ``update`` on a blank image of the sequence's size, with the frame's
    cached segmentation masks where the mask cache has the sequence."""
    masks = None
    if cache_root is not None:
        path = mask_cache_path(cache_root, detector, seq.name)
        if path.exists():
            masks = load_cached_masks_per_frame(path, seq.seq_length,
                                                (seq.info.im_height, seq.info.im_width))
    tracker = create_tracker(tracker_type, device=device, tracker_config=tracker_params)
    img = np.zeros((seq.info.im_height, seq.info.im_width, 3), np.uint8)
    rows = []
    for f, d in enumerate(dets):
        kw = {} if masks is None else {"masks": masks[f]}
        out = np.asarray(tracker.update(d, img, **kw))
        if len(out):
            rows.append(convert_to_mot_format(out, frame_idx=f + 1))
    return np.concatenate(rows) if rows else np.zeros((0, 9), np.float32)
