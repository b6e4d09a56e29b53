"""Benchmark evaluation: replay cached detections -> MOT rows -> metrics
(counterpart of the device branch of boxmot_tpu/engine/eval.py::run_eval).

Detections, ground truth and the HOTA/CLEAR/Identity metric stack are the
port's own copies of the JAX package's host modules (``data``,
``engine.metrics``, ``engine.mot_io``, ``engine.results``); the replay runs
on ``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from boxmot_tpu_torch.configs import get_tracker_defaults
from boxmot_tpu_torch.data.cache import det_cache_path, load_cached_dets_per_frame
from boxmot_tpu_torch.data.mot import MOTDataset
from boxmot_tpu_torch.engine.metrics.mot_metrics import evaluate_sequences, preprocess_sequence
from boxmot_tpu_torch.engine.mot_io import write_mot_results
from boxmot_tpu_torch.engine.replay import replay_sequences_batched
from boxmot_tpu_torch.engine.results import ValidationResult
from boxmot_tpu_torch.trackers.bytetrack import ByteTrackConfig
from boxmot_tpu_torch.trackers.sfsort import SFSortConfig
from boxmot_tpu_torch.trackers.zoo import check_ported
from boxmot_tpu_torch.utils.device import resolve_device


_TRACKER_CONFIGS = {"bytetrack": ByteTrackConfig, "sfsort": SFSortConfig}


def build_replay_config(tracker_type: str, **params):
    """Replay config from the YAML tier + explicit overrides, merged by field
    name as in the JAX package.  The YAML keys that are not config fields
    (ByteTrack's ``track_buffer`` and ``frame_rate``, SFSORT's margins) are
    dropped, so the ByteTrack replay keeps the config defaults
    ``det_thresh`` 0.45 and ``max_time_lost`` 25, which the pinned metrics
    depend on."""
    check_ported(tracker_type)
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
    seq_names=None,
    verbose: bool = False,
) -> ValidationResult:
    """Evaluate a tracker over every sequence under ``data_root`` on ``device``.

    Detections come from each sequence's public det.txt or, when
    ``cache_root`` is given, from the generated detection cache.  Returns the
    metric dicts ({"per_seq": ..., "combined": ...}) with HOTA, MOTA, IDF1.
    """
    device = resolve_device(device)
    dataset = MOTDataset(data_root, names=seq_names)
    if len(dataset) == 0:
        raise ValueError(f"no MOT sequences found under {data_root}")
    cfg = build_replay_config(tracker_type, **(tracker_params or {}))

    seqs = list(dataset)
    inputs = []
    for seq in seqs:
        if cache_root is not None:
            dets = load_cached_dets_per_frame(
                det_cache_path(cache_root, detector, seq.name), seq.seq_length
            )
        else:
            dets = seq.dets_per_frame()
        if min_det_conf is not None:
            dets = [d[d[:, 4] >= min_det_conf] for d in dets]
        inputs.append({"dets": dets})

    seq_data = {}
    for seq, mot_rows in zip(seqs, replay_sequences_batched(cfg, inputs, device=device)):
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
