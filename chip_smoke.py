#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (boxmot_tpu_torch) once on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device report: torch's card name and nvidia-smi's name and power limit;
     the CPU references of phases 4-5 start in worker processes (spawned)
     that run beside phases 2-5;
  2. build the four hand-written kernels from csrc/, one nvcc each, in
     parallel;
  3. each kernel against its plain PyTorch twin on the card, at the main
     paths' shapes and at ragged / tie-heavy / masked / degenerate ones: K1
     in both of its modes (IoU + cost, IoU only) and with both union clamps
     (the TPU kernel's 1e-9, iou_batch's 1e-12), K2 on both of its paths (w
     in shared memory, cost read from global memory), K3 also on crossed
     quadrilaterals that overflow its fast path, K4 (the ORU) against its
     twin on the CPU on each of its three layouts (XYSR, XYSR-OBB and
     HybridSORT's XYSCR), where every slot rejoins with gaps 2-31, on a
     ragged S with gaps past MAX_ORU, on its edges (no slot rejoining, 5 x
     13 slots, gaps of MAX_ORU and MAX_ORU + 1, tied alignment candidates)
     and on a recorded OC-SORT, DeepOCSORT (its warped frozen state) and
     HybridSORT step; K1 also on a recorded BoT-SORT step's inputs, K1, K2
     (the graveyard's detections x 64 slots among its problems) and K3 on a
     recorded OccluBoost bench step, AABB and OBB, and K1 and K2 on a
     recorded StrongSORT step (pass 1's costs mostly at the clamp);
     the launch floor, an empty kernel's device time through K1's ctypes
     path on one block and on K1's grids, on a line of its own;
     then each kernel timed on the inputs of one recorded bench step: its
     device time per launch (torch.profiler), its wrapper's time (CUDA
     events around one call), its twin's, and its bound counted from the
     work those inputs need (K4's XYSCR instance too, on its all-rejoin set
     and the HybridSORT step); the OBB Kalman bank's bits on the card
     against the CPU;
  4. AABB evals: run_eval for the ten trackers (ByteTrack, SFSORT, OC-SORT,
     BoT-SORT, DeepOCSORT, BoostTrack, OccluBoost, StrongSORT, HybridSORT
     and sam2mot, the last a host tracker) on MOT17-mini and synth-long,
     held to the pinned HOTA/MOTA/IDF1, with their MOT rows held against the
     same evals on the CPU (all but ByteTrack's, SFSORT's and OC-SORT's to
     the bit; sam2mot's equal by construction); then BoT-SORT's run_eval
     with ``reid`` and ``cmc_method`` over seeded synth-long embedding and
     warp caches (512-d), against the CPU: metrics equal, tracks with ids,
     masks and det_ind exact and boxes within 1e-4 px, and the smallest
     margin of an appearance distance to its threshold; OccluBoost's on the
     same caches with GTA on, against the CPU and a motion-only run, with
     the graveyard resurrections and gap rows it made; and StrongSORT's and
     HybridSORT's on the same caches against their CPU replays, with the
     smallest margin of an appearance distance to the decision it feeds;
  5. OBB evals: run_eval_obb for ByteTrack, SFSORT, OC-SORT, BoT-SORT and
     OccluBoost on mmot-mini, held to the JAX package's values, with their
     tracks held against the CPU's;
  6. the live API: 50 frames of MOT17-04-FRCNN (ByteTrack, OC-SORT,
     sam2mot), the mmot-mini frames as (N, 7) detections (ByteTrack, SFSORT,
     OC-SORT, BoT-SORT, OccluBoost), frames of 300 detections, and seeded
     textured 1920 x 1080 frames of a camera panning by known sub-pixel
     steps with MOT17-04's detections moved along: BoT-SORT with ECC on the
     card, BoT-SORT from the zoo defaults (SOF, on the host), DeepOCSORT,
     StrongSORT and HybridSORT with ECC and embeddings, BoostTrack and
     OccluBoost with ECC; each against the same tracker on the CPU, with the
     warps ECC recovered beside the known steps;
  7. replay throughput at the bench shape (8 sequences x 100 detections,
     D = 128, capacity 256; the lines of earlier slices at EARLIER_FRAMES =
     128 frames a sequence, StrongSORT's and HybridSORT's at 256), timed
     with CUDA events: ByteTrack AABB and OBB, OC-SORT AABB with 5 % of the
     detections missed each frame (so that the ORU runs), with the slots K4
     replayed, and a profile of 16 OC-SORT steps (kernels, device busy and
     host ms per step); BoT-SORT AABB with 512-d embeddings and a per-frame
     translation warp (``appearance_batch``: embeddings made on the card)
     and its 16-step profile with K1's, K2's, K4's and the embedding
     product's device ms; DeepOCSORT AABB on the same kind of input with 5 %
     missed, and its 16-step profile; BoostTrack AABB (the YAML tier) and
     OccluBoost AABB (``OccluBoostConfig()``, as bench.py runs it) on the
     same kind of input, with their 16-step profiles; ECC's ``apply`` at
     1080p, scale 0.15 (host ms a frame, kernels an apply); StrongSORT AABB
     and HybridSORT AABB (their YAML tiers, HybridSORT with 5 % missed so
     that K4 replays) on the same kind of input, with their 16-step
     profiles.
Every path of phases 4-7 runs with the launch counters set to 0 just before
it and read just after; each eval's frame loop runs under
torch.cuda.set_sync_debug_mode("error"), and where a step's launches are
fixed (ByteTrack and BoT-SORT: 2 IoU launches (K1, or K3 in OBB mode) to 3
auctions; SFSORT: 1 rotated IoU to 2 auctions in OBB mode; OC-SORT and
DeepOCSORT: 2 IoU launches to 2 auctions to 1 ORU; StrongSORT: 1 IoU launch
to 2 auctions; BoostTrack, OccluBoost and HybridSORT: as ``boost_ratio`` and
``hybrid_ratio`` count them from the config's options; sam2mot: none) the
counts must keep that ratio, so no step fell back to a twin.  Phase laps
are printed.  The line before the last is {"kernels": [...]}, with each
kernel's launches summed over those paths (K4's over its three layouts);
the last line is {"ok": true, "device": {...}}.  Without a CUDA card it
exits non-zero before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import configparser
import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import boxmot_tpu_torch
from boxmot_tpu_torch.csrc import build
from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.eval_obb import mmot_obb_dets
from boxmot_tpu_torch.engine.replay import (
    batch_replay,
    init_states,
    pack_frames,
    replay_sequences_outputs,
)
from boxmot_tpu_torch.motion import kalman
from boxmot_tpu_torch.motion.cmc import create_cmc
from boxmot_tpu_torch.ops.fused_iou_cost import (
    IOU_BATCH_EPS,
    empty_launch,
    fused_iou_cost,
    fused_iou_cost_plain,
    launch_geometry,
)
from boxmot_tpu_torch.ops.geometry import obb_corners, wrap_angle
from boxmot_tpu_torch.ops.lap import masked_assignment, masked_assignment_plain, uses_shared_weights
from boxmot_tpu_torch.ops.oru import MAX_ORU, oru_replay, oru_replay_plain
from boxmot_tpu_torch.ops.oru import launch_geometry as k4_geometry
from boxmot_tpu_torch.ops.rotated_iou import rotated_iou, rotated_iou_counted, rotated_iou_plain
from boxmot_tpu_torch.trackers import (
    boosttrack,
    botsort,
    bytetrack,
    deepocsort,
    hybridsort,
    occluboost,
    ocsort,
    strongsort,
)
from boxmot_tpu_torch.trackers.boosttrack import BoostTrackConfig
from boxmot_tpu_torch.trackers.bytetrack import ByteTrackConfig
from boxmot_tpu_torch.trackers.occluboost import OccluBoostConfig
from boxmot_tpu_torch.trackers.ocsort import OcSortConfig
from boxmot_tpu_torch.utils import measure

ROOT = Path(__file__).resolve().parent
ASSETS = ROOT / "assets"
ROOTS = {"mot17_mini": ASSETS / "MOT17-mini" / "train", "synth_long": ASSETS / "synth-long" / "train"}
MMOT_ROOT = ASSETS / "mmot-mini" / "train"
LIVE_SEQ = ROOTS["mot17_mini"] / "MOT17-04-FRCNN"
# the pins of tests/test_pinned_metrics.py of the ten trackers (a CPU test
# holds them equal)
PINNED = {
    ("mot17_mini", "bytetrack"): {"HOTA": 0.649859, "MOTA": 0.495283, "IDF1": 0.662461},
    ("mot17_mini", "ocsort"): {"HOTA": 0.651511, "MOTA": 0.488208, "IDF1": 0.656101},
    ("mot17_mini", "sfsort"): {"HOTA": 0.654495, "MOTA": 0.497642, "IDF1": 0.664567},
    ("synth_long", "bytetrack"): {"HOTA": 0.952785, "MOTA": 0.996300, "IDF1": 0.968698},
    ("synth_long", "ocsort"): {"HOTA": 0.885979, "MOTA": 0.933777, "IDF1": 0.935373},
    ("synth_long", "sfsort"): {"HOTA": 0.898791, "MOTA": 0.980762, "IDF1": 0.916468},
    ("mot17_mini", "botsort"): {"HOTA": 0.652681, "MOTA": 0.495283, "IDF1": 0.662461},
    ("mot17_mini", "deepocsort"): {"HOTA": 0.652269, "MOTA": 0.492925, "IDF1": 0.660348},
    ("synth_long", "botsort"): {"HOTA": 0.952210, "MOTA": 0.996670, "IDF1": 0.968877},
    ("synth_long", "deepocsort"): {"HOTA": 0.885492, "MOTA": 0.932667, "IDF1": 0.934837},
    ("mot17_mini", "boosttrack"): {"HOTA": 0.649366, "MOTA": 0.495283, "IDF1": 0.662461},
    ("mot17_mini", "occluboost"): {"HOTA": 0.649804, "MOTA": 0.492925, "IDF1": 0.660348},
    ("synth_long", "boosttrack"): {"HOTA": 0.940187, "MOTA": 0.984832, "IDF1": 0.962756},
    ("synth_long", "occluboost"): {"HOTA": 0.970771, "MOTA": 0.995930, "IDF1": 0.997963},
    ("mot17_mini", "strongsort"): {"HOTA": 0.466670, "MOTA": 0.341981, "IDF1": 0.509666},
    ("mot17_mini", "hybridsort"): {"HOTA": 0.653064, "MOTA": 0.497642, "IDF1": 0.664567},
    ("mot17_mini", "sam2mot"): {"HOTA": 0.658509, "MOTA": 0.504717, "IDF1": 0.672897},
    ("synth_long", "strongsort"): {"HOTA": 0.861006, "MOTA": 0.910840, "IDF1": 0.853037},
    ("synth_long", "hybridsort"): {"HOTA": 0.851414, "MOTA": 0.892342, "IDF1": 0.882638},
    ("synth_long", "sam2mot"): {"HOTA": 0.845008, "MOTA": 0.914909, "IDF1": 0.848808},
}
# the JAX package's run_eval_obb on mmot-mini (a CPU test holds them equal)
OBB_EVAL = {
    "bytetrack": {"HOTA": 0.604123, "MOTA": 0.662654, "IDF1": 0.671799},
    "sfsort": {"HOTA": 0.898815, "MOTA": 0.942670, "IDF1": 0.924151},
    "ocsort": {"HOTA": 0.734300, "MOTA": 0.701753, "IDF1": 0.749516},
    "botsort": {"HOTA": 0.575946, "MOTA": 0.606537, "IDF1": 0.663570},
    "occluboost": {"HOTA": 0.612130, "MOTA": 0.584943, "IDF1": 0.669023},
}


def boost_ratio(cfg) -> dict:
    """Launches per step of a BoostTrack or OccluBoost config's kernels, which
    depend on its options: an IoU launch for the association (it also feeds
    the DLO boost and the passes on tracks x detections), one for DUO, one for
    the oriented recovery and second passes, one for duplicate suppression;
    an auction for the first pass, the recovery, the second pass, GTA and
    the graveyard."""
    if isinstance(cfg, BoostTrackConfig):
        return {"fused_iou_cost": 1 + cfg.use_duo_boost, "masked_assignment": 1}
    obb, reid = cfg.is_obb, cfg.with_reid
    gta = cfg.gta_enabled and reid
    iou = (1 + (not obb and cfg.use_duo_boost) + (obb and (reid or cfg.use_second_pass))
           + (0.0 < cfg.duplicate_iou_thresh < 1.0))
    return {"rotated_iou" if obb else "fused_iou_cost": iou,
            "masked_assignment": 1 + reid + cfg.use_second_pass + 2 * gta}


def hybrid_ratio(cfg) -> dict:
    """Launches per step of a HybridSORT config's kernels: an auction for the
    first pass, the BYTE pass (with ``use_byte``) and the final chance; the
    ORU once; K1 for the first pass's and the final chance's similarity when
    the association is ``"iou"`` (the YAML tier's ``"diou"`` is plain)."""
    ratio = {"masked_assignment": 2 + cfg.use_byte, "oru_replay": 1}
    if cfg.asso_func == "iou":
        ratio["fused_iou_cost"] = 2
    return ratio


# launches per step of each tracker's kernels, axis-aligned and oriented
RATIOS = {
    "bytetrack": ({"fused_iou_cost": 2, "masked_assignment": 3},
                  {"rotated_iou": 2, "masked_assignment": 3}),
    "sfsort": ({"masked_assignment": 2}, {"rotated_iou": 1, "masked_assignment": 2}),
    "ocsort": ({"fused_iou_cost": 2, "masked_assignment": 2, "oru_replay": 1},
               {"rotated_iou": 2, "masked_assignment": 2, "oru_replay": 1}),
    "botsort": ({"fused_iou_cost": 2, "masked_assignment": 3},
                {"rotated_iou": 2, "masked_assignment": 3}),
    "deepocsort": ({"fused_iou_cost": 2, "masked_assignment": 2, "oru_replay": 1}, None),
    # the YAML tiers as the evals run them: run_eval without embeddings
    # (with_reid off), run_eval_obb with zero ones (with_reid on)
    "boosttrack": (boost_ratio(build_replay_config("boosttrack", with_reid=False)), None),
    "occluboost": (boost_ratio(build_replay_config("occluboost", with_reid=False)),
                   boost_ratio(build_replay_config("occluboost", is_obb=True))),
    "strongsort": ({"fused_iou_cost": 1, "masked_assignment": 2}, None),
    "hybridsort": (hybrid_ratio(build_replay_config("hybridsort", with_reid=False)), None),
    "sam2mot": ({}, None),  # a host tracker: no kernel
}
# the live OccluBoost without a ReID model: with_reid off in both modes
LIVE_OBB_RATIOS = {**{t: r[1] for t, r in RATIOS.items() if r[1]},
                   "occluboost": boost_ratio(build_replay_config("occluboost", with_reid=False,
                                                                 is_obb=True))}
# trackers whose eval and live rows must equal the CPU's to the bit (no
# embedding product enters them: the evals run without embeddings; sam2mot's
# rows are the host's on both, equal by construction)
BIT_EQUAL_EVALS = ("botsort", "deepocsort", "boosttrack", "occluboost", "strongsort",
                   "hybridsort", "sam2mot")
HOST_TRACKERS = ("sam2mot",)
FEAT_DIM = 512  # the OSNet width of the appearance trackers' configs
REID, REID_DETECTOR = "seedreid", "seeddet"
MISS = 0.05  # the OC-SORT bench line's share of detections missed each frame
ATOL = 1e-4
# the port evaluates cos/sin/log/sqrt in float64 and rounds once, so a cuda
# run and a CPU run agree to the bit unless a float64 result lands within an
# ulp of a float32 rounding boundary; OBB boxes are held within 1e-2 px
OBB_BOX_TOL = 1e-2
# bench shape (bench.py): sequences x frames x detections, det bucket, capacity
N_SEQS, N_FRAMES, N_DETS, D_BENCH, CAPACITY = 8, 256, 100, 128, 256
# K1's checked shapes: the bench step's two launches, a live frame of 512
# detections, and two that take the scalar stores (D % 4 != 0)
K1_SHAPES = ((8, 256, 128), (2, 256, 256), (2, 256, 512), (1, 1, 3), (3, 200, 77))
KERNELS = {  # counter name -> (wrapper, source, the TPU kernel or JAX function it replaces)
    "fused_iou_cost": (fused_iou_cost, "iou_cost", "boxmot_tpu/ops/pallas_kernels.py:59"),
    "masked_assignment": (masked_assignment, "auction", "boxmot_tpu/ops/lap.py:37"),
    "rotated_iou": (rotated_iou, "rotated_iou", "boxmot_tpu/ops/pallas_rotated_iou.py:136"),
    "oru_replay": (oru_replay, "oru", "boxmot_tpu/trackers/ocsort.py:310"),
}
LAUNCHES = {name: 0 for name in KERNELS}  # summed over the driven paths


def synthetic_frames(n_frames, n_dets, seed=0):
    """Random-walk boxes on a 1080x1920 frame, as bench.py makes them."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, [1820, 880], (n_dets, 2))
    vel = rng.uniform(-3, 3, (n_dets, 2))
    size = rng.uniform(40, 120, (n_dets, 2))
    frames = []
    for f in range(n_frames):
        p = np.clip(pos + vel * f, 0, [1820, 980])
        conf = rng.uniform(0.5, 0.99, n_dets)
        frames.append(np.concatenate(
            [p, p + size, conf[:, None], np.zeros((n_dets, 1))], axis=1).astype(np.float32))
    return frames


def synthetic_frames_missed(n_frames, n_dets, seed=0, miss=MISS):
    """``synthetic_frames`` with a share ``miss`` of the boxes dropped in each
    frame (drawn from a second generator), so that tracks miss frames and
    rejoin: OC-SORT's OCR pass and its ORU then run."""
    rng = np.random.default_rng(seed + 1_000_003)
    return [f[rng.uniform(size=len(f)) >= miss] for f in synthetic_frames(n_frames, n_dets, seed)]


def appearance_scene(n_frames, n_dets, seed=0, miss=0.0, pan=0.5):
    """``synthetic_frames`` seen by a panning camera: the boxes shifted by the
    camera's accumulated translation (a random walk of steps up to ``pan`` px
    a frame) and a share ``miss`` of them dropped in each frame.  Returns
    (frames, tracks, warps): per-frame (Ni, 6) detections, the (Ni,) track of
    each row, and (n_frames, 2, 3) warps mapping the previous frame to this
    one (the identity for the first)."""
    rng = np.random.default_rng(seed + 2_000_003)
    steps = rng.uniform(-pan, pan, (n_frames, 2))
    steps[0] = 0.0
    shift = np.cumsum(steps, axis=0)
    warps = np.broadcast_to(np.eye(2, 3, dtype=np.float32), (n_frames, 2, 3)).copy()
    warps[:, :, 2] = steps
    frames, tracks = [], []
    for f, dets in enumerate(synthetic_frames(n_frames, n_dets, seed)):
        dets = dets.copy()
        dets[:, [0, 2]] += np.float32(shift[f, 0])
        dets[:, [1, 3]] += np.float32(shift[f, 1])
        keep = rng.uniform(size=n_dets) >= miss
        frames.append(dets[keep])
        tracks.append(np.flatnonzero(keep))
    return frames, tracks, warps


def appearance_frames(n_frames, n_dets, seed=0, miss=0.0, feat_dim=512, pan=0.5, noise=0.3):
    """``appearance_scene`` with each detection's embedding: its track's unit
    vector plus Gaussian noise of norm about ``noise`` (before
    normalisation).  Returns (frames, embs, warps), embs per-frame (Ni,
    feat_dim), row-aligned with the detections."""
    frames, tracks, warps = appearance_scene(n_frames, n_dets, seed, miss, pan)
    rng = np.random.default_rng(seed + 3_000_017)
    base = rng.normal(size=(n_dets, feat_dim))
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    sigma = noise / math.sqrt(feat_dim)
    embs = [(base[t] + rng.normal(0, sigma, (len(t), feat_dim))).astype(np.float32)
            for t in tracks]
    return frames, embs, warps


def appearance_batch(n_seqs, n_frames, n_dets, seed, miss, device, feat_dim=FEAT_DIM,
                     noise=0.3):
    """A batch of ``appearance_scene`` sequences at the bench's detection
    bucket: packed detections (S, F, D_BENCH, 7), embeddings (S, F, D_BENCH,
    feat_dim) made on ``device`` (each row its track's seeded unit vector
    plus noise of norm about ``noise``, padding rows zero) and warps
    (S, F, 2, 3), all on ``device``."""
    packed, rows, warps = [], [], []
    for s in range(n_seqs):
        frames, tracks, w = appearance_scene(n_frames, n_dets, seed=seed + s, miss=miss)
        packed.append(pack_frames(frames, D=D_BENCH, F=n_frames)[0])
        idx = np.full((n_frames, D_BENCH), -1, np.int64)
        for f, t in enumerate(tracks):
            idx[f, :len(t)] = t
        rows.append(idx)
        warps.append(w)
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn((n_seqs, n_dets, feat_dim), generator=gen, device=device)
    base = base / torch.linalg.vector_norm(base, dim=-1, keepdim=True)
    idx = torch.from_numpy(np.stack(rows)).to(device)
    embs = torch.gather(base, 1, idx.clamp(min=0).view(n_seqs, -1, 1).expand(-1, -1, feat_dim))
    embs = embs.view(n_seqs, n_frames, D_BENCH, feat_dim)
    embs += torch.randn(embs.shape, generator=gen, device=device) * (noise / math.sqrt(feat_dim))
    embs = torch.where(idx[..., None] >= 0, embs, 0.0)
    return (torch.from_numpy(np.stack(packed)).to(device), embs,
            torch.from_numpy(np.stack(warps)).to(device))


def reid_caches(root: Path, feat_dim: int = FEAT_DIM, seed: int = 8) -> Path:
    """Seeded caches of synth-long under ``root``, in the caches' own layouts
    (``data.cache``): its public detections as detector REID_DETECTOR's
    cache; each detection's embedding under ReID model REID, the random
    vector of its nearest ground-truth identity plus noise; and per-frame
    translation warps of about 1 px under cmc method "ecc"."""
    from boxmot_tpu_torch.data.cache import det_cache_path, emb_cache_path, warp_cache_path
    from boxmot_tpu_torch.data.mot import MOTDataset

    rng = np.random.default_rng(seed)
    bases = {}
    for seq in MOTDataset(ROOTS["synth_long"]):
        gt = seq.gt()  # [frame, id, x, y, w, h, ...]
        det_rows, emb_rows = [], []
        for f, dets in enumerate(seq.dets_per_frame(), start=1):
            if not len(dets):
                continue
            g = gt[gt[:, 0] == f]
            gid = np.zeros(len(dets))
            if len(g):  # the identity whose box centre is nearest in x
                near = np.abs((dets[:, 0] + dets[:, 2])[:, None] - (2 * g[None, :, 2] + g[None, :, 4]))
                gid = g[np.argmin(near, axis=1), 1]
            e = np.stack([bases.setdefault(int(i), rng.normal(size=feat_dim)) for i in gid])
            frame = np.full((len(dets), 1), f)
            det_rows.append(np.concatenate([frame, dets[:, :6]], 1))
            emb_rows.append(np.concatenate([frame, e + rng.normal(0, 0.3, e.shape)], 1))
        n = seq.seq_length
        warps = np.tile(np.eye(2, 3).reshape(1, 6), (n, 1))
        warps[:, 2], warps[:, 5] = rng.normal(0, 1.0, n), rng.normal(0, 1.0, n)
        for path, rows in (
                (det_cache_path(root, REID_DETECTOR, seq.name), np.concatenate(det_rows)),
                (emb_cache_path(root, REID_DETECTOR, REID, seq.name), np.concatenate(emb_rows)),
                (warp_cache_path(root, "ecc", seq.name),
                 np.concatenate([np.arange(1, n + 1)[:, None], warps], 1))):
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, rows.astype(np.float32))
    return root


def shifted_frames(n_frames, seed=0, size=(1080, 1920), step=1.5, sigma=20.0):
    """Seeded textured BGR uint8 frames of a camera panning by known
    sub-pixel steps: a smoothed-noise scene, each frame the scene moved by the
    accumulated steps (bilinear).  Returns (frames, steps (n_frames, 2) px:
    the translation from the previous frame, 0 for the first)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    H, W = size
    m = int(math.ceil(step * n_frames)) + 2
    scene = gaussian_filter(rng.uniform(0, 255, (H + 2 * m, W + 2 * m)), sigma)
    scene = (scene - scene.min()) / np.ptp(scene) * 255.0
    steps = rng.uniform(-step, step, (n_frames, 2))
    steps[0] = 0.0
    frames = []
    for sx, sy in np.cumsum(steps, axis=0):
        # frame pixel p shows scene pixel p + m - shift
        ox, oy = m - sx, m - sy
        ix, iy = int(math.floor(ox)), int(math.floor(oy))
        fx, fy = ox - ix, oy - iy
        a = scene[iy:iy + H + 1, ix:ix + W + 1]
        g = ((1 - fx) * (1 - fy) * a[:-1, :-1] + fx * (1 - fy) * a[:-1, 1:]
             + (1 - fx) * fy * a[1:, :-1] + fx * fy * a[1:, 1:])
        frames.append(np.repeat(np.clip(g, 0, 255).astype(np.uint8)[..., None], 3, axis=2))
    return frames, steps


def synthetic_obb_frames(n_frames, n_dets, seed=0, miss=0.05):
    """Random-walk rotated boxes [cx, cy, w, h, theta, conf, cls] on a
    1080x1920 frame: turning boxes with jittered centres, a spread of
    confidences (both ByteTrack passes, SFSORT's intermediate pass) and a
    share ``miss`` of the boxes missed in each frame."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([60, 60], [1860, 1020], (n_dets, 2))
    vel = rng.uniform(-3, 3, (n_dets, 2))
    size = rng.uniform(20, 120, (n_dets, 2))
    theta = rng.uniform(-np.pi, np.pi, n_dets)
    omega = rng.uniform(-0.03, 0.03, n_dets)
    frames = []
    for f in range(n_frames):
        p = np.clip(pos + vel * f + rng.normal(0, 1, (n_dets, 2)), 0, [1920, 1080])
        th = np.remainder(theta + omega * f + np.pi, 2 * np.pi) - np.pi
        conf = rng.uniform(0.2, 0.99, n_dets)
        keep = rng.uniform(size=n_dets) >= miss
        frames.append(np.concatenate([p, size, th[:, None], conf[:, None],
                                      np.zeros((n_dets, 1))], axis=1)[keep].astype(np.float32))
    return frames


def occlusion_frames(n_frames, n_ids, seed=0, feat_dim=32, obb=False, speed=2.0):
    """Seeded identities that vanish and come back: each walks over a
    1920 x 1080 frame (up to ``speed`` px a frame on each axis); half of
    them are hidden for 12-22 frames once (long enough for a tracker with
    max_age 10 to bury them), every one misses 5 % of its frames, is cut to
    55 % of its height now and then (a speed and shrink spike for
    OccluBoost's AMS), and takes a low confidence in 20 % of its frames.  Rows come in a shuffled order.  Returns (frames, embs): per
    frame (Ni, 6) [x1, y1, x2, y2, conf, cls] or, with ``obb``, (Ni, 7)
    [cx, cy, w, h, theta, conf, cls], and (Ni, feat_dim) embeddings, each its
    identity's unit vector plus noise of norm about 0.1."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([100, 100], [1800, 900], (n_ids, 2))
    vel = rng.uniform(-speed, speed, (n_ids, 2))
    size = np.stack([rng.uniform(40, 100, n_ids), rng.uniform(90, 200, n_ids)], 1)
    theta = rng.uniform(-np.pi, np.pi, n_ids)
    hide = np.full((n_ids, 2), -1)
    for i in range(0, n_ids, 2):
        start = rng.integers(8, max(9, n_frames - 25))
        hide[i] = start, start + rng.integers(12, 23)
    base = rng.normal(size=(n_ids, feat_dim))
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    frames, embs = [], []
    for f in range(n_frames):
        rows, feats = [], []
        for i in range(n_ids):
            if hide[i, 0] <= f < hide[i, 1] or rng.uniform() < 0.05:
                continue
            c = pos[i] + vel[i] * f + rng.normal(0, 0.7, 2)
            w, h = size[i]
            if rng.uniform() < 0.06:
                c = c - [0, 0.225 * h]
                h = 0.55 * h
            conf = rng.uniform(0.15, 0.5) if rng.uniform() < 0.2 else rng.uniform(0.6, 0.95)
            if obb:
                rows.append([c[0], c[1], w, h, theta[i] + 0.01 * f, conf, i % 3])
            else:
                rows.append([c[0] - w / 2, c[1] - h / 2, c[0] + w / 2, c[1] + h / 2, conf, i % 3])
            feats.append(base[i] + rng.normal(0, 0.1 / math.sqrt(feat_dim), feat_dim))
        order = rng.permutation(len(rows))
        cols = 7 if obb else 6
        frames.append(np.asarray(rows, np.float32).reshape(-1, cols)[order])
        embs.append(np.asarray(feats, np.float32).reshape(-1, feat_dim)[order])
    return frames, embs


def oru_inputs(rng, S, K, obb, p_rejoin=1.0, gap_max=31):
    """Inputs of the ORU (kernel K4) for S x K slots, made with the port's
    Kalman bank on the CPU: tracks initiated and updated four times (the
    frozen state and the last measurement), then predicted through gaps of
    2 .. gap_max frames (the current state), and a new measurement where the
    motion has carried each box (for oriented boxes with a turned angle, a
    fifth of them with r inverted, aligned to the predicted mean).  ``obb``:
    False for XYSR, True for XYSR-OBB, or "xyscr" for HybridSORT's XYSCR,
    whose measurements [x, y, s, c, r] carry a confidence that drifts.  A
    share ``p_rejoin`` of the slots rejoins.  Returns (layout, [mean, cov,
    frozen_mean, frozen_cov, last_meas, z2], rejoin, gap), on the CPU."""
    xyscr = obb == "xyscr"
    obb = obb is True
    layout = kalman.make_xyscr_layout() if xyscr else kalman.make_xysr_layout(obb, 0.01, 1e-4, 1e-4)
    w, h = rng.uniform(20, 200, (S, K)), rng.uniform(20, 200, (S, K))
    cols = [rng.uniform(0, 1800, (S, K)), rng.uniform(0, 1000, (S, K)), w * h, w / h]
    if obb:
        cols.append(rng.uniform(-np.pi, np.pi, (S, K)))
    if xyscr:
        cols.insert(3, rng.uniform(0.3, 0.95, (S, K)))
    z = torch.from_numpy(np.stack(cols, -1).astype(np.float32))
    mean, cov = kalman.initiate(layout, z)
    every = torch.ones((S, K), dtype=torch.bool)
    vel = torch.from_numpy(rng.normal(0, 3, (S, K, 2)).astype(np.float32))
    for _ in range(4):
        mean, cov = kalman.predict(layout, mean, cov, every)
        z = z.clone()
        z[..., :2] += vel
        z[..., 2] *= torch.from_numpy(rng.uniform(0.97, 1.03, (S, K)).astype(np.float32))
        if obb:
            z[..., 4] += torch.from_numpy(rng.normal(0, 0.02, (S, K)).astype(np.float32))
            z = kalman.align_obb_xysr(z, mean[..., :5])
        if xyscr:
            z[..., 3] += torch.from_numpy(rng.normal(0, 0.03, (S, K)).astype(np.float32))
        mean, cov = kalman.update(layout, mean, cov, z, every)
    frozen_mean, frozen_cov, last_meas = mean, cov, z
    gap = torch.from_numpy(rng.integers(2, gap_max + 1, (S, K)).astype(np.int32))
    for i in range(int(gap.max())):
        mean, cov = kalman.predict(layout, mean, cov, i < gap)
    z2 = last_meas.clone()
    z2[..., :2] += vel * gap[..., None].to(torch.float32)
    if obb:
        z2[..., 4] += torch.from_numpy(rng.normal(0, 0.3, (S, K)).astype(np.float32))
        z2[:, ::5, 3] = 1.0 / z2[:, ::5, 3]
        z2 = kalman.align_obb_xysr(z2, mean[..., :5])
    if xyscr:
        z2[..., 3] = torch.from_numpy(rng.uniform(0.3, 0.95, (S, K)).astype(np.float32))
        z2[:, ::5, 4] = 1.0 / z2[:, ::5, 4]
    rejoin = torch.from_numpy(rng.uniform(size=(S, K)) < p_rejoin)
    tensors = [t.contiguous() for t in (mean, cov, frozen_mean, frozen_cov, last_meas, z2)]
    return layout, tensors, rejoin, gap


# K4's edge sets: (name, layout) pairs of oru_edge_inputs (False: XYSR, True:
# XYSR-OBB, "xyscr")
ORU_EDGES = (("no slot rejoins", False), ("no slot rejoins", True), ("5 x 13", False),
             ("5 x 13", True), ("gaps MAX_ORU, MAX_ORU + 1", False),
             ("gaps MAX_ORU, MAX_ORU + 1", True), ("alignment ties", True))
XYSCR_EDGES = (("no slot rejoins", "xyscr"), ("5 x 13", "xyscr"),
               ("gaps MAX_ORU, MAX_ORU + 1", "xyscr"))


def _alignment_ties():
    """(measured angle, reference angle) float32 pairs for which two of
    align_obb_xysr's candidates cost exactly the same when r = 1 (every
    candidate then has the same size cost): measured angles within 8 ulps of
    +-pi/2 against references within 64 ulps of +-pi/4 and +-3pi/4, the
    angle costs formed as the alignment forms them."""
    th = np.concatenate([np.float32(s * np.pi / 2) + np.arange(-8, 9, dtype=np.float32)
                         * np.spacing(np.float32(np.pi / 2)) for s in (-1, 1)])
    ref = np.concatenate([np.float32(k * np.pi / 4) + np.arange(-64, 65, dtype=np.float32)
                          * np.spacing(np.float32(np.pi / 4) * abs(k)) for k in (-3, -1, 1, 3)])
    th, ref = (torch.from_numpy(np.ascontiguousarray(x)) for x in np.meshgrid(th, ref))
    a = wrap_angle(wrap_angle(th))  # the measurement's wrap, then the candidate's
    cand = torch.stack([a, a + math.pi, a + math.pi / 2, a - math.pi / 2], -1)
    cost = torch.abs(ref[..., None] + wrap_angle(cand - ref[..., None]) - ref[..., None])
    tie = (cost == cost.min(-1, keepdim=True).values).sum(-1) > 1
    return th[tie], ref[tie]


def oru_edge_inputs(rng, edge, obb):
    """K4's edge sets of a layout (``obb`` as ``oru_inputs`` takes it), as
    ``oru_inputs`` returns them: no slot rejoining (a
    pure copy-through, 8 x 256); S x K = 5 x 13, not a multiple of a block's
    warps; gaps of exactly MAX_ORU and MAX_ORU + 1; and, oriented, alignment
    ties: r = 1 in both measurements and, for the measured and frozen
    angles, pairs near +-pi/2 and +-pi/4 or +-3pi/4 on which two candidates
    cost exactly the same (``_alignment_ties``), with a gap of 1, so that the
    replay's one update aligns against the frozen mean on a tie."""
    if edge == "no slot rejoins":
        return oru_inputs(rng, N_SEQS, CAPACITY, obb, p_rejoin=0.0)
    if edge == "5 x 13":
        return oru_inputs(rng, 5, 13, obb, p_rejoin=0.7)
    if edge == "gaps MAX_ORU, MAX_ORU + 1":
        layout, tensors, rejoin, gap = oru_inputs(rng, 2, 16, obb)
        gap = torch.full_like(gap, MAX_ORU)
        gap[:, 1::2] = MAX_ORU + 1
        return layout, tensors, rejoin, gap
    if edge != "alignment ties" or obb is not True:
        raise ValueError(f"no K4 edge set {edge!r} (oriented: {obb})")
    layout, tensors, rejoin, _ = oru_inputs(rng, 2, 32, True)
    mean, cov, frozen_mean, frozen_cov, last_meas, z2 = (t.clone() for t in tensors)
    th, ref = _alignment_ties()
    pick = torch.from_numpy(rng.integers(0, len(th), (2, 32)))
    frozen_mean[..., 4] = ref[pick]
    last_meas[..., 3], last_meas[..., 4] = 1.0, th[pick]
    z2[..., 3], z2[..., 4] = 1.0, th[pick]
    gap = torch.ones((2, 32), dtype=torch.int32)
    return layout, [mean, cov, frozen_mean, frozen_cov, last_meas, z2], rejoin, gap


def _boxes(rng, S, n):
    """Track/detection-like xyxy boxes with the step's edge cases mixed in."""
    b = np.zeros((S, n, 4), np.float32)
    b[..., :2] = rng.uniform(0, 1800, (S, n, 2))
    b[..., 2:] = b[..., :2] + rng.uniform(5, 200, (S, n, 2))
    b[:, 0::9] = 0.0  # empty slot
    b[:, 1::9] = [0.0, 0.0, 1.0, 1.0]  # padding detection
    b[:, 2::9, 2] = b[:, 2::9, 0]  # zero width
    return b


def k1_bound(trk, det, conf):
    """K1's least time for these arguments: each distinct input read once,
    the IoU (and, with conf, the cost) written once; 13 operations a pair for
    the IoU and 2 more for the cost, 3 a distinct box (its area)."""
    S, K, _ = trk.shape
    D = det.shape[1]
    inputs = {t.data_ptr(): t.nbytes for t in (trk, det, conf) if t is not None}
    outputs = 1 if conf is None else 2
    boxes = K if det is trk else K + D
    return measure.bound_ms(sum(inputs.values()) + 4 * outputs * S * K * D,
                            (11 + 2 * outputs) * S * K * D + 3 * S * boxes)


def _offset_copy(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte boundary."""
    return torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape).copy_(t)


def _tiny_boxes(S, K, D):
    """Boxes of 1e-5 px, whose unions lie below the TPU kernel's 1e-9 clamp:
    there the two clamps give other IoUs."""
    trk = np.tile(np.array([0, 0, 1e-5, 1e-5], np.float32), (S, K, 1))
    det = np.tile(np.array([0, 0, 2e-5, 1e-5], np.float32), (S, D, 1))
    det[:, ::2] = [0, 0, 1e-5, 1e-5]
    return trk, det


def check_k1(rng, step_calls):
    """K1 bit-equal to its twin in both modes (with conf: IoU and cost;
    without: the IoU alone) and with both union clamps (the TPU kernel's
    default, iou_batch's that the tracker steps pass) at the step's shapes,
    a live frame's 512 detections and two shapes that take the scalar path
    (D % 4 != 0), with confidences that are not 16-byte aligned, and on
    boxes whose unions lie below 1e-9; the launch floor (an empty kernel
    through the same ctypes path, on one block and on K1's grids); then
    each of the bench step's two launches timed in its own mode."""
    cases = []
    for S, K, D in K1_SHAPES:
        trk = _boxes(rng, S, K)
        det = _boxes(rng, S, D)
        det[:, : D // 2] = trk[:, :1] + rng.uniform(-30, 30, (S, D // 2, 4))
        cases.append(("", trk, det))
    cases.append((", tiny boxes", *_tiny_boxes(2, 8, 12)))
    for tag, trk, det in cases:
        S, K, D = trk.shape[0], trk.shape[1], det.shape[1]
        conf = rng.uniform(0.05, 1.0, (S, D)).astype(np.float32)
        full = [torch.from_numpy(a).cuda() for a in (trk, det, conf)]
        for clamp, kw in (("clamp 1e-9", {}), ("clamp 1e-12", {"eps": IOU_BATCH_EPS})):
            for mode, args in (("iou+cost", full), ("iou-only", full[:2]),
                               ("iou+cost, conf 4 bytes off", full[:2] + [_offset_copy(full[2])])):
                got, want = fused_iou_cost(*args, **kw), fused_iou_cost_plain(*args, **kw)
                torch.cuda.synchronize()
                same = [g is w or torch.equal(g, w) for g, w in zip(got, want)]
                if not all(same):
                    raise AssertionError(f"K1 {mode}{tag}, {clamp} at S={S} K={K} D={D}: not "
                                         f"bit-equal to the twin (iou {same[0]}, cost {same[1]})")
            print(f"K1 iou+cost, iou-only, offset conf{tag}, {clamp}, S={S} K={K} D={D}: "
                  f"bit-equal to the twin")
    tiny = [torch.from_numpy(a).cuda() for a in cases[-1][1:]]
    wide, narrow = (fused_iou_cost(*tiny, eps=e)[0][0, 0, :2].tolist()
                    for e in (1e-9, IOU_BATCH_EPS))
    print(f"K1 on 1e-5 px boxes, the first two IoUs: clamp 1e-9 {wide}, clamp 1e-12 {narrow} "
          f"(iou_batch's)")
    if narrow[0] != 1.0 or wide == narrow:
        raise AssertionError("K1's union clamp does not act as the argument says")
    # BoT-SORT's bench step (appearance inputs): its two launches, each in its mode
    for args, kwargs in step_calls["botsort"]["fused_iou_cost"]:
        args = list(args)
        if len(args) == 2 and torch.equal(*args):
            args = [args[0], args[0]]
        got, want = fused_iou_cost(*args, **kwargs), fused_iou_cost_plain(*args, **kwargs)
        torch.cuda.synchronize()
        if not all(g is w or torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("K1 on BoT-SORT's bench step: not bit-equal to the twin")
        print(f"K1 BoT-SORT bench step {'iou+cost' if len(args) == 3 else 'iou-only'} "
              f"{tuple(args[0].shape)} x {args[1].shape[1]}: bit-equal to the twin")
    # OccluBoost's bench step: the association IoU (which DLO and the recovery
    # read too), DUO's detections x detections and the duplicate suppression's;
    # StrongSORT's pass 2 (1 - IoU)
    for label, (args, kwargs) in ([("OccluBoost", c) for c in step_calls["occluboost"]["fused_iou_cost"]]
                                  + [("StrongSORT", c) for c in
                                     step_calls["strongsort"]["fused_iou_cost"]]):
        got, want = fused_iou_cost(*args, **kwargs), fused_iou_cost_plain(*args, **kwargs)
        torch.cuda.synchronize()
        if not (got[1] is None and torch.equal(got[0], want[0])):
            raise AssertionError(f"K1 on {label}'s bench step: not bit-equal to the twin")
        print(f"K1 {label} bench step iou-only {tuple(args[0].shape)} x {args[1].shape[1]}: "
              f"bit-equal to the twin")
    # the AABB bench step's own inputs (its two launches, each in its mode)
    calls = []
    for args, kwargs in step_calls["aabb"]["fused_iou_cost"]:
        if len(args) == 2 and torch.equal(*args):
            args = [args[0], args[0]]  # the step passes one box tensor twice
        calls.append(((list(args) + [None])[:3], kwargs))
    card = torch.device("cuda")
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    grids = [(1, 32)]
    for (trk, det, _), _ in calls:
        g = launch_geometry(trk.shape[0], trk.shape[1], det.shape[1], sms)
        grids.append((trk.shape[0] * g.row_blocks, g.quads * g.lanes))
    floors = {(b, t): measure.device_ms(lambda: empty_launch(card, b, t), "empty_kernel")
              for b, t in dict.fromkeys(grids)}
    print("launch floor (an empty kernel through K1's ctypes path, device ms a launch): " +
          ", ".join(f"{b} x {t} threads {ms:.5f}" for (b, t), ms in floors.items()))
    rows = []
    for (trk, det, conf), kw in calls:
        args = [trk, det] if conf is None else [trk, det, conf]
        S, K, D = trk.shape[0], trk.shape[1], det.shape[1]
        row = (measure.device_ms(lambda: fused_iou_cost(*args, **kw), "iou_cost_kernel"),
               measure.event_ms(lambda: fused_iou_cost(*args, **kw)),
               measure.event_ms(lambda: fused_iou_cost_plain(*args, **kw)),
               *k1_bound(trk, det, conf))
        print(f"K1 bench step {'iou-only' if conf is None else 'iou+cost'} (S, K, D) = "
              f"{(S, K, D)}: device {row[0]:.5f} ms a launch, wrapper {row[1]:.5f} ms, plain "
              f"{row[2]:.5f} ms, bound {row[3]:.5f} ms ({row[4]})")
        rows.append(row)
    return timing(0.0, rows)


def timing(worst, rows):
    """A kernel's entry of the kernels line, from its rows of (device ms,
    wrapper ms, plain ms, bound ms, bound_by) at the main path's launches:
    the mean per launch."""
    mean = [statistics.fmean(r[k] for r in rows) for k in range(4)]
    by = max(set(r[4] for r in rows), key=[r[4] for r in rows].count)
    return {"max_abs_err": worst, "ms": mean[0], "wrapper_ms": mean[1], "plain_ms": mean[2],
            "bound_ms": mean[3], "bound_by": by}


def _problem(rng, kind, S=8, R=256, C=128):
    if kind == "dense":
        cost = rng.uniform(0, 1, (S, R, C))
    else:  # IoU-like: most pairs at cost 1; "ties" quantises to eighths
        near = rng.uniform(size=(S, R, C)) < 8.0 / C
        vals = rng.uniform(0, 1, (S, R, C))
        cost = np.where(near, np.round(vals * 8) / 8 if kind == "ties" else vals, 1.0)
    row_mask = rng.uniform(size=(S, R)) < 0.8
    col_mask = rng.uniform(size=(S, C)) < 0.8
    if kind == "masked":
        row_mask[: S // 2] = False  # all-masked problems
        col_mask[S // 2:, 1:] = False  # single-column problems
    return [torch.from_numpy(a).cuda() for a in (cost.astype(np.float32), row_mask, col_mask)]


def k2_bound(cost, row_mask, work):
    """K2's least time for these inputs.  The answer depends on the cost only
    in rows the row mask keeps (a problem with none is all -1 from the mask
    alone), so the bytes are the row masks read and r2c written once, and,
    for a problem with a valid row, its column mask and the cost of its
    valid rows read once; 3 operations a valid row's pair to form w and its
    maximum, and for every pending row of every iteration (``work``,
    counted by the kernel) 3 a column (the net value and the two compares)
    and 4 for the bid."""
    S, R, C = cost.shape
    rows = int(row_mask.sum())
    active = int(row_mask.any(dim=1).sum())
    scanned = int(work[:, 1].sum())
    return measure.bound_ms(5 * S * R + active * C + 4 * rows * C,
                            3 * rows * C + scanned * (3 * C + 4))


def _k2_same(label, cost, rm, cm, thresh):
    S = cost.shape[0]
    caps = [torch.zeros(S, dtype=torch.int32, device="cuda") for _ in range(2)]
    works = [torch.zeros((S, 2), dtype=torch.int32, device="cuda") for _ in range(2)]
    got = masked_assignment(cost, rm, cm, thresh, caps[0], work=works[0])
    want = masked_assignment_plain(cost, rm, cm, thresh, caps[1], work=works[1])
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(caps[0], caps[1])
            and torch.equal(works[0], works[1])):
        raise AssertionError(f"K2 {label}: r2c, capped or work differs from the twin in "
                             f"{int((got != want).sum())} rows")
    path = "shared" if uses_shared_weights(*cost.shape[1:]) else "global"
    print(f"K2 {label} ({path} w): r2c and capped identical, {int((got >= 0).sum())} matches, "
          f"capped {caps[0].tolist()}, iterations {works[0][:, 0].tolist()}")


def check_k2(rng, step_calls):
    """r2c and capped against the twin on both paths: w in shared memory
    (256 x 128, the bench's) and the cost read from global memory (256 x 512,
    a live frame of up to 512 detections)."""
    for S, R, C in ((8, 256, 128), (2, 256, 512)):
        for kind in ("dense", "ties", "masked", "iou-like"):
            _k2_same(f"S={S} {R}x{C} {kind}", *_problem(rng, kind, S=S, R=R, C=C), 0.8)
        # per-problem thresholds (SFSORT's dynamic first pass)
        thresh = torch.linspace(0.3, 0.9, S, device="cuda")
        _k2_same(f"S={S} {R}x{C} per-problem thresholds",
                 *_problem(rng, "iou-like", S=S, R=R, C=C), thresh)
    # OccluBoost's bench step: the first pass, the recovery, GTA and the
    # graveyard (detections x 64 slots), with the per-problem thresholds of
    # the full assignment
    for args, kwargs in step_calls["occluboost"]["masked_assignment"]:
        cost, rm, cm, thresh = args[:4]
        _k2_same(f"OccluBoost bench step {tuple(cost.shape)}", cost, rm, cm, thresh)
    # StrongSORT's bench step: pass 1 (appearance gated by the motion, most
    # costs at the max_cos_dist clamp) and pass 2 (IoU)
    for i, (args, kwargs) in enumerate(step_calls["strongsort"]["masked_assignment"]):
        cost, rm, cm, thresh = args[:4]
        _k2_same(f"StrongSORT bench step pass {i + 1} {tuple(cost.shape)}", cost, rm, cm, thresh)
    rows = []
    for label in ("aabb", "obb"):
        for args, kwargs in step_calls[label]["masked_assignment"]:
            cost = args[0]
            work = torch.zeros((cost.shape[0], 2), dtype=torch.int32, device="cuda")
            masked_assignment(*args, **kwargs, work=work)
            row = (measure.device_ms(lambda: masked_assignment(*args, **kwargs), "auction_kernel"),
                   measure.event_ms(lambda: masked_assignment(*args, **kwargs)),
                   measure.event_ms(lambda: masked_assignment_plain(*args, **kwargs), reps=5,
                                    warmup=1), *k2_bound(cost, args[1], work))
            print(f"K2 {label} bench step {tuple(cost.shape)}: device {row[0]:.5f} ms a launch, "
                  f"wrapper {row[1]:.5f} ms, plain {row[2]:.5f} ms, bound {row[3]:.6f} ms "
                  f"({row[4]}); iterations {work[:, 0].tolist()}, rows scanned "
                  f"{work[:, 1].tolist()}")
            if label == "aabb":
                rows.append(row)
    return timing(0.0, rows)


def _obbs(rng, S, n, span=(1920, 1080), wmax=200.0):
    """Rotated boxes [cx, cy, w, h, theta] (S, n, 5)."""
    b = np.zeros((S, n, 5), np.float32)
    b[..., 0] = rng.uniform(0, span[0], (S, n))
    b[..., 1] = rng.uniform(0, span[1], (S, n))
    b[..., 2:4] = rng.uniform(2, wmax, (S, n, 2))
    b[..., 4] = rng.uniform(-np.pi, np.pi, (S, n))
    return b


def _track_like(rng, S, N, M):
    """Tracks (S, N, 5) and detections (S, M, 5) on a 600 px field, half of
    the detections near a track, with the step's edge cases: empty slots
    (zero area), unit padding boxes, slivers and angles at +-pi/2."""
    a, b = _obbs(rng, S, N, (600, 600)), _obbs(rng, S, M, (600, 600))
    k = min(N, M) // 2
    b[:, :k] = a[:, :k] + rng.normal(0, 3, (S, k, 5)).astype(np.float32)
    for x in (a, b):
        x[:, 0::9] = 0.0
        x[:, 1::9] = [0.0, 0.0, 1.0, 1.0, 0.0]
        x[:, 2::9, 2] = 1e-3
        x[:, 3::9, 4] = np.pi / 2 * np.sign(x[:, 3::9, 4] + 1e-9) - 1e-7
    return a, b


def _degenerate(rng):
    """One problem of the hard cases: identical boxes, quarter turns of
    half-size boxes, slivers across a box, zero-area and point boxes, unit
    padding boxes, boxes sharing centre and angle, angles near +-pi/2 and
    far disjoint boxes."""
    a, b = _obbs(rng, 1, 64, (400, 400)), _obbs(rng, 1, 80, (400, 400))
    b[0, :32] = a[0, :32] + rng.normal(0, 3, (32, 5)).astype(np.float32)
    b[0, 32:40] = a[0, 32:40]
    b[0, 40:44] = a[0, 40:44]
    b[0, 40:44, 2] *= 0.5
    b[0, 40:44, 4] += np.pi / 2
    b[0, 44] = [0, 0, 1, 1, 0]
    b[0, 45] = [a[0, 0, 0], a[0, 0, 1], 1e-3, 300, 1.0]
    b[0, 46:50, 4] = np.pi / 2 * rng.choice([-1, 1], 4) + rng.normal(0, 1e-6, 4)
    b[0, 50:54, :2] = a[0, 50:54, :2]
    b[0, 50:54, 4] = a[0, 50:54, 4]
    b[0, 54] = [1e5, 1e5, 10, 10, 0.3]
    b[0, 55] = 0.0
    a[0, 44] = 0.0
    a[0, 45, 2] = 0.0
    a[0, 46] = [0, 0, 1, 1, 0]
    return a, b


def crossed_quads(rng, n, size=4.0):
    """Boxes (n, 5) whose corners (n, 4, 2) are drawn at random around the
    centre, so that most quadrilaterals cross themselves, as rounding can bend
    a near-collinear sliver's corners across each other.  A half-plane then
    cuts such a list in more than two places, and now and then a stage emits
    more than K3's fast path holds (8 vertices): the slow path's set."""
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = rng.normal(0, 1, (n, 2))
    b[:, 2:4] = size
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    c = b[:, None, :2] + rng.normal(0, 1, (n, 4, 2))
    return b, c.astype(np.float32)


def _twin_in_row_chunks(a, b, c1, c2, rows=256):
    """The twin over row chunks, so its (rows, M, 64) slot temporaries fit."""
    return torch.cat([rotated_iou_plain(a[:, i:i + rows], b, c1[:, i:i + rows], c2)
                      for i in range(0, a.shape[1], rows)], dim=1)


def k3_bound(a, b, ops):
    """K3's least time for these inputs: 13 floats read once per box, one IoU
    written once per pair; the operations are those the counting
    instantiation added up for each pair (its centring, clip walk and
    quotient, not the kernel's reject test), plus 1 a box (its area) and 17
    a clip box (its winding)."""
    S, N, M = ops.shape
    return measure.bound_ms(52 * S * (N + M) + 4 * S * N * M,
                            int(ops.sum(dtype=torch.int64)) + S * (N + 18 * M))


def check_k3(rng, step_calls):
    """K3 against its twin, both given the same corners (computed once on the
    card), so the comparison tests the clip and not the trig; bit-equal on
    every set, the crossed quadrilaterals' slow path included."""
    cases = [("tracker", *_track_like(rng, 8, 256, 128)), ("ragged", *_track_like(rng, 1, 1, 3)),
             ("ragged", *_track_like(rng, 2, 200, 77)), ("degenerate", *_degenerate(rng)),
             ("4096^2", _obbs(rng, 1, 4096), _obbs(rng, 1, 4096))]
    (qa, ca), (qb, cb) = crossed_quads(rng, 256), crossed_quads(rng, 256)
    cases.append(("crossed (overflow)", qa[None], qb[None], ca[None], cb[None]))
    timed = {}
    for kind, a, b, *corners in cases:
        a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        c1, c2 = ([torch.from_numpy(c).cuda() for c in corners] if corners
                  else [obb_corners(x).contiguous() for x in (a, b)])
        got = rotated_iou(a, b, c1, c2)
        counted, ops, slow = rotated_iou_counted(a, b, c1, c2)
        big = a.shape[1] * b.shape[1] > 1 << 20
        want = (_twin_in_row_chunks if big else rotated_iou_plain)(a, b, c1, c2)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(counted, want)):
            err = float((got - want).abs().max())
            raise AssertionError(f"K3 {kind} {tuple(got.shape)}: not bit-equal to the twin "
                                 f"(max abs err {err})")
        print(f"K3 {kind} S,N,M={tuple(got.shape)}: bit-equal to the twin, pairs on the slow "
              f"path: {slow}, pairs with IoU > 0.05: {int((got > 0.05).sum())}")
        if kind.startswith("crossed") and slow == 0:
            raise AssertionError("K3: the crossed quadrilaterals never took the slow path")
        if kind == "degenerate":
            self_iou = torch.diagonal(rotated_iou(a, a, c1, c1)[0])
            if not ((self_iou[:44] > 0.999).all() and float(got[0, 0, 54]) == 0.0):
                raise AssertionError("K3: self-IoU <= 0.999 or a disjoint pair > 0")
        if kind == "4096^2":
            timed[kind] = (a, b, c1, c2, ops)
    # OccluBoost's oriented bench step: the association (detections x tracks),
    # the recovery's tracks x detections and the duplicate suppression's
    for args, _ in step_calls["occluboost_obb"]["rotated_iou"]:
        got, want = rotated_iou(*args), rotated_iou_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("K3 on OccluBoost's oriented bench step: not bit-equal")
        print(f"K3 OccluBoost OBB bench step {tuple(args[0].shape)} x {args[1].shape[1]}: "
              f"bit-equal to the twin")
    # the OBB bench step's own inputs (its two launches), with their corners
    for args, _ in step_calls["obb"]["rotated_iou"]:
        a, b = args[0], args[1]
        c1, c2 = (obb_corners(x).contiguous() for x in (a, b))
        timed[f"bench step {tuple(a.shape[:2])} x {b.shape[1]}"] = (
            a, b, c1, c2, rotated_iou_counted(a, b, c1, c2)[1])
    rows = []
    for kind, (a, b, c1, c2, ops) in timed.items():
        big = kind == "4096^2"
        twin = _twin_in_row_chunks if big else rotated_iou_plain
        row = (measure.device_ms(lambda: rotated_iou(a, b, c1, c2), "rotated_iou_kernel",
                                 reps=5 if big else 20),
               measure.event_ms(lambda: rotated_iou(a, b, c1, c2), reps=5 if big else 50),
               measure.event_ms(lambda: twin(a, b, c1, c2), reps=3 if big else 20, warmup=1),
               *k3_bound(a, b, ops))
        print(f"K3 {kind}: device {row[0]:.5f} ms a launch, wrapper {row[1]:.5f} ms, plain "
              f"{row[2]:.4f} ms, bound {row[3]:.5f} ms ({row[4]}), "
              f"{int(ops.sum(dtype=torch.int64))} operations counted")
        if not big:
            rows.append(row)
    return timing(0.0, rows)


def bench_step_calls():
    """The arguments of every kernel launch of one steady bench step (frame
    64 of 256), AABB and OBB ByteTrack at the bench shape, of the ORU
    launch of an OC-SORT AABB bench step (with MISS of the detections
    missed), of BoT-SORT's IoU launches and of DeepOCSORT's ORU launch on
    the appearance bench inputs (embeddings and warps; DeepOCSORT with MISS
    missed), and of OccluBoost's IoU launches and auctions (the graveyard's
    detections x 64 slots among them) at ``OccluBoostConfig()``, the bench's,
    on the appearance inputs and, oriented, on turning rotated boxes, and of
    StrongSORT's IoU launch and two auctions and HybridSORT's XYSCR ORU launch
    (MISS missed) at their YAML tiers on the appearance inputs, recorded
    so that phase 3 checks and times each kernel on the inputs the main path
    gives it."""
    def frames(frames_fn, cols):
        packed = [pack_frames(frames_fn(65, N_DETS, seed=100 + s), D=D_BENCH, F=65,
                              det_cols=cols)[0] for s in range(N_SEQS)]
        return torch.from_numpy(np.stack(packed)).cuda(), None, None

    def obb_frames():
        return frames(lambda n, d, seed: synthetic_obb_frames(n, d, seed=seed, miss=0.0), 7)

    calls = {}
    auctions = ((ocsort, ("masked_assignment",)), (occluboost, ("masked_assignment",)))
    for label, cfg, inputs, records in (
            ("aabb", ByteTrackConfig(capacity=CAPACITY), lambda: frames(synthetic_frames, 6),
             [(bytetrack, ("fused_iou_cost", "masked_assignment"))]),
            ("obb", ByteTrackConfig(capacity=CAPACITY, is_obb=True), obb_frames,
             [(bytetrack, ("rotated_iou", "masked_assignment"))]),
            ("ocsort", OcSortConfig(capacity=CAPACITY), lambda: frames(synthetic_frames_missed, 6),
             [(ocsort, ("oru_replay",))]),
            ("botsort", build_replay_config("botsort"),
             lambda: appearance_batch(N_SEQS, 65, N_DETS, 100, 0.0, "cuda"),
             [(botsort, ("fused_iou_cost",))]),
            ("deepocsort", build_replay_config("deepocsort"),
             lambda: appearance_batch(N_SEQS, 65, N_DETS, 100, MISS, "cuda"),
             [(deepocsort, ("oru_replay",))]),
            ("occluboost", OccluBoostConfig(capacity=CAPACITY),
             lambda: appearance_batch(N_SEQS, 65, N_DETS, 100, MISS, "cuda"),
             [(boosttrack, ("fused_iou_cost",)), *auctions]),
            ("occluboost_obb", OccluBoostConfig(capacity=CAPACITY, is_obb=True), obb_frames,
             [(occluboost, ("rotated_iou",))]),
            ("strongsort", build_replay_config("strongsort", capacity=CAPACITY),
             lambda: appearance_batch(N_SEQS, 65, N_DETS, 100, 0.0, "cuda"),
             [(strongsort, ("fused_iou_cost",)), (ocsort, ("masked_assignment",))]),
            ("hybridsort", build_replay_config("hybridsort", capacity=CAPACITY),
             lambda: appearance_batch(N_SEQS, 65, N_DETS, 100, MISS, "cuda"),
             [(hybridsort, ("oru_replay",))])):
        batch, embs, warps = inputs()
        head = (None, None) if embs is None else (embs[:, :64], warps[:, :64])
        tail = (None, None) if embs is None else (embs[:, 64:], warps[:, 64:])
        states, _, _ = batch_replay(cfg, init_states(cfg, N_SEQS, "cuda"), batch[:, :64], None,
                                    *head)
        rec = {}
        with contextlib.ExitStack() as stack:
            recs = [stack.enter_context(measure.record_calls(m, names)) for m, names in records]
            batch_replay(cfg, states, batch[:, 64:], None, *tail)
        for r in recs:
            for name, v in r.items():
                rec.setdefault(name, []).extend(v)
        calls[label] = rec
        print(f"bench step {label}: " + ", ".join(
            f"{n} x {len(v)} {[tuple(next(x for x in a if torch.is_tensor(x)).shape) for a, _ in v]}"
            for n, v in rec.items()))
    return calls


def _k4_same(label, layout, tensors, rejoin, gap):
    """K4 on the card against its twin on the CPU, the same inputs: mean,
    covariance and the replayed count bit-equal.  Returns the number of
    rejoining slots."""
    S = rejoin.shape[0]
    card = [t.cuda() for t in (*tensors, rejoin, gap)]
    replayed = [torch.zeros(S, dtype=torch.int32, device=d) for d in ("cuda", "cpu")]
    got = oru_replay(layout, *card, replayed[0])
    want = oru_replay_plain(layout, *(t.cpu() for t in (*tensors, rejoin, gap)), replayed[1])
    torch.cuda.synchronize()
    same = [torch.equal(g.cpu(), w) for g, w in zip((*got, replayed[0]), (*want, replayed[1]))]
    n = int(rejoin.sum())
    if not all(same):
        bad = (got[0].cpu() != want[0]).any(-1) | (got[1].cpu() != want[1]).flatten(2).any(-1)
        raise AssertionError(f"K4 {label}: not bit-equal to the twin (mean {same[0]}, cov "
                             f"{same[1]}, replayed {same[2]}; {int(bad.sum())} of {n} slots)")
    gaps = f"{int(gap[rejoin].min())}-{int(gap[rejoin].max())}" if n else "none"
    print(f"K4 {label} (S, K) = {tuple(rejoin.shape)}: bit-equal to the twin on the CPU, {n} "
          f"slots rejoin, gaps {gaps}")
    return n


def _k4_predict_ops(dx):
    """Operations of one predict as K4 does them: an add per position with a
    velocity (3 in XYSR, 4 in the 9-state layouts) for the mean and per such
    row and column of F P F^T, the noise's dx * dx adds (an exact zero off the
    diagonal) and the clamps of s and r."""
    vel = 3 if dx == 7 else 4
    return vel + 2 * vel * dx + dx * dx + 2


def _k4_update_ops(dx, dz, kind=None):
    """Operations of one interpolated measurement and masked Joseph-form
    update as K4 does them (a sum over an index counts each product and add,
    exact zeros included); ``kind``, the layout's name, defaults to XYSR-OBB
    for dz = 5."""
    kind = kind or ("xysr_obb" if dz == 5 else "xysr")
    ops = dz * dz  # the innovation covariance
    ops += sum(2 * j + 1 for i in range(dz) for j in range(i + 1))  # Cholesky
    ops += sum(1 + sum(2 * (i - j) + 1 for j in range(i)) for i in range(dz))  # its inverse
    ops += dz * dz * (2 * dz - 1) + dx * dz * (2 * dz - 1)  # Sinv = M^T M, the gain
    ops += dz + dx * (2 * dz - 1) + dx + 2  # innovation, delta, mean, clamps
    ops += dx * dz + 2 * dx * dx * (2 * dx - 1)  # I - K H, (I - K H) P (I - K H)^T
    ops += dx * dz + dx * dx * (2 * dz - 1) + dx * dx  # K R K^T, added
    ops += 14  # the interpolated x, y, w, h, s and r
    if kind == "xysr_obb":
        ops += 6 + 4 * 12 + 3 + 1  # the angle, the four candidates, the pick, the damping
    elif kind == "xyscr":
        ops += 2  # the interpolated confidence
    return ops


def k4_bytes(layout, rejoin):
    """Bytes K4's function must move.  It is out of place: every slot's mean
    and covariance is written once and read once, from the frame's predict
    where the slot does not rejoin and from the frozen state where it does;
    a rejoining slot also reads its last and new measurements and its gap.
    Every rejoin flag is read, and ``replayed`` (S,) read and written."""
    dx, dz = layout.dx, layout.dz
    S, K = rejoin.shape
    return S * K * (1 + 8 * (dx + dx * dx)) + int(rejoin.sum()) * 4 * (2 * dz + 1) + 8 * S


def k4_bound(layout, rejoin, gap):
    """K4's least time for these inputs: ``k4_bytes`` over the memory rate,
    or the operations of each rejoining slot's min(gap, MAX_ORU) updates and
    the predicts between them over the float32 rate."""
    dx, dz = layout.dx, layout.dz
    n = torch.clamp(torch.where(rejoin, gap, 0), max=MAX_ORU).cpu().to(torch.int64)
    slots, updates = int((n > 0).sum()), int(n.sum())
    return measure.bound_ms(k4_bytes(layout, rejoin), updates * _k4_update_ops(dx, dz, layout.name)
                            + (updates - slots) * _k4_predict_ops(dx))


def _k4_row(label, layout, card):
    """One timing row of K4 on inputs already on the card: its device time a
    launch, its wrapper's, the plain version's (the same twin, run on the
    card) and the counted bound."""
    S = card[-2].shape[0]
    replayed = torch.zeros(S, dtype=torch.int32, device="cuda")
    row = (measure.device_ms(lambda: oru_replay(layout, *card, replayed), "oru_kernel"),
           measure.event_ms(lambda: oru_replay(layout, *card, replayed)),
           measure.event_ms(lambda: oru_replay_plain(layout, *card, replayed), reps=5, warmup=1),
           *k4_bound(layout, card[-2], card[-1]))
    print(f"K4 {label}: device {row[0]:.5f} ms a launch, wrapper {row[1]:.5f} ms, plain "
          f"{row[2]:.4f} ms (on the card), bound {row[3]:.6f} ms ({row[4]}), "
          f"{int(card[-2].sum())} slots rejoin")
    return row


def check_k4(rng, step_calls):
    """K4 (the ORU) bit-equal to its twin run on the CPU, on each of its
    layouts (XYSR, XYSR-OBB, XYSCR): at the bench's S x K where every slot
    rejoins with gaps 2-31, on a ragged S with half the slots rejoining and
    gaps up to 40 (past MAX_ORU), on its edge sets (``oru_edge_inputs``) and
    on a recorded OC-SORT, DeepOCSORT and HybridSORT bench step; then the
    kernel timed on the OC-SORT step's inputs, and on the all-rejoin sets,
    and its XYSCR instance on the HybridSORT step's, each beside its
    wrapper, the plain version (the same twin, run on the card) and the
    bound.  Returns the OC-SORT step's timing entry and the XYSCR rows."""
    sets = {}
    for kind, obb in (("AABB", False), ("OBB", True), ("XYSCR", "xyscr")):
        for label, args in ((f"{kind} all rejoin", (N_SEQS, CAPACITY, obb)),
                            (f"{kind} ragged", (3, 77, obb, 0.5, 40))):
            layout, tensors, rejoin, gap = oru_inputs(rng, *args)
            _k4_same(label, layout, tensors, rejoin, gap)
            sets[label] = (layout, [t.cuda() for t in (*tensors, rejoin, gap)])
        print(f"K4 {kind} launch at (S, K) = ({N_SEQS}, {CAPACITY}): "
              f"{k4_geometry(N_SEQS, CAPACITY, layout.name)} (blocks, threads, shared bytes a "
              f"block)")
    for edge, obb in ORU_EDGES + XYSCR_EDGES:
        kind = {False: "AABB", True: "OBB"}.get(obb, "XYSCR")
        _k4_same(f"{kind} {edge}", *oru_edge_inputs(rng, edge, obb))
    for i, (args, _) in enumerate(step_calls["ocsort"]["oru_replay"]):
        layout, tensors, rejoin, gap = args[0], args[1:7], args[7], args[8]
        _k4_same(f"OC-SORT bench step {i}", layout, [t.cpu() for t in tensors], rejoin.cpu(),
                 gap.cpu())
        sets[f"OC-SORT bench step {i}"] = (layout, list(args[1:9]))
    for tracker, name in (("deepocsort", "DeepOCSORT"), ("hybridsort", "HybridSORT")):
        for i, (args, _) in enumerate(step_calls[tracker]["oru_replay"]):
            n = _k4_same(f"{name} bench step {i}", args[0], [t.cpu() for t in args[1:7]],
                         args[7].cpu(), args[8].cpu())
            if not n:
                raise AssertionError(f"K4: no slot rejoined at the recorded {name} step")
            if tracker == "hybridsort":
                sets[f"HybridSORT bench step {i}"] = (args[0], list(args[1:9]))
    rows, xyscr = [], []
    for label in ([k for k in sets if k.startswith("OC-SORT")][:1]
                  + ["AABB all rejoin", "OBB all rejoin", "XYSCR all rejoin"]
                  + [k for k in sets if k.startswith("HybridSORT")][:1]):
        row = _k4_row(label, *sets[label])
        if label.startswith("OC-SORT"):
            rows.append(row)
        if label.startswith(("XYSCR", "HybridSORT")):
            xyscr.append((label, row))
    return timing(0.0, rows), xyscr


def check_kalman_obb(rng):
    """The OBB Kalman bank (unrolled 5x5 Cholesky, Joseph update, angle
    alignment) gives the same bits on the card as on the CPU."""
    layout = kalman.make_xywh_layout(True)
    z = torch.from_numpy(_obbs(rng, 8, 256))
    mean, cov = kalman.initiate(layout, z)
    mask = torch.from_numpy(rng.uniform(size=(8, 256)) < 0.8)
    meas = torch.from_numpy(_obbs(rng, 8, 256) * np.float32(0.01)) + z
    out = {}
    for dev in ("cpu", "cuda"):
        m, c, k, zz = (t.to(dev) for t in (mean, cov, mask, meas))
        m, c = kalman.predict(layout, m, c, k)
        sinv = kalman.inv_psd_small(c[..., :5, :5] + torch.eye(5, device=dev))
        m, c = kalman.update(layout, m, c, kalman.align_obb_to_ref(zz, m[..., :5]), k)
        out[dev] = [t.cpu() for t in (sinv, m, c)]
    same = [torch.equal(x, y) for x, y in zip(out["cpu"], out["cuda"])]
    print(f"OBB Kalman bank cuda vs cpu, bit-equal: inverse {same[0]}, mean {same[1]}, cov {same[2]}")
    if not all(same):
        raise AssertionError("the OBB Kalman bank differs between the card and the CPU")


def drive(label, fn, ratio, sync_free=True):
    """Drive one path with every launch counter at 0; ``ratio`` gives the
    fixed launches per step of the kernels the path must run (others must
    not run at all; an empty ratio, a host tracker's, lets none run).  A ``sync_free`` path runs under
    set_sync_debug_mode("error"), so any host sync in it raises."""
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
    torch.cuda.set_sync_debug_mode("error" if sync_free else 0)
    try:
        result = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = {name: wrapper.launches for name, (wrapper, _, _) in KERNELS.items()}
    print(f"launches in {label}: {counts}")
    steps = {counts[k] / w for k, w in ratio.items()}
    if ratio and (min(counts[k] for k in ratio) <= 0 or len(steps) != 1):
        raise AssertionError(f"{label}: launches {counts} are not {ratio} per step")
    if any(counts[k] for k in counts if k not in ratio):
        raise AssertionError(f"{label}: a kernel outside the path launched: {counts}")
    for k, v in counts.items():
        LAUNCHES[k] += v
    return result


def _mot_rows(out_dir: Path) -> dict:
    """{sequence: rows} of the files an eval wrote to ``out_dir``."""
    return {p.stem: np.loadtxt(p, delimiter=",", ndmin=2) for p in sorted(out_dir.glob("*.txt"))}


def check_sync_mode_is_live():
    """A host sync under set_sync_debug_mode("error") must raise here."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.zeros(1, device="cuda").item()
    except RuntimeError:
        pass
    else:
        raise AssertionError("set_sync_debug_mode('error') let a host sync through")
    finally:
        torch.cuda.set_sync_debug_mode(0)


def cpu_job(kind, tracker, arg):
    """A CPU reference of phases 4-5, run in a worker process while the card
    works: for kind "eval", the MOT rows of ``run_eval`` of ``tracker`` on
    fixture ``arg``; for "obb", the corner rows of ``run_eval_obb`` on
    mmot-mini and the tracks of its replay; for "reid", the replay outputs of
    the cache-fed config (``REID_PARAMS``) over the seeded caches under
    ``arg`` (``reid_caches``), for OccluBoost with each sequence's gap rows
    and resurrections from its final state."""
    torch.set_num_threads(1)
    if kind == "eval":
        with tempfile.TemporaryDirectory() as tmp:
            boxmot_tpu_torch.run_eval(ROOTS[arg], tracker, device="cpu", output_dir=Path(tmp))
            return _mot_rows(Path(tmp))
    if kind == "obb":
        with tempfile.TemporaryDirectory() as tmp:
            boxmot_tpu_torch.run_eval_obb(MMOT_ROOT, tracker, device="cpu", output_dir=Path(tmp))
            rows = _mot_rows(Path(tmp))
        cfg = build_replay_config(tracker, is_obb=True)
        seqs = [{"dets": d} for d in mmot_obb_dets(MMOT_ROOT).values()]
        return rows, replay_sequences_outputs(cfg, seqs, device="cpu")
    cfg = build_replay_config(tracker, **REID_PARAMS.get(tracker, {}))
    if tracker != "occluboost":
        return replay_sequences_outputs(cfg, _reid_inputs(Path(arg)), device="cpu")
    return [(o, m, occluboost.flush_gta_rows(st), int(st.resurrections.sum())) for o, m, st in
            replay_sequences_outputs(cfg, _reid_inputs(Path(arg)), device="cpu", with_states=True)]


# the cache-fed evals of phase 4b-d: tracker -> its replay config's parameters
# (OccluBoost's of tests/test_emb_cache_eval.py: GTA on)
REID_PARAMS = {"botsort": {}, "occluboost": {"gta_enabled": True, "max_age": 10,
                                             "gta_min_track_length": 3},
               "strongsort": {}, "hybridsort": {}}
APPEARANCE_EVALS = ("strongsort", "hybridsort")
CPU_WORKERS = 6


def start_cpu_references(pool, cache_root: Path) -> dict:
    """Submit every CPU reference of phases 4-5: the three longest first
    (HybridSORT's and StrongSORT's cache-fed replays, StrongSORT's synth-long
    eval, needed late), then the rest in the order the phases read them."""
    jobs = {}

    def submit(kind, tracker, arg, key=None):
        jobs[kind, tracker, key] = pool.submit(cpu_job, kind, tracker, arg)

    submit("reid", "hybridsort", str(cache_root))
    submit("reid", "strongsort", str(cache_root))
    submit("eval", "strongsort", "synth_long", "synth_long")
    for name, tracker in sorted(PINNED):
        if (name, tracker) != ("synth_long", "strongsort"):
            submit("eval", tracker, name, name)
    submit("reid", "botsort", str(cache_root))
    submit("reid", "occluboost", str(cache_root))
    for tracker in OBB_EVAL:
        submit("obb", tracker, None)
    return jobs


def _cpu_result(cpu_jobs, key):
    """A CPU reference's result, and the seconds the card waited for it."""
    t0 = time.perf_counter()
    return cpu_jobs[key].result(), time.perf_counter() - t0


def run_aabb_evals(cpu_jobs):
    """Phase 4: run_eval for the ten trackers on both fixtures, held to the
    pins, with their MOT rows held against the same evals on the CPU (which
    the workers of ``cpu_jobs`` made)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        for (name, tracker), want in sorted(PINNED.items()):
            t0 = time.perf_counter()
            res = drive(f"run_eval {tracker} {name}", lambda: boxmot_tpu_torch.run_eval(
                ROOTS[name], tracker, device="cuda", output_dir=out / "cuda" / tracker / name),
                RATIOS[tracker][0])
            seconds = time.perf_counter() - t0
            got = {k: float(res["combined"][k]) for k in ("HOTA", "MOTA", "IDF1")}
            print(f"eval {tracker} {name} on cuda: {got} in {seconds:.3f} s (pins {want})")
            for k, v in want.items():
                if not abs(got[k] - v) <= ATOL:
                    raise AssertionError(f"{tracker} {name} {k} = {got[k]} misses the pin {v}")
            # the card's MOT rows against the same eval on the CPU (a worker's)
            cpu, waited = _cpu_result(cpu_jobs, ("eval", tracker, name))
            if waited > 0.05:
                print(f"waited {waited:.1f} s for the cpu rows of {tracker} {name}")
            gpu = _mot_rows(out / "cuda" / tracker / name)
            if gpu.keys() != cpu.keys() or not gpu:
                raise AssertionError(f"{name}: cuda wrote {sorted(gpu)}, cpu wrote {sorted(cpu)}")
            for seq, g in gpu.items():
                c = cpu[seq]
                keys = [0, 1, 6, 7, 8]  # frame, id, conf, cls, det_ind
                if g.shape != c.shape or not np.array_equal(g[:, keys], c[:, keys]):
                    raise AssertionError(f"{tracker} {seq}: MOT rows differ between cuda and cpu")
                box = float(np.abs(g[:, 2:6] - c[:, 2:6]).max(initial=0.0))
                if not (np.isfinite(g).all() and box <= 1.0):  # boxes are whole pixels
                    raise AssertionError(f"{seq}: MOT boxes differ by {box} px between cuda and cpu")
                host = " (a host tracker: equal by construction)" if tracker in HOST_TRACKERS else ""
                print(f"{tracker} {seq} rows cuda vs cpu: {len(g)} rows, all equal: "
                      f"{np.array_equal(g, c)}{host}")
                if tracker in BIT_EQUAL_EVALS and not np.array_equal(g, c):
                    raise AssertionError(f"{tracker} {seq}: MOT rows not bit-equal to the CPU's")


def _reid_inputs(root: Path):
    """run_eval's replay inputs from ``reid_caches``: per sequence the
    detections, embeddings and warps, loaded by the port's cache loaders."""
    from boxmot_tpu_torch.data.cache import (det_cache_path, emb_cache_path,
                                             load_cached_dets_per_frame,
                                             load_cached_embs_per_frame,
                                             load_cached_warps_per_frame, warp_cache_path)
    from boxmot_tpu_torch.data.mot import MOTDataset

    return [{"dets": load_cached_dets_per_frame(det_cache_path(root, REID_DETECTOR, q.name),
                                                q.seq_length),
             "embs": load_cached_embs_per_frame(emb_cache_path(root, REID_DETECTOR, REID, q.name),
                                                q.seq_length),
             "warps": load_cached_warps_per_frame(warp_cache_path(root, "ecc", q.name),
                                                  q.seq_length)}
            for q in MOTDataset(ROOTS["synth_long"])]


def _replay_metrics(outputs) -> dict:
    """HOTA/MOTA/IDF1 of synth-long from replay outputs, as run_eval scores
    its MOT rows."""
    from boxmot_tpu_torch.data.mot import MOTDataset
    from boxmot_tpu_torch.engine.metrics.mot_metrics import evaluate_sequences, preprocess_sequence
    from boxmot_tpu_torch.engine.replay import _unpack_mot_rows

    data = {q.name: preprocess_sequence(q.gt(), _unpack_mot_rows(o[0], o[1], len(o[0])).astype(
        np.float64), q.seq_length) for q, o in zip(MOTDataset(ROOTS["synth_long"]), outputs)}
    c = evaluate_sequences(data)["combined"]
    return {k: float(c[k]) for k in ("HOTA", "MOTA", "IDF1")}


def run_occluboost_gta_eval(root: Path, cpu_jobs):
    """Phase 4c: OccluBoost's run_eval over the seeded synth-long embedding
    (512-d) and warp caches under ``root`` with GTA on
    (``REID_PARAMS["occluboost"]``), against the same replay on the CPU (a
    worker's; metrics equal; ids, masks, cls and det_ind exact, boxes and
    conf within 1e-4) and a motion-only run, which must differ; the
    graveyard resurrections and gap rows of the final states
    (``flush_gta_rows``), and the smallest margin between a similarity of
    the card's run and an appearance gate."""
    params = REID_PARAMS["occluboost"]
    cfg = build_replay_config("occluboost", **params)
    kw = dict(cache_root=root, detector=REID_DETECTOR, reid=REID, cmc_method="ecc",
              tracker_params=params)
    t0 = time.perf_counter()
    res = drive("run_eval occluboost synth_long reid + cmc + GTA",
                lambda: boxmot_tpu_torch.run_eval(ROOTS["synth_long"], "occluboost",
                                                  device="cuda", **kw), boost_ratio(cfg))
    seconds = time.perf_counter() - t0
    motion = boxmot_tpu_torch.run_eval(
        ROOTS["synth_long"], "occluboost", device="cuda",
        **{**kw, "tracker_params": {**params, "with_reid": False}})
    with measure.record_calls(occluboost, ["emb_products"]) as rec:
        gpu = replay_sequences_outputs(cfg, _reid_inputs(root), device="cuda", with_states=True)
    cpu, waited = _cpu_result(cpu_jobs, ("reid", "occluboost", None))
    got, want, plain = ({k: float(r["combined"][k]) for k in ("HOTA", "MOTA", "IDF1")}
                        for r in (res, {"combined": _replay_metrics(cpu)}, motion))
    print(f"eval occluboost synth_long with embeddings, warps and GTA on cuda: {got} in "
          f"{seconds:.3f} s (cpu replay {want}, waited {waited:.1f} s for it; motion-only "
          f"{plain})")
    if got != want:
        raise AssertionError("OccluBoost with GTA: cuda metrics differ from cpu")
    if got == plain:
        raise AssertionError("OccluBoost with GTA: the same metrics as the motion-only run")
    resurrected = gap_rows = 0
    for (go, gm, gs), (co, cm, rows_c, resurrected_c) in zip(gpu, cpu):
        box = float(np.abs(go[gm][:, :4] - co[cm][:, :4]).max(initial=0.0))
        conf = float(np.abs(go[gm][:, 5] - co[cm][:, 5]).max(initial=0.0))
        exact = [4, 6, 7]  # id, cls, det_ind
        if not (np.array_equal(gm, cm) and np.array_equal(go[gm][:, exact], co[cm][:, exact])
                and box <= 1e-4 and conf <= 1e-4):
            raise AssertionError(f"OccluBoost with GTA: tracks differ cuda vs cpu (box {box})")
        rows_g = occluboost.flush_gta_rows(gs)
        if (rows_g.shape != rows_c.shape or not np.array_equal(rows_g[:, :2], rows_c[:, :2])
                or int(gs.resurrections.sum()) != resurrected_c):
            raise AssertionError("OccluBoost with GTA: gap rows or resurrections differ cuda vs cpu")
        resurrected += int(gs.resurrections.sum())
        gap_rows += len(rows_g)
    if resurrected == 0:
        raise AssertionError("OccluBoost with GTA: no track was resurrected")
    thresholds = (cfg.recovery_appearance_thresh, cfg.second_appearance_thresh,
                  cfg.gta_appearance_thresh, 0.75)
    margin = min(float(min(torch.abs(p - t).min() for t in thresholds))
                 for p in (occluboost.emb_products(*a) for a, _ in rec["emb_products"]))
    rows = sum(int(m.sum()) for _, m, _ in gpu)
    print(f"OccluBoost with GTA replay tracks cuda vs cpu: {rows} rows, masks, ids, cls, det_ind "
          f"equal, max box diff {box:.3g} px; {resurrected} graveyard resurrections, {gap_rows} "
          f"gap rows (GP-smoothed), equal frames and ids on both; smallest margin of a "
          f"similarity to an appearance gate over {len(rec['emb_products'])} products: "
          f"{margin:.3g}")


class _Outputs:
    """Within the block, ``module.<name>`` (a function of a step whose output
    nothing writes to afterwards) keeps each of its outputs in ``self.outs``."""

    def __init__(self, module, name):
        self.module, self.name, self.outs = module, name, []

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)
        setattr(self.module, self.name,
                lambda *a, **k: self.outs.append(real(*a, **k)) or self.outs[-1])
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def _appearance_margin(tracker, cfg, seqs):
    """The card's replay outputs of ``cfg`` over ``seqs`` and the smallest
    margin of an appearance distance to the decision it feeds: BoT-SORT's to
    its appearance threshold (scaled and not), StrongSORT's fused cost of a
    gated pair to ``max_cos_dist``, HybridSORT's EMA-feature distance to the
    long-term correction's threshold.  Returns (outputs, margin, what, n)."""
    if tracker == "botsort":
        with _Outputs(botsort, "appearance_distance") as dist:
            gpu = replay_sequences_outputs(cfg, seqs, device="cuda")
        thr, scale = cfg.appearance_thresh, cfg.unconfirmed_emb_scale
        margin = min(float(torch.minimum(torch.abs(d - thr), torch.abs(d / scale - thr)).min())
                     for d in dist.outs)
        return gpu, margin, "an appearance distance to its threshold", len(dist.outs)
    if tracker == "strongsort":
        with _Outputs(strongsort, "appearance_cost") as app, _Outputs(kalman, "gating_distance") as gate:
            gpu = replay_sequences_outputs(cfg, seqs, device="cuda")
        gated = [torch.abs(cfg.mc_lambda * a + (1 - cfg.mc_lambda) * g - cfg.max_cos_dist)[
            (g <= strongsort.CHI2_4) & (a < strongsort.INFTY)] for a, g in zip(app.outs, gate.outs)]
        margin = min(float(d.min()) for d in gated if d.numel())
        return gpu, margin, "a gated pair's fused cost to max_cos_dist", len(app.outs)
    # the EMA features' distances only, not the long-term features'
    with _Outputs(hybridsort, "_emb_dist") as emb, _Outputs(hybridsort, "_longterm_dist") as lt:
        gpu = replay_sequences_outputs(cfg, seqs, device="cuda")
    longterm = {id(x) for x in lt.outs}
    dists = [e for e in emb.outs if id(e) not in longterm]
    thr = cfg.longterm_reid_correction_thresh
    margin = min(float(torch.abs(e - thr).min()) for e in dists)
    return gpu, margin, "an EMA feature's distance to the correction threshold", len(dists)


def run_appearance_eval(tracker, root: Path, cpu_jobs):
    """Phases 4b and 4d: BoT-SORT's, StrongSORT's or HybridSORT's run_eval
    with ``reid`` and ``cmc_method`` over the seeded synth-long caches under
    ``root`` (512-d), against the same replay on the CPU (a worker's):
    metrics equal, masks, ids, conf, cls and det_ind exact, boxes within 1e-4
    px; and the smallest margin of an appearance distance to the decision it
    feeds (``_appearance_margin``), since the card's products sum in another
    order than the CPU's."""
    kw = dict(cache_root=root, detector=REID_DETECTOR, reid=REID, cmc_method="ecc")
    cfg = build_replay_config(tracker)
    ratio = hybrid_ratio(cfg) if tracker == "hybridsort" else RATIOS[tracker][0]
    t0 = time.perf_counter()
    res = drive(f"run_eval {tracker} synth_long reid + cmc", lambda: boxmot_tpu_torch.run_eval(
        ROOTS["synth_long"], tracker, device="cuda", **kw), ratio)
    seconds = time.perf_counter() - t0
    gpu, margin, what, n = _appearance_margin(tracker, cfg, _reid_inputs(root))
    cpu, waited = _cpu_result(cpu_jobs, ("reid", tracker, None))
    got = {k: float(res["combined"][k]) for k in ("HOTA", "MOTA", "IDF1")}
    want = _replay_metrics(cpu)
    print(f"eval {tracker} synth_long with embeddings and warps on cuda: {got} in {seconds:.3f} s "
          f"(cpu replay {want}, waited {waited:.1f} s for it)")
    if got != want:
        raise AssertionError(f"{tracker} with embeddings and warps: cuda metrics differ from cpu")
    worst = 0.0
    for (go, gm), (co, cm) in zip(gpu, cpu):
        box = float(np.abs(go[gm][:, :4] - co[cm][:, :4]).max(initial=0.0))
        worst = max(worst, box)
        if not (np.array_equal(gm, cm) and np.array_equal(go[gm][:, 4:], co[cm][:, 4:])
                and box <= 1e-4):
            raise AssertionError(f"{tracker} with embeddings: tracks differ cuda vs cpu (box {box})")
    rows = sum(int(m.sum()) for _, m in gpu)
    print(f"{tracker} with embeddings replay tracks cuda vs cpu: {rows} rows, masks, ids, conf, "
          f"cls, det_ind equal, max box diff {worst:.3g} px; smallest margin of {what} over {n} "
          f"products: {margin:.3g}")


def run_obb_evals(cpu_jobs):
    """Phase 5: run_eval_obb for ByteTrack, SFSORT, OC-SORT, BoT-SORT and
    OccluBoost on mmot-mini, held to the JAX values, with the corner rows and
    the replay's tracks held against the CPU's (a worker's)."""
    dets = mmot_obb_dets(MMOT_ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        for tracker, want in OBB_EVAL.items():
            out = Path(tmp) / tracker
            t0 = time.perf_counter()
            res = drive(f"run_eval_obb {tracker}", lambda: boxmot_tpu_torch.run_eval_obb(
                MMOT_ROOT, tracker, device="cuda", output_dir=out), RATIOS[tracker][1])
            seconds = time.perf_counter() - t0
            got = {k: float(res["combined"][k]) for k in ("HOTA", "MOTA", "IDF1")}
            print(f"eval_obb {tracker} mmot-mini on cuda: {got} in {seconds:.3f} s (JAX {want})")
            for k, v in want.items():
                if not abs(got[k] - v) <= ATOL:
                    raise AssertionError(f"OBB {tracker} {k} = {got[k]} misses the JAX value {v}")
            (cpu, cpu_tracks), waited = _cpu_result(cpu_jobs, ("obb", tracker, None))
            if waited > 0.05:
                print(f"waited {waited:.1f} s for the cpu rows of OBB {tracker}")
            gpu = _mot_rows(out)
            for seq, g in gpu.items():
                c = cpu[seq]
                keys = [0, 1, 10, 11]  # frame, id, conf, cls
                corner = float(np.abs(g[:, 2:10] - c[:, 2:10]).max(initial=0.0)) \
                    if g.shape == c.shape else np.inf
                if not (g.shape == c.shape and np.array_equal(g[:, keys], c[:, keys])
                        and corner <= OBB_BOX_TOL):
                    raise AssertionError(f"OBB {tracker} {seq}: corner rows differ cuda vs cpu")
                print(f"OBB {tracker} {seq} corner rows cuda vs cpu: {len(g)} rows, frame/id/"
                      f"conf/cls equal, max corner diff {corner:.3g} px")
            # det_ind is not in the corner rows: hold the replay's tracks
            cfg = build_replay_config(tracker, is_obb=True)  # BoT-SORT: with_reid, zero embeddings
            seqs = [{"dets": d} for d in dets.values()]
            for (go, gm), (co, cm) in zip(replay_sequences_outputs(cfg, seqs, device="cuda"),
                                          cpu_tracks):
                box = float(np.abs(go[gm][:, :5] - co[cm][:, :5]).max(initial=0.0))
                if not (np.array_equal(gm, cm) and np.array_equal(go[gm][:, 5:], co[cm][:, 5:])
                        and box <= OBB_BOX_TOL):
                    raise AssertionError(f"OBB {tracker}: tracks differ between cuda and cpu")
            print(f"OBB {tracker} replay tracks cuda vs cpu: masks, ids, conf, cls, det_ind "
                  f"equal; max xywha diff {box:.3g}")


def _live_frames(n_frames):
    """The first n_frames of LIVE_SEQ's public det.txt as (Ni, 6) arrays, and
    a blank image of the sequence's size."""
    rows = np.loadtxt(LIVE_SEQ / "det" / "det.txt", delimiter=",", ndmin=2)
    frames = []
    for f in range(1, n_frames + 1):
        sel = rows[rows[:, 0] == f]
        frames.append(np.stack([sel[:, 2], sel[:, 3], sel[:, 2] + sel[:, 4], sel[:, 3] + sel[:, 5],
                                sel[:, 6], np.zeros(len(sel))], axis=1).astype(np.float32))
    info = configparser.ConfigParser()
    info.read(LIVE_SEQ / "seqinfo.ini")
    img = np.zeros((info.getint("Sequence", "imHeight"), info.getint("Sequence", "imWidth"), 3),
                   np.uint8)
    return frames, img


def run_live(tracker):
    """Phase 6a: live update on cuda against the same tracker on the cpu."""
    frames, img = _live_frames(50)
    trackers = {d: boxmot_tpu_torch.create_tracker(tracker, device=d) for d in ("cuda", "cpu")}
    n_rows, worst, update_ms = 0, 0.0, []
    for f, dets in enumerate(frames, start=1):
        t0 = time.perf_counter()
        g = np.asarray(trackers["cuda"].update(dets, img))
        update_ms.append((time.perf_counter() - t0) * 1e3)
        c = np.asarray(trackers["cpu"].update(dets, img))
        if g.shape != c.shape or not np.array_equal(g[:, 4:], c[:, 4:]):
            raise AssertionError(f"live frame {f}: ids/conf/cls/det_ind differ between cuda and cpu")
        if len(g):
            worst = max(worst, float(np.abs(g[:, :4] - c[:, :4]).max()))
        if not worst <= 1e-3:
            raise AssertionError(f"live frame {f}: boxes differ by {worst} px")
        if not np.isfinite(g).all():
            raise AssertionError(f"live frame {f}: non-finite output")
        n_rows += len(g)
    if n_rows == 0:
        raise AssertionError("live API: no track was emitted in 50 frames")
    print(f"live {tracker}, 50 frames of {LIVE_SEQ.name}: {n_rows} rows equal to cpu "
          f"(ids, det_ind, cls, conf exact; max box diff {worst:.3g} px); cuda update "
          f"median {statistics.median(update_ms[1:]):.3f} ms/frame (host clock, frames 2-50)")


def run_live_obb(tracker):
    """Phase 6b: live update of (N, 7) mmot-mini frames, cuda against cpu."""
    n_rows, worst = 0, 0.0
    for seq, frames in mmot_obb_dets(MMOT_ROOT).items():
        trackers = {d: boxmot_tpu_torch.create_tracker(tracker, device=d) for d in ("cuda", "cpu")}
        for f, dets in enumerate(frames, start=1):
            g = np.asarray(trackers["cuda"].update(dets))
            c = np.asarray(trackers["cpu"].update(dets))
            if g.shape != c.shape or g.shape[1] != 9 or not np.array_equal(g[:, 5:], c[:, 5:]):
                raise AssertionError(f"live OBB {tracker} {seq} frame {f}: tracks differ")
            if len(g):
                worst = max(worst, float(np.abs(g[:, :5] - c[:, :5]).max()))
            if not (worst <= OBB_BOX_TOL and np.isfinite(g).all()):
                raise AssertionError(f"live OBB {tracker} {seq} frame {f}: boxes differ by {worst}")
            n_rows += len(g)
    if n_rows == 0:
        raise AssertionError(f"live OBB {tracker}: no track was emitted")
    print(f"live OBB {tracker}, mmot-mini: {n_rows} rows of 9 equal to cpu (ids, det_ind, "
          f"cls, conf exact; max xywha diff {worst:.3g})")


def run_live_cmc(tracker, n_frames, with_embs=False, conf_rtol=0.0, **kw):
    """Phase 6d: the live tracker with CMC on seeded textured 1920 x 1080
    frames of a camera panning by known sub-pixel steps (``shifted_frames``),
    MOT17-04's detections moved with the camera, cuda against cpu: ids, cls
    and det_ind exact, conf within ``conf_rtol`` (exact by default; BoostTrack
    and OccluBoost boost it from IoUs of the warped state, so ECC's warps
    move it by ulps), boxes bit-equal where nothing summed in another order
    enters them (SOF's warps come from the host; ECC's reductions and an
    embedding product sum in another order on the card), else within 1e-2
    px.  Prints the warps the cuda tracker's CMC recovered beside the known
    steps."""
    frames, _ = _live_frames(n_frames)
    imgs, steps = shifted_frames(n_frames)
    pan = np.cumsum(steps, axis=0).astype(np.float32)
    rng = np.random.default_rng(4)
    base = rng.normal(size=(64, FEAT_DIM))
    trackers = {d: boxmot_tpu_torch.create_tracker(tracker, device=d, **kw) for d in ("cuda", "cpu")}
    cmc = trackers["cuda"].cmc
    recovered, apply = [], cmc.apply
    cmc.apply = lambda img, dets: recovered.append(apply(img, dets)) or recovered[-1]
    exact = type(cmc).__name__ != "ECC" and not with_embs
    n_rows, worst, conf_err = 0, 0.0, 0.0
    for f, (dets, img) in enumerate(zip(frames, imgs), start=1):
        dets = dets.copy()
        dets[:, [0, 2]] += pan[f - 1, 0]
        dets[:, [1, 3]] += pan[f - 1, 1]
        embs = None
        if with_embs:
            embs = (base[:len(dets)] + rng.normal(0, 0.3 / math.sqrt(FEAT_DIM), (len(dets), FEAT_DIM)))
            embs = embs.astype(np.float32)
        g = np.asarray(trackers["cuda"].update(dets, img, embs))
        c = np.asarray(trackers["cpu"].update(dets, img, embs))
        if g.shape != c.shape or not np.array_equal(g[:, [4, 6, 7]], c[:, [4, 6, 7]]):
            raise AssertionError(f"live {tracker} with CMC, frame {f}: tracks differ cuda vs cpu "
                                 f"(rows {len(g)} vs {len(c)})")
        if len(g):
            worst = max(worst, float(np.abs(g[:, :4] - c[:, :4]).max()))
            conf_err = max(conf_err, float((np.abs(g[:, 5] - c[:, 5]) / c[:, 5]).max()))
        if not conf_err <= conf_rtol:
            raise AssertionError(f"live {tracker} with CMC, frame {f}: conf differs by {conf_err} "
                                 f"(relative) cuda vs cpu")
        if not (np.isfinite(g).all() and (worst == 0.0 if exact else worst <= 1e-2)):
            raise AssertionError(f"live {tracker} with CMC, frame {f}: boxes differ by {worst} px")
        n_rows += len(g)
    cmc.apply = apply
    got = np.stack([torch.as_tensor(w).cpu().numpy()[:, 2] for w in recovered])
    err = np.abs(got[1:] - steps[1:]).max()
    print(f"live {tracker} with {type(cmc).__name__} CMC{' and embeddings' if with_embs else ''}, "
          f"{n_frames} panning 1080p frames: {n_rows} rows equal to cpu (ids, det_ind, cls "
          f"exact; max conf diff {conf_err:.3g} relative, box diff {worst:.3g} px); recovered "
          f"translation vs known step, px: " +
          ", ".join(f"({a[0]:.3f}, {a[1]:.3f}) vs ({b[0]:.3f}, {b[1]:.3f})"
                    for a, b in zip(got[1:4], steps[1:4])) + f"; max error {err:.3g} px")
    if n_rows == 0:
        raise AssertionError(f"live {tracker} with CMC: no track was emitted")
    if type(cmc).__name__ == "ECC" and not err <= 0.1:
        raise AssertionError(f"ECC on the card missed the known steps by {err} px")


def run_live_crowded():
    """Phase 6c: frames of 300 detections (the 512 bucket), cuda against cpu."""
    frames = synthetic_frames(3, 300, seed=9)
    trackers = {d: boxmot_tpu_torch.create_tracker("bytetrack", device=d) for d in ("cuda", "cpu")}
    for f, dets in enumerate(frames):
        dets = dets.copy()
        dets[:, 4] = np.linspace(0.3, 0.99, len(dets), dtype=np.float32)
        g = np.asarray(trackers["cuda"].update(dets))
        c = np.asarray(trackers["cpu"].update(dets))
        if g.shape != c.shape or not np.array_equal(g[:, 4:], c[:, 4:]):
            raise AssertionError(f"300 detections, frame {f}: tracks differ between cuda and cpu")
    print(f"live 300 detections, 3 frames: {len(g)} rows in the last frame, equal to cpu, "
          f"largest det_ind {int(g[:, 7].max())}")


def _bench(label, cfg, frames_fn, det_cols, card, launches=6, miss=None, n_frames=N_FRAMES):
    """frames/s of batch_replay at the bench shape (``n_frames`` frames a
    sequence); a distinct seeded input per launch, the first launch a
    warm-up.  With ``miss`` (a float) the inputs are ``appearance_batch``'s
    (embeddings and warps made on the card, that share of detections missed)
    and ``frames_fn`` is unused.  Returns the last launch's input (batch,
    embs, warps)."""
    batches = []
    for v in range(launches):
        if miss is not None:
            batches.append(appearance_batch(N_SEQS, n_frames, N_DETS, v * N_SEQS, miss, "cuda"))
            continue
        packed = [pack_frames(frames_fn(n_frames, N_DETS, seed=v * N_SEQS + s), D=D_BENCH,
                              F=n_frames, det_cols=det_cols)[0] for s in range(N_SEQS)]
        batches.append((torch.from_numpy(np.stack(packed)).cuda(), None, None))
    ms, capped, replayed = [], 0, []
    for i, (b, embs, warps) in enumerate(batches):
        states = init_states(cfg, N_SEQS, "cuda")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        states, outs, masks = batch_replay(cfg, states, b, None, embs, warps)
        end.record()
        end.synchronize()
        if not torch.isfinite(outs[masks]).all():
            raise AssertionError(f"{label} bench replay: non-finite output")
        capped += int(states.lap_capped.sum())
        if hasattr(states, "oru_replayed"):  # summed on the device, read once after the replay
            replayed.append(int(states.oru_replayed.sum()))
        if i:
            ms.append(start.elapsed_time(end))
    fps = N_SEQS * n_frames / (statistics.median(ms) / 1e3)
    line = {"metric": f"{label}_replay_fps_{N_DETS}dets", "value": fps, "unit": "frames/s",
            "shape": [N_SEQS, n_frames, N_DETS, D_BENCH, CAPACITY], "launch_ms": ms,
            "lap_capped": capped, "card": card}
    if replayed:
        line["oru_slots_replayed"] = replayed
    print(json.dumps(line))
    if capped:
        raise AssertionError(f"{label} bench: {capped} auction(s) stopped at the iteration cap")
    return batches[-1]


def profile_step(label, cfg, card, inputs):
    """Kernels, device busy ms and host ms per step of ``cfg`` at the bench
    shape: 16 steady steps (frames 64-79) under torch.profiler, host ms from
    the same 16 steps again without it (host clock, ending in a
    synchronize); the idle share is 1 - busy / host ms.  ``inputs`` is
    (batch, embs, warps) as ``_bench`` returns it; each kernel's device ms a
    step: K1, K2, K4 and the embedding product (cuBLAS gemm kernels)."""
    batch, embs, warps = inputs
    head = (None, None) if embs is None else (embs[:, :64], warps[:, :64])
    tail = (None, None) if embs is None else (embs[:, 64:80], warps[:, 64:80])
    states, _, _ = batch_replay(cfg, init_states(cfg, N_SEQS, "cuda"), batch[:, :64], None, *head)
    prof = measure.profile_steps(lambda: batch_replay(cfg, states, batch[:, 64:80], None, *tail),
                                 16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch_replay(cfg, states, batch[:, 64:80], None, *tail)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 16
    by_kernel = {k: sum(ms for name, (_, ms) in prof["by_kernel"].items() if pick(name.lower()))
                 for k, pick in (("K1", lambda n: "iou_cost_kernel" in n),
                                 ("K2", lambda n: "auction_kernel" in n),
                                 ("K4", lambda n: "oru_kernel" in n),
                                 ("bmm", lambda n: "gemm" in n))}
    families = {}  # kernel name without namespace and template arguments -> (launches, ms)
    for name, (n, ms) in prof["by_kernel"].items():
        family = name.split("<")[0].split("::")[-1].split("(")[0].strip()
        launches, total = families.get(family, (0.0, 0.0))
        families[family] = (launches + n, total + ms)
    top = sorted(families.items(), key=lambda kv: -kv[1][1])[:8]
    line = {"metric": f"{label}_step_profile", "kernels_per_step": prof["kernels_per_step"],
            "busy_ms_per_step": prof["busy_ms_per_step"], "host_ms_per_step": host_ms,
            "idle_share": 1.0 - prof["busy_ms_per_step"] / host_ms, "traces": prof["traces"],
            "device_ms_per_step": by_kernel,
            "top_kernel_families_launches_ms_per_step": dict(top), "card": card}
    print(json.dumps(line))


def time_ecc(card):
    """Phase 7e: ECC's ``apply`` on the card at 1080p, scale 0.15 (the
    trackers' default): host ms a frame (the upload of the frame included,
    ending in a synchronize), and the kernels one apply launches and their
    device ms (torch.profiler)."""
    imgs, steps = shifted_frames(8)
    ecc = create_cmc("ecc", device="cuda")
    ecc.apply(imgs[0])
    ms = []
    for img in imgs[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warp = ecc.apply(img)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    prof = measure.profile_steps(lambda: ecc.apply(imgs[1]), 1)
    line = {"metric": "ecc_apply_1080p", "host_ms_per_frame": statistics.median(ms),
            "host_ms": ms, "kernels_per_apply": prof["kernels_per_step"],
            "busy_ms_per_apply": prof["busy_ms_per_step"], "traces": prof["traces"],
            "last_warp_translation": warp[:, 2].tolist(), "known_step": steps[-1].tolist(),
            "card": card}
    print(json.dumps(line))


# the depth of the bench lines of earlier slices (frames a sequence), cut from
# N_FRAMES to make room for StrongSORT's and HybridSORT's within the run's time
EARLIER_FRAMES = 128


def run_throughput(card, lap):
    """Phase 7: the AABB and OBB ByteTrack bench lines, the OC-SORT AABB
    line with MISS of the detections missed and its step profile, the
    BoT-SORT AABB line (embeddings and warps) and its step profile, the
    DeepOCSORT AABB line (MISS missed, embeddings and warps) with the slots
    K4 replayed and its step profile, the BoostTrack AABB line (the YAML
    tier, embeddings and warps) and the OccluBoost AABB line
    (``OccluBoostConfig()``, as bench.py runs it, with 512-d embeddings and
    warps) with their step profiles, all at EARLIER_FRAMES frames a
    sequence; ECC's cost a frame; then the StrongSORT and HybridSORT AABB
    lines at N_FRAMES (their YAML tiers, 512-d embeddings and warps,
    HybridSORT with MISS missed so that K4 replays) with their step
    profiles."""
    n = EARLIER_FRAMES
    drive("bench bytetrack AABB", lambda: _bench(
        "bytetrack", ByteTrackConfig(capacity=CAPACITY), synthetic_frames, 6, card, launches=2,
        n_frames=n), RATIOS["bytetrack"][0], sync_free=False)
    drive("bench bytetrack OBB", lambda: _bench(
        "bytetrack_obb", ByteTrackConfig(capacity=CAPACITY, is_obb=True),
        lambda n, d, seed: synthetic_obb_frames(n, d, seed=seed, miss=0.0), 7, card, launches=2,
        n_frames=n), RATIOS["bytetrack"][1], sync_free=False)
    inputs = drive("bench ocsort AABB", lambda: _bench(
        "ocsort", OcSortConfig(capacity=CAPACITY), synthetic_frames_missed, 6, card, launches=2,
        n_frames=n), RATIOS["ocsort"][0], sync_free=False)
    profile_step("ocsort", OcSortConfig(capacity=CAPACITY), card, inputs)
    lap("phase 7a (ByteTrack and OC-SORT lines)")
    cfg = build_replay_config("botsort", capacity=CAPACITY)
    inputs = drive("bench botsort AABB", lambda: _bench(
        "botsort", cfg, None, 6, card, launches=2, miss=0.0, n_frames=n), RATIOS["botsort"][0],
        sync_free=False)
    profile_step("botsort", cfg, card, inputs)
    del inputs
    lap("phase 7b (botsort line)")
    cfg = build_replay_config("deepocsort", capacity=CAPACITY)
    inputs = drive("bench deepocsort AABB", lambda: _bench(
        "deepocsort", cfg, None, 6, card, launches=2, miss=MISS, n_frames=n),
        RATIOS["deepocsort"][0], sync_free=False)
    profile_step("deepocsort", cfg, card, inputs)
    del inputs
    lap("phase 7b (deepocsort line)")
    for label, cfg in (("boosttrack", build_replay_config("boosttrack", capacity=CAPACITY)),
                       ("occluboost", OccluBoostConfig(capacity=CAPACITY))):
        inputs = drive(f"bench {label} AABB", lambda: _bench(
            label, cfg, None, 6, card, launches=2, miss=0.0, n_frames=n), boost_ratio(cfg),
            sync_free=False)
        profile_step(label, cfg, card, inputs)
        del inputs
        lap(f"phase 7b ({label} line)")
    time_ecc(card)
    lap("phase 7b (ECC)")
    for label, miss in (("strongsort", 0.0), ("hybridsort", MISS)):
        cfg = build_replay_config(label, capacity=CAPACITY)
        ratio = RATIOS["strongsort"][0] if label == "strongsort" else hybrid_ratio(cfg)
        inputs = drive(f"bench {label} AABB", lambda: _bench(
            label, cfg, None, 6, card, launches=2, miss=miss), ratio, sync_free=False)
        profile_step(label, cfg, card, inputs)
        del inputs
        lap(f"phase 7c ({label} line)")


def build_kernels():
    """Phase 2: one nvcc per source, all started together."""
    names = [src for _, src, _ in KERNELS.values()]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(build.build, names)))
    for name, path in paths.items():
        seconds, log = build.BUILD_LOG.get(name, (0.0, "(prebuilt)\n"))
        print(f"built {path.name} in {seconds:.1f} s\n{log.strip()}")
    print(f"kernels built in {time.perf_counter() - t0:.1f} s (wall, in parallel)")


def run_phases(lap, smi, cpu_jobs, cache_root):
    """Phases 3-7; returns phase 3's timing entries and K4's XYSCR rows."""
    rng = np.random.default_rng(0)
    step_calls = bench_step_calls()
    checks = {"fused_iou_cost": check_k1(rng, step_calls),
              "masked_assignment": check_k2(rng, step_calls),
              "rotated_iou": check_k3(rng, step_calls)}
    checks["oru_replay"], xyscr_rows = check_k4(rng, step_calls)
    del step_calls
    check_kalman_obb(rng)
    lap("phase 3 (kernels against their twins)")

    check_sync_mode_is_live()
    run_aabb_evals(cpu_jobs)
    lap("phase 4a (pinned evals)")
    run_appearance_eval("botsort", cache_root, cpu_jobs)
    run_occluboost_gta_eval(cache_root, cpu_jobs)
    lap("phase 4b-c (cache-fed evals)")
    for tracker in APPEARANCE_EVALS:
        run_appearance_eval(tracker, cache_root, cpu_jobs)
    lap("phase 4d (StrongSORT and HybridSORT cache-fed evals)")
    run_obb_evals(cpu_jobs)
    lap("phase 5 (OBB evals)")
    for tracker in ("bytetrack", "ocsort", "sam2mot"):
        drive(f"live {tracker} AABB", lambda: run_live(tracker), RATIOS[tracker][0],
              sync_free=False)
    for tracker in ("bytetrack", "sfsort", "ocsort", "botsort", "occluboost"):
        drive(f"live {tracker} OBB", lambda: run_live_obb(tracker), LIVE_OBB_RATIOS[tracker],
              sync_free=False)
    drive("live botsort ECC", lambda: run_live_cmc("botsort", 10, cmc_method="ecc"),
          RATIOS["botsort"][0], sync_free=False)
    drive("live botsort zoo defaults (SOF)", lambda: run_live_cmc("botsort", 4),
          RATIOS["botsort"][0], sync_free=False)
    drive("live deepocsort ECC + embeddings", lambda: run_live_cmc("deepocsort", 10, True),
          RATIOS["deepocsort"][0], sync_free=False)
    for tracker in ("boosttrack", "occluboost"):
        drive(f"live {tracker} ECC", lambda: run_live_cmc(tracker, 6, cmc_method="ecc",
                                                          conf_rtol=1e-5),
              RATIOS[tracker][0], sync_free=False)
    # the live YAML tiers: StrongSORT always, HybridSORT with ReID on
    for tracker, ratio in (("strongsort", RATIOS["strongsort"][0]),
                           ("hybridsort", hybrid_ratio(build_replay_config("hybridsort")))):
        drive(f"live {tracker} ECC + embeddings", lambda: run_live_cmc(tracker, 8, True), ratio,
              sync_free=False)
    drive("live bytetrack 300 detections", run_live_crowded, RATIOS["bytetrack"][0],
          sync_free=False)
    lap("phase 6 (live)")
    run_throughput(smi, lap)
    return checks, xyscr_rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    def lap(label):
        print(f"{label} done at {time.perf_counter() - t_start:.1f} s")

    # the CPU references of phases 4-5, in worker processes that run beside
    # phases 2-5 (spawned, so that no worker inherits the card's context);
    # the pool is shut down on the way out, failure or not
    import multiprocessing

    with contextlib.ExitStack() as stack:
        cache_root = reid_caches(Path(stack.enter_context(tempfile.TemporaryDirectory())) / "cache")
        pool = concurrent.futures.ProcessPoolExecutor(
            CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"))
        stack.callback(pool.shutdown, wait=True, cancel_futures=True)
        cpu_jobs = start_cpu_references(pool, cache_root)
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {kind}")
        print(f"nvidia-smi: {smi}")
        build_kernels()
        checks, xyscr_rows = run_phases(lap, smi, cpu_jobs, cache_root)

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"nvidia-smi: {smi}")
    for name, c in checks.items():
        print(f"wrapper ms {name}: {c['wrapper_ms']:.5f} (CUDA events around one call of the "
              f"wrapper, host work included)")
    print(json.dumps({"k4_xyscr": [
        {"set": label, "ms": r[0], "wrapper_ms": r[1], "plain_ms": r[2], "bound_ms": r[3],
         "bound_by": r[4]} for label, r in xyscr_rows]}))
    # library_ms: no single PyTorch call computes any of the four functions
    kernels = [
        {"name": name, "route": "cuda", "source": f"boxmot_tpu_torch/csrc/{src}.cu",
         "replaces": replaces, "launches": LAUNCHES[name],
         **{k: checks[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None}
        for name, (_, src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
