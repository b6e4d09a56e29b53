#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (boxmot_tpu_torch) once on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device report: torch's card name and nvidia-smi's name and power limit;
     the CPU references of phases 4-5 start in worker processes (spawned)
     that run beside phases 2-5;
  2. build the six hand-written kernels from csrc/, one nvcc each, in
     parallel; write phase 8's seeded yolox_x checkpoint (batch norms
     calibrated on the card on two MOT17-04 letterboxes) and start its CPU
     raw head in a worker;
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
     recorded StrongSORT step (pass 1's costs mostly at the clamp), and K2
     on costs holding NaN, +inf and -inf;
     the launch floor, an empty kernel's device time through K1's ctypes
     path on one block and on K1's grids, on a line of its own;
     then each kernel timed on the inputs of one recorded bench step: its
     device time per launch (torch.profiler), its wrapper's time (CUDA
     events around one call), its twin's, and its bound counted from the
     work those inputs need (K4's XYSCR instance too, on its all-rejoin set
     and the HybridSORT step); the OBB Kalman bank's bits on the card
     against the CPU; K5 (the ReID crops) bit-equal to its twin on a seeded
     textured 1080p frame, 64 and 256 boxes, axis-aligned and rotated (past
     every edge, sub-pixel, unit padding boxes, angles of +-pi/2 and +-pi),
     fp32 and bf16, and on its edge sets (7 x 5 and 384 x 128 outputs,
     one-pixel boxes at the frame's corners on an unaligned frame view, an
     unaligned output), with its device time a call beside its bound
     (bytes), the wrapper's and the twin's times, F.grid_sample's (the
     library call) and once the TPU design's two dense einsums; K6 (greedy
     NMS) bit-equal to its twin on its edge sets (no positive score; fewer,
     exactly and more survivors than max_out; tied scores; duplicate boxes;
     IoUs exactly at the threshold; zero-area boxes; NaN coordinates; NaN
     and +-inf scores; N = 1 and N = 1061; batched_class_nms's class offset;
     23,625 near-identical boxes; equal scores across tiers and chunks at
     max_out 256 and 64; fewer survivors than max_out past the first tier;
     +inf, subnormal, -0.0 and FLT_MIN scores; max_out above N; N = 0), on
     23,625 random clustered boxes at max_out 256 and 64 and on one yolox_x
     frame's decoded outputs at 256 and 64, each set with its work (the
     sorted definition's IoUs counted from the twin's result, ``k6_work``)
     and wrapper time, the last four and the cluster and cross-tier sets
     also with device time a call, twin time and bound (bytes; no library
     call: torchvision is absent), and one call's trace lists only ``nms_*``
     kernels;
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
     sam2mot), 20 of them with NaN detections (ByteTrack, OC-SORT:
     ``run_live_nan``), the mmot-mini frames as (N, 7) detections (ByteTrack, SFSORT,
     OC-SORT, BoT-SORT, OccluBoost), frames of 300 detections, and seeded
     textured 1920 x 1080 frames of a camera panning by known sub-pixel
     steps with MOT17-04's detections moved along: BoT-SORT with ECC on the
     card, BoT-SORT from the zoo defaults (SOF, on the host), DeepOCSORT,
     StrongSORT and HybridSORT with ECC and embeddings, BoostTrack and
     OccluBoost with ECC; each against the same tracker on the CPU, with the
     warps ECC recovered beside the known steps; then BoT-SORT and
     DeepOCSORT computing their embeddings with their ReID
     (``reid_weights``: a torchreid-format osnet_x0_25 checkpoint written
     from seeded weights) on 50 textured 1080p frames with MOT17-04's
     detections, against the CPU: rows equal, features within 1e-4, and
     BoT-SORT's smallest margin of an appearance distance to its threshold;
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
     profiles; and the ReID lines: ``get_features`` of osnet_x1_0 and
     osnet_x0_25, 32 / 64 / 256 crops of 256 x 128 from a 1080p frame, fp32
     and bf16 (ms a call, crops/s, a 16-call profile with K5's and the
     convolutions' shares), the card's features against the CPU's;
  8. the detector and the fused live step at full width: seeded yolox_x at
     (800, 1440) (``run_detector_phase``): its raw head on the card (fp32,
     TF32 off) against the CPU's; the staged ``Detector`` and
     ``DetectorReIDPipeline`` (osnet_x0_25, no frame skipped) over the 12
     MOT17-mini frames, with K6's kept indices held to the twin's on each
     frame's decoded outputs; ``FusedLiveTracker`` with ByteTrack and with
     OccluBoost + osnet_x0_25 over the same frames, each frame under
     set_sync_debug_mode("error"), its detections equal to the staged
     detector's and its rows to the same tracker on the CPU fed the card's
     detections and crops; the bf16 tier; and the timing lines on 50 seeded
     textured 1080p frames (detector ms a frame in fp32 and bf16, fused ms a
     frame, kernels, busy ms, idle share and K6's share from a 16-frame
     profile);
  9. cache generation, the yololite predictor and the ReID backbones beyond
     OSNet: (a) (in phase 3, ``check_k6_lite``) K6 at the yololite shape
     (256 anchors, max_out 64, the class offset 512) bit-equal to its twin,
     class-aware, with every score below conf, agnostic and with a
     ``classes`` filter, timed beside its bound; each yololite task (detect, segment, OBB, pose) through ``predict`` on
     the 12 MOT17-mini frames and a seeded textured 1080p frame, K6's kept
     indices equal to the twin's on the card's own decoded outputs, the kept
     anchors equal to the CPU's and their heads within ``LITE_TOL`` (boxes
     1e-3 px, scores 1e-5, masks and keypoints 1e-4, at the net's 256 x 256
     input), a line a task (ms a 1080p frame, a 16-call profile) and one
     call's trace listing an ``nms_*`` kernel; (b) ``run_generate`` on
     MOT17-mini with yololite-seg, the seeded osnet_x0_25 and ECC (seconds a
     sequence by stage, frames/s), its caches against the same run on the
     CPU (a worker's; ``_check_gen_caches``), the embeddings-only re-run over
     its det caches, with frame_group 4 and with batch_size (a warning)
     within 1e-5 of its embeddings, a trace of ``_fill_embeddings`` listing a
     ``crops_*`` kernel, and ``run_eval`` over its caches on the card and
     the CPU (sam2mot from the mask cache, BoT-SORT with embeddings and
     warps: metrics equal, MOT rows bit-equal); (c) ``get_features`` of
     resnet50, resnet101, mobilenetv2 x1.0 and x1.4, lmbn_n, lmbn_ain_n,
     mlfn, cspreid_n and hacnn (160 x 64) on 64 boxes of a seeded 1080p
     frame, card against CPU (1e-4) and bf16 against fp32 (cosine >= 0.99),
     with a line each (ms a call, crops/s, kernels a call, K5's share);
 10. the transformer backbones and ReID training: (a) each of the 17
     transformer names (vit_nano, vit_nano_ain, vit_nano_ain_os, vit_tiny,
     vit_tiny_parts, vit_tiny_parts3, the ten CSL-TinyViT names, clip)
     through ``ReID`` on 8 crops of 256 x 128, card against CPU (1e-4, TF32
     off) and bf16 against fp32 (cosine >= 0.99); (b) a line for
     vit_nano_ain_os, vit_tiny_parts3, csl_tinyvit_7m, csl_tinyvit_23m_lmbn
     and clip at 64 crops (``reid_line``) with the matrix products' and the
     plain attention's shares of busy time, and
     ``F.scaled_dot_product_attention``'s time on the same inputs (measured,
     not used); (c) ``ReIDTrainer`` for osnet_x0_25 and vit_nano on a seeded
     Market-1501-layout dataset (``reid_dataset``: 32 identities x 8
     JPEGs, 16 test identities), P x K = 16 x 4, 256 x 128, 20 steps,
     with cuDNN's deterministic algorithms, against the same run on the CPU
     (a worker's; first loss 1e-4 relative, every loss finite, the 20-step
     drift printed: osnet_x0_25's float32 trajectory is chaotic), 5 steps
     from the CPU's state at steps 0, 5, 10 and 15 (losses within 5 %, the
     first 1e-4; the state after one step, parameters, batch statistics,
     Adam's moments and EMA, the card's and the CPU's, against the same
     step in float64: the card's error within ``STEP_RATIO`` x the CPU's),
     ``evaluate()`` on the card against the CPU (mAP 1e-3), 10 steps +
     checkpoint + resume against 20 straight (1e-5), and a line (ms a step,
     steps/s, kernels, busy, idle); (d) a seeded
     full-size CLIP ViT-B/16 checkpoint through ``convert_clip``: the facade
     from the file, card against CPU, and ``learn_identity_prompts`` with
     the converted text tower, 3 steps, card against CPU; (e) live BoT-SORT
     with ``reid_weights="vit_nano"`` on 20 textured frames of MOT17-04's
     detections, rows equal to the CPU's;
 11. the front door (``run_front_door_phase``), the CLI driven in-process
     through ``cli.main([...], standalone_mode=False)``: (a) ``eval`` of
     ByteTrack on MOT17-mini gives the pins; (b) ``tune-kf`` writes the CPU
     worker's JSON, and ``eval --kf-noise <it> --postprocessing gsi`` (GSI
     where sklearn is installed) and ``eval --tracker occluboost --tuned
     occluboost_mot17_ablation`` give the metrics of the same commands on
     the CPU (a worker's, 1e-4); (c) ``eval
     --benchmark mmot-mini`` runs on K3 and gives the CPU's class-averaged
     metrics; (d) ``Boxmot(tracker="bytetrack", device="cuda").track`` over
     MOT17-04 gives the CPU's rows (ids and det_ind exact, boxes 1e-4 px);
     (e) ``track --detector <phase 2's yolox_x> --reid-weights osnet_x0_25
     --tracker botsort --save-video`` over MOT17-04's 8 frames launches one
     K6 and one K5 a frame (besides the pipeline's warm-up call) and writes
     8 frames; (f) a line per step with its host wall time and the card.
     Sub-steps whose modules (click, yaml, sklearn: ``FRONT_DOOR_STEPS``) the
     machine lacks are named and not run;
 12. tuning, research and the native cores (``run_tuning_phase``), through the
     CLI in-process: (a) ``tune`` of ByteTrack on MOT17-mini, 8 random trials,
     with 1 and then 4 worker threads: the trials' params equal a CPU
     worker's ``tune --device cpu``, their metrics within 1e-4, the default
     trial gives the pins, the 4 workers' trials are bit-equal to the 1
     worker's, and a rerun in the same work dir runs no trial; (b) ``research``
     over parameters, 4 candidates: params equal the CPU worker's, metrics
     within 1e-4; (c) ``research --edit-source``, 1 candidate: every child
     (a process of its own, one after another) says in its JSON line that it
     ran on cuda and built no kernel (the workspace is seeded with the
     kernels built in phase 2), and the baseline gives the pins; (d) ``build``,
     then ``eval --tracker bytetrack:cpp --n-workers 4`` and ``eval --tracker
     occluboost:cpp`` give the ``:cpp`` pins (the native cores are host
     code; where cmake or a C++ compiler is missing these are named and not
     run); (e) ``Boxmot(tracker="bytetrack", device="cuda").tune`` with 4
     trials gives (a)'s first 4 trials; (f) a line per sub-step with its host
     wall time, seconds a trial, a candidate or a child, and the card;
 13. ReID export, its runtimes and the sequence-parallel replay
     (``run_export_phase``), at the JAX CLI's export defaults (osnet_x0_25,
     256 x 128): (a) ``export --include checkpoint,torch,onnx,saved_model,
     tflite --device cuda`` in-process, the ONNX and TFLite artifacts
     verified against the card's float32 forward (TF32 off) within 5e-3,
     with its seconds a target; (b) each artifact but the ONNX file reloaded
     through ``create_reid`` on the card, and the native ``manifest.txt``
     (``export_native_reid``) through it on the host, on 32 person-like
     boxes of a seeded textured 1080p frame: the ``.msgpack`` and ``.pt``
     ``ReID`` give the source model's features to the bit, the TFLite and
     SavedModel runtimes (their crops cut by K5 on the card) and ``CppReID``
     within 5e-3, each with its ms a call; (c) ``sharded_batch_replay`` of
     ByteTrack at the bench shape (8 sequences x 256 frames x 100
     detections) over ``sequence_mesh()`` (the one card: one
     ``batch_replay``), twice, its rows bit-equal to ``batch_replay``'s, with
     frames/s and its K1 and K2 launches; (d) ``sharded_reid_features`` of 64
     NHWC crops within 1e-5 of ``ReID._embed``; (e) ``Boxmot.export`` of the
     ONNX target.  Where tensorflow (the SavedModel and TFLite targets),
     click (the CLI) or cmake and a C++ compiler (the native runtime) are
     missing, those sub-steps are named and not run; the modules present
     (tensorflow, msgpack) are printed.
Every path of phases 4-13 runs with the launch counters set to 0 just before
it and read just after; each eval's frame loop runs under
torch.cuda.set_sync_debug_mode("error") (phase 12's threaded trials too: the
replay's one read-back lifts the mode for every thread at once), and where a
step's launches are
fixed (ByteTrack and BoT-SORT: 2 IoU launches (K1, or K3 in OBB mode) to 3
auctions; SFSORT: 1 rotated IoU to 2 auctions in OBB mode; the detector:
one K6 a frame, one K5 with ReID, and the fused step the tracker's own on
top; the yololite predictor: one K6 a frame; run_generate: one K6 and one
K5 a frame; a ReID call: one K5 (and a call of phase 13's reloaded TF
runtimes; its C++ runtime none); ReID training and prompt learning: none;
OC-SORT and
DeepOCSORT: 2 IoU launches to 2 auctions to 1 ORU; StrongSORT: 1 IoU launch
to 2 auctions; BoostTrack, OccluBoost and HybridSORT: as ``boost_ratio`` and
``hybrid_ratio`` count them from the config's options; sam2mot: none; the
live ReID paths add one K5 launch a frame) the
counts must keep that ratio, so no step fell back to a twin.  Phase laps
are printed.  The line before the last is {"kernels": [...]}, K1-K6, with
each kernel's launches summed over those paths (K4's over its three
layouts);
the last line is {"ok": true, "device": {...}}.  Without a CUDA card it
exits non-zero before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import configparser
import contextlib
import faulthandler
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import boxmot_tpu_torch
from boxmot_tpu_torch.csrc import build
from boxmot_tpu_torch.data.cache import det_cache_path, load_cached_dets_per_frame
from boxmot_tpu_torch.data.loaders import iter_source
from boxmot_tpu_torch.detectors import create_detector
from boxmot_tpu_torch.detectors.detector import Detector
from boxmot_tpu_torch.detectors import registry as registry_mod
from boxmot_tpu_torch.detectors.registry import YoloXDetector, letterbox_u8, standardize_host
from boxmot_tpu_torch.detectors.yolo_lite import MAX_OUT, LiteYOLO
from boxmot_tpu_torch.engine import generate as generate_mod
from boxmot_tpu_torch.engine.generate import load_frame, run_generate
from boxmot_tpu_torch.engine import fused as fused_mod
from boxmot_tpu_torch.engine.fused import FusedLiveTracker
from boxmot_tpu_torch.engine.inference import DetectorReIDPipeline
from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.eval_obb import mmot_obb_dets
from boxmot_tpu_torch.engine.replay import (
    batch_replay,
    init_states,
    pack_frames,
    replay_sequences_outputs,
    resolve_tracker,
    wants_embs,
)
from boxmot_tpu_torch.models.convert import convert_clip
from boxmot_tpu_torch.models.osnet import build_osnet
from boxmot_tpu_torch.motion import kalman
from boxmot_tpu_torch.motion.cmc import create_cmc
from boxmot_tpu_torch.ops.crops import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    as_frame,
    extract_crops,
    extract_crops_plain,
    launch_crops,
)
from boxmot_tpu_torch.ops.fused_iou_cost import (
    IOU_BATCH_EPS,
    empty_launch,
    fused_iou_cost,
    fused_iou_cost_plain,
    launch_geometry,
)
from boxmot_tpu_torch.ops.geometry import exact, obb_corners, wrap_angle
from boxmot_tpu_torch.ops.iou import iou_batch
from boxmot_tpu_torch.ops.lap import masked_assignment, masked_assignment_plain, uses_shared_weights
from boxmot_tpu_torch.ops.nms import CLASS_OFFSET, batched_class_nms, nms, nms_plain
from boxmot_tpu_torch.ops.oru import MAX_ORU, oru_replay, oru_replay_plain
from boxmot_tpu_torch.ops.oru import launch_geometry as k4_geometry
from boxmot_tpu_torch.ops.rotated_iou import rotated_iou, rotated_iou_counted, rotated_iou_plain
from boxmot_tpu_torch.reid import ReID
from boxmot_tpu_torch.reid import core as reid_core
from boxmot_tpu_torch.reid.training.clip_prompt import PromptStageConfig, learn_identity_prompts
from boxmot_tpu_torch.reid.training.trainer import ReIDTrainer, TrainConfig
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
    "extract_crops": (extract_crops, "crops", "boxmot_tpu/ops/crops.py:71"),
    "nms": (nms, "nms", "boxmot_tpu/ops/nms.py:21"),
}
CROP_HW = (256, 128)  # the ReID facade's crops (the JAX ReID's default)
DET_IMGSZ = (800, 1440)  # YoloXDetector's default input (the yolox_x MOT17 model's)
FUSED_MAX_DETS = 64  # FusedLiveTracker's default detection capacity
TIMING_FRAMES, PROFILE_FRAMES = 50, 16  # phase 8's timing lines
CARD = "cuda"  # the device of phase 3's K6 sets and of phase 8
FRAME_HW = (1080, 1920)
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


def _nonfinite_boxes(rng, S, K, D):
    """Boxes with NaN and infinite coordinates: a NaN side, infinite corners,
    and an infinite side times a zero one (a NaN area beside a zero
    intersection)."""
    trk, det = _boxes(rng, S, K), _boxes(rng, S, D)
    trk[:, 3::9, 0] = np.nan
    trk[:, 5::9, 2] = np.inf
    trk[:, 6::9] = [0, 50, np.inf, 50]
    det[:, 1::7, 3] = np.nan
    det[:, 2::7, :2] = -np.inf
    det[:, 4::7] = [10, 0, 10, np.inf]
    return trk, det


def same_or_both_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal, NaN where the other is NaN (``torch.equal`` calls NaN unequal)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def check_k1(rng, step_calls):
    """K1 bit-equal to its twin in both modes (with conf: IoU and cost;
    without: the IoU alone) and with both union clamps (the TPU kernel's
    default, iou_batch's that the tracker steps pass) at the step's shapes,
    a live frame's 512 detections and two shapes that take the scalar path
    (D % 4 != 0), with confidences that are not 16-byte aligned, on boxes
    with NaN and infinite coordinates (NaN IoUs where the twin's are NaN),
    and on boxes whose unions lie below 1e-9; the launch floor (an empty kernel
    through the same ctypes path, on one block and on K1's grids); then
    each of the bench step's two launches timed in its own mode."""
    cases = []
    for S, K, D in K1_SHAPES:
        trk = _boxes(rng, S, K)
        det = _boxes(rng, S, D)
        det[:, : D // 2] = trk[:, :1] + rng.uniform(-30, 30, (S, D // 2, 4))
        cases.append(("", trk, det))
    cases.append((", NaN and infinite boxes", *_nonfinite_boxes(rng, 2, 64, 77)))
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
                same = [g is w or same_or_both_nan(g, w) for g, w in zip(got, want)]
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
    floors = {(b, t): measure.device_ms_per_call(lambda: empty_launch(card, b, t),
                                                 "empty_kernel")
              for b, t in dict.fromkeys(grids)}
    print("launch floor (an empty kernel through K1's ctypes path, device ms a launch): " +
          ", ".join(f"{b} x {t} threads {ms:.5f}" for (b, t), ms in floors.items()))
    rows = []
    for (trk, det, conf), kw in calls:
        args = [trk, det] if conf is None else [trk, det, conf]
        S, K, D = trk.shape[0], trk.shape[1], det.shape[1]
        row = (measure.device_ms_per_call(lambda: fused_iou_cost(*args, **kw), "iou_cost_"),
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
    # non-finite costs: NaN and +inf never match, -inf (an infinite weight)
    # runs the auction to its cap through NaN net values
    for label, specials in NONFINITE.items():
        cost, rm, cm = (torch.from_numpy(a).cuda() for a in nonfinite_costs(rng, specials))
        _k2_same(f"costs with {label}", cost, rm, cm, 0.8)
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
            row = (measure.device_ms_per_call(lambda: masked_assignment(*args, **kwargs),
                                              "auction_"),
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
        row = (measure.device_ms_per_call(lambda: rotated_iou(a, b, c1, c2), "rotated_iou_",
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
    row = (measure.device_ms_per_call(lambda: oru_replay(layout, *card, replayed), "oru_"),
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


def crop_frame(seed=0, size=FRAME_HW):
    """A seeded textured colour uint8 BGR frame: coarse colour noise,
    upsampled bilinearly, plus pixel noise (the card's machine has no image
    decoder, so no recorded frame)."""
    from scipy.ndimage import zoom

    rng = np.random.default_rng(seed)
    H, W = size
    coarse = rng.uniform(0, 255, (H // 24 + 2, W // 24 + 2, 3))
    smooth = zoom(coarse, (24, 24, 1), order=1)[:H, :W]
    return np.clip(smooth + rng.normal(0, 12, (H, W, 3)), 0, 255).astype(np.uint8)


def crop_boxes(rng, n, obb, size=FRAME_HW):
    """n person-like boxes of a frame of ``size`` as the ReID facade gets them
    ((n, 4) xyxy or (n, 5) xywha), the first of them boxes past every edge
    and past each corner, sub-pixel and zero-size boxes, the JAX facade's
    unit padding box and, rotated, angles of 0, +-pi/2 and +-pi."""
    H, W = size
    w, h = rng.uniform(20, 200, n), rng.uniform(40, 400, n)
    if obb:
        b = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n), w, h,
                      rng.uniform(-math.pi, math.pi, n)], 1)
        special = [[0, 0, 1, 1, 0], [W / 2, H / 2, 1.5 * W, 1.5 * H, 0.1],
                   [5, 5, 300, 200, math.pi / 2], [W - 5, H - 5, 300, 200, -math.pi / 2],
                   [W / 2, 10, 100, 200, math.pi], [10, H / 2, 100, 200, -math.pi],
                   [100.3, 200.7, 0.3, 0.6, 0.4], [300, 400, 0, 0, 1.0]]
    else:
        x1, y1 = rng.uniform(-50, W, n), rng.uniform(-50, H, n)
        b = np.stack([x1, y1, x1 + w, y1 + h], 1)
        special = [[0, 0, 1, 1], [-100, -80, W + 90, H + 70], [W - 30, H - 40, W + 200, H + 150],
                   [-200, -150, 20, 30], [500.3, 300.7, 500.6, 301.1], [5, 5, 5, 5]]
    k = min(n, len(special))
    b[:k] = special[:k]
    return b.astype(np.float32)


def crop_edge_boxes(obb, size=FRAME_HW):
    """K5's edge boxes on a frame of ``size``: one-pixel boxes at the four
    corners and on the last row and column (their taps are the frame's last
    bytes, which K5 reads byte by byte), and boxes partly outside the frame;
    (16, 4) xyxy or (16, 5) xywha."""
    H, W = size
    if obb:
        b = [[W - 0.5, H - 0.5, 1, 1, 0], [0.5, 0.5, 1, 1, 0], [W - 0.5, 0.5, 1, 1, 0],
             [0.5, H - 0.5, 1, 1, 0], [W - 1, H - 1, 2, 2, 0.3], [W, H, 40, 80, 0.7],
             [0, 0, 40, 80, -0.7], [W - 0.5, 10, 1, 1, math.pi / 2], [10, H - 0.5, 1, 1, -math.pi],
             [W / 2, H - 2, 300, 10, 0.05], [W - 3, H / 2, 12, 200, 1.2], [-20, H / 3, 80, 60, 2.0],
             [W + 10, H + 10, 50, 50, 0.5], [W / 3, -15, 60, 60, -2.5], [W - 1.5, H - 1.5, 1, 1, 0],
             [W / 2, H / 2, 1, 1, 0.0]]
    else:
        b = [[0, 0, 1, 1], [W - 1, H - 1, W, H], [W - 1, 0, W, 1], [0, H - 1, 1, H],
             [W - 0.5, H - 0.5, W + 0.5, H + 0.5], [-10, -10, 5, 5], [W - 5, H - 5, W + 10, H + 10],
             [W - 1, 100, W, 101], [100, H - 1, 101, H], [W - 2, H - 2, W - 1, H - 1],
             [-100, 500, 50, 700], [1800, -50, 1950, 40], [W - 3, H - 3, W, H],
             [W - 40, H - 1, W, H], [-5, H - 30, 30, H + 5], [W / 2, H / 2, W / 2 + 1, H / 2 + 1]]
    return np.asarray(b, np.float32)


# K5's float operations a pixel of output, counted from csrc/crops.cu: the
# coordinates (axis-aligned: the two scales and two centre maps; rotated: the
# box-local offsets and the rotation), the two axes' taps (clamp, floor, the
# far tap, the weight) and the two complements, and per channel 4 taps /
# 255, the two horizontal and the vertical interpolation and the
# standardization
K5_OPS_PER_PIXEL = {False: 2 + 4 + 6 + 12 + 2 + 3 * 15, True: 2 + 6 + 10 + 12 + 2 + 3 * 15}


def k5_bound(frame, boxes, obb, dtype):
    """(least ms, by): bytes, the frame and the boxes read once and the crops
    written once (what the inputs need, whatever the design), against K5's
    counted operations."""
    n = boxes.shape[0]
    pixels = n * CROP_HW[0] * CROP_HW[1]
    n_bytes = frame.numel() + boxes.numel() * 4 + pixels * 3 * torch.finfo(dtype).bits // 8
    return measure.bound_ms(n_bytes, pixels * K5_OPS_PER_PIXEL[obb])


def _grid_sample_inputs(frame, boxes, obb):
    """``F.grid_sample``'s input and grid for the crops K5 cuts: the frame as
    float RGB in [0, 1], (N, 3, H, W) (expanded, not copied), and the twin's
    sampling coordinates normalized for align_corners=False."""
    H, W = frame.shape[:2]
    img = (frame.flip(-1).permute(2, 0, 1).to(torch.float32) / 255.0)[None]
    n, (oh, ow) = boxes.shape[0], CROP_HW
    i = (torch.arange(oh, device=frame.device, dtype=torch.float32) + 0.5)
    j = (torch.arange(ow, device=frame.device, dtype=torch.float32) + 0.5)
    if obb:
        cx, cy, w, h, a = boxes.T
        u = (j / ow - 0.5)[None, None, :] * w[:, None, None]
        v = (i / oh - 0.5)[None, :, None] * h[:, None, None]
        ca, sa = torch.cos(a)[:, None, None], torch.sin(a)[:, None, None]
        xs = cx[:, None, None] + u * ca - v * sa - 0.5
        ys = cy[:, None, None] + u * sa + v * ca - 0.5
    else:
        x1, y1, x2, y2 = boxes.T
        ys = (i[None, :] * ((y2 - y1) / oh)[:, None] + (y1[:, None] - 0.5))[:, :, None].expand(n, oh, ow)
        xs = (j[None, :] * ((x2 - x1) / ow)[:, None] + (x1[:, None] - 0.5))[:, None, :].expand(n, oh, ow)
    grid = torch.stack([(2 * xs + 1) / W - 1, (2 * ys + 1) / H - 1], dim=-1)
    return img.expand(n, -1, -1, -1), grid.contiguous()


def _einsum_crops(frame, boxes):
    """The JAX package's axis-aligned crops (crop_resize_aabb): dense
    (N, oh, H) and (N, ow, W) interpolation matrices and two fp32 products
    (TF32 off), as the TPU design computes them, on the card."""
    H, W = frame.shape[:2]
    img = frame.flip(-1).to(torch.float32) / 255.0
    x1, y1, x2, y2 = boxes.T

    def interp(coords, size):
        c = torch.clamp(coords, 0.0, size - 1.0)
        c0 = torch.floor(c)
        c1 = torch.clamp_max(c0 + 1, size - 1.0)
        w = (c - c0)[..., None]
        grid = torch.arange(size, device=frame.device, dtype=torch.float32)
        return (c0[..., None] == grid) * (1.0 - w) + (c1[..., None] == grid) * w

    i = torch.arange(CROP_HW[0], device=frame.device, dtype=torch.float32) + 0.5
    j = torch.arange(CROP_HW[1], device=frame.device, dtype=torch.float32) + 0.5
    wy = interp(i[None, :] * ((y2 - y1) / CROP_HW[0])[:, None] + (y1[:, None] - 0.5), H)
    wx = interp(j[None, :] * ((x2 - x1) / CROP_HW[1])[:, None] + (x1[:, None] - 0.5), W)
    t = torch.einsum("hwc,njw->nhjc", img, wx)
    return torch.einsum("nih,nhjc->nijc", wy, t)


def _k5_edge_sets(rng, frame):
    """K5's edge sets: (label, frame, boxes, (oh, ow), obb, dtype, out or
    None), AABB and OBB, fp32 and bf16: 7 x 5 outputs (ow % 4 != 0: scalar
    stores), (384, 128) outputs, one-pixel boxes at the frame's corners and
    last pixels and boxes partly outside it (``crop_edge_boxes``) on a frame
    view whose start is not 4-byte aligned (byte loads), and the kernel
    writing into an output view that is not 16-byte aligned."""
    shifted = torch.cat([frame.new_zeros(1), frame.flatten()])[1:].view(frame.shape)
    sets = []
    for obb in (False, True):
        kind = "rotated" if obb else "axis-aligned"
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).removeprefix("torch.")
            b = torch.from_numpy(crop_boxes(rng, 3, obb)).to(frame.device)
            sets.append((f"{kind} 3 crops of 7 x 5 {dt}", frame, b, (7, 5), obb, dtype, None))
            b = torch.from_numpy(crop_boxes(rng, 16, obb)).to(frame.device)
            sets.append((f"{kind} 16 crops of 384 x 128 {dt}", frame, b, (384, 128), obb, dtype,
                         None))
            b = torch.from_numpy(crop_edge_boxes(obb)).to(frame.device)
            sets.append((f"{kind} one-pixel and edge boxes, unaligned frame, {dt}", shifted, b,
                         CROP_HW, obb, dtype, None))
            buf = torch.zeros(len(b) * 3 * CROP_HW[0] * CROP_HW[1] + 1, dtype=dtype,
                              device=frame.device)
            out = buf[1:].view(len(b), 3, *CROP_HW)
            sets.append((f"{kind} edge boxes into an unaligned output, {dt}", frame, b, CROP_HW,
                         obb, dtype, out))
    return sets


def check_k5(rng):
    """K5 bit-equal to its twin on the card (and, at 64 crops, to the twin on
    the CPU, which the live paths compare against) on a seeded textured
    1080p frame, 64 and 256 boxes, axis-aligned and rotated
    (``crop_boxes``: past every edge, sub-pixel, the unit padding boxes,
    angles of +-pi/2 and +-pi), fp32 and bf16; then, fp32, its device time
    (torch.profiler) beside its bound (bytes: the frame read and the crops
    written), the wrapper's time (CUDA events around one call: the cos and
    sin of rotated boxes, the checks, the allocation), the twin's on the
    card, and as the library call the same sampling by ``F.grid_sample``
    (bilinear, border, align_corners=False) on the float frame; and once the
    TPU design's two einsums at 64 axis-aligned crops."""
    import torch.nn.functional as F

    frame = torch.from_numpy(crop_frame(1)).cuda()
    rows, library = [], []
    std = torch.tensor(IMAGENET_STD, device=frame.device)[None, :, None, None]
    mean = torch.tensor(IMAGENET_MEAN, device=frame.device)[None, :, None, None]
    for label, f, boxes, hw, obb, dtype, out in _k5_edge_sets(rng, frame):
        want = extract_crops_plain(f, boxes, hw, obb, dtype)
        if out is None:
            got = extract_crops(f, boxes, hw, obb, dtype)
        else:  # the kernel into an unaligned view (the wrapper allocates aligned ones)
            cols = 5 if obb else 4
            trig = (torch.stack([exact(torch.cos, boxes[:, 4]), exact(torch.sin, boxes[:, 4])])
                    .contiguous() if obb else None)
            launch_crops(f, boxes[:, :cols].contiguous(), trig, out)
            got = out
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K5 {label}: {int((got != want).sum())} values differ from the "
                                 f"twin")
        print(f"K5 {label}: bit-equal to the twin")
    for n in (64, 256):
        for obb in (False, True):
            boxes = torch.from_numpy(crop_boxes(rng, n, obb)).cuda()
            kind = "rotated" if obb else "axis-aligned"
            for dtype in (torch.float32, torch.bfloat16):
                got = extract_crops(frame, boxes, CROP_HW, obb, dtype)
                want = extract_crops_plain(frame, boxes, CROP_HW, obb, dtype)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    raise AssertionError(f"K5 {kind} {n} crops {dtype}: {bad} values differ from "
                                         f"the twin")
                if n == 64:
                    cpu = extract_crops_plain(frame.cpu(), boxes.cpu(), CROP_HW, obb, dtype)
                    if not torch.equal(got.cpu(), cpu):
                        raise AssertionError(f"K5 {kind} {n} crops {dtype}: differs from the "
                                             f"twin on the CPU")
                print(f"K5 {kind}, {n} crops of 256 x 128, {str(dtype).removeprefix('torch.')}: "
                      f"bit-equal to the twin{' (on the card and the CPU)' if n == 64 else ''}")
            img, grid = _grid_sample_inputs(frame, boxes, obb)
            sample = lambda: F.grid_sample(img, grid, mode="bilinear",  # noqa: E731
                                           padding_mode="border", align_corners=False)
            crops = extract_crops(frame, boxes, CROP_HW, obb)
            diff = float((sample() - (crops * std + mean)).abs().max())
            call = lambda: extract_crops(frame, boxes, CROP_HW, obb)  # noqa: E731
            row = (measure.device_ms_per_call(call, "crops_"), measure.event_ms(call),
                   measure.event_ms(lambda: extract_crops_plain(frame, boxes, CROP_HW, obb),
                                    reps=10),
                   *k5_bound(frame, boxes, obb, torch.float32))
            library.append(measure.event_ms(sample))
            print(f"K5 {kind} {n} crops fp32: device {row[0]:.5f} ms a call, wrapper "
                  f"{row[1]:.5f} ms, plain {row[2]:.5f} ms, bound {row[3]:.5f} ms ({row[4]}); "
                  f"F.grid_sample {library[-1]:.5f} ms (largest difference from K5's crops "
                  f"before standardization {diff:.3g})")
            rows.append(row)
    boxes = torch.from_numpy(crop_boxes(rng, 64, False)).cuda()
    einsum_ms = measure.event_ms(lambda: _einsum_crops(frame, boxes), reps=5, warmup=1)
    print(f"K5's TPU design on this card (two dense fp32 einsums, 64 axis-aligned crops of a "
          f"1080p frame, about 115 GFLOP): {einsum_ms:.4f} ms a call")
    entry = timing(0.0, rows)
    entry["library_ms"] = statistics.fmean(library)
    return entry


def nms_boxes(rng, n, span=(1440.0, 800.0), clusters=None, size=(8.0, 200.0)):
    """n boxes (n, 4) xyxy on a ``span`` image, around ``clusters`` centres
    (n // 8 by default) so that many overlap, and scores (n,) in (0, 1)."""
    k = clusters or max(1, n // 8)
    centres = rng.uniform(0, span, (k, 2))
    c = centres[rng.integers(0, k, n)] + rng.normal(0, 6.0, (n, 2))
    wh = rng.uniform(*size, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    return boxes, rng.uniform(0.001, 1.0, n).astype(np.float32)


def nms_edge_sets(rng, cluster_n=23625):
    """K6's edge sets: (label, boxes (N, 4), scores (N,), classes (N,) or
    None for plain NMS, iou_thresh, max_out).  The sets from "one cluster"
    on reach the sorted scan's edges (``csrc/nms.cu``): every candidate of
    ``cluster_n`` near-identical boxes examined for one kept; equal scores
    across its tiers (at max_out 256 a tier holds 512-1024 keys) and chunks;
    fewer survivors than max_out over more candidates than a tier, so that
    the next tier runs; scores at the alive rule's edges."""
    sets = []
    b, s = nms_boxes(rng, 300)
    s = (-np.abs(s) * (np.arange(300) % 2)).astype(np.float32)
    sets.append(("no positive score", b, s, None, 0.7, 64))
    b, s = nms_boxes(rng, 40, clusters=40, size=(4.0, 10.0))
    sets.append(("fewer survivors than max_out", b, s, None, 0.7, 64))
    grid = np.stack(np.meshgrid(np.arange(8) * 20.0, np.arange(8) * 20.0), -1).reshape(-1, 2)
    b = np.concatenate([grid, grid + 10.0], 1).astype(np.float32)
    sets.append(("exactly max_out", b, rng.uniform(0.1, 1, 64).astype(np.float32), None, 0.5, 64))
    b, s = nms_boxes(rng, 2000)
    sets.append(("more survivors than max_out", b, s, None, 0.7, 64))
    b, s = nms_boxes(rng, 500)
    sets.append(("tied scores", b, (np.ceil(s * 4) / 4).astype(np.float32), None, 0.6, 128))
    b, s = nms_boxes(rng, 64, clusters=8)
    b[1::2] = b[0::2]  # duplicate boxes: IoU 1
    s[1::4] = s[0::4]  # and duplicate (box, score) pairs
    sets.append(("duplicate boxes", b, s, None, 0.7, 64))
    base = np.array([[0, 0, 10, 10], [0, 0, 10, 7], [0, 0, 10, 5], [20, 20, 40, 30],
                     [20, 20, 40, 27], [20, 20, 40, 25], [50, 0, 60, 10], [50, 0, 60, 7.0001]],
                    np.float32)
    sc = np.array([0.9, 0.8, 0.7, 0.95, 0.85, 0.75, 0.6, 0.5], np.float32)
    sets.append(("IoU exactly at the threshold 0.7", base, sc, None, 0.7, 8))
    sets.append(("IoU exactly at the threshold 0.5", base, sc, None, 0.5, 8))
    b, s = nms_boxes(rng, 200, clusters=20)
    b[::3, 2] = b[::3, 0]  # zero width
    b[1::5, 3] = b[1::5, 1]  # zero height
    b[7] = [5, 5, 5, 5]
    sets.append(("zero-area boxes", b, s, None, 0.7, 64))
    b, s = nms_boxes(rng, 200, clusters=20)
    b[::7, 0] = np.nan
    b[3::11, 3] = np.nan
    b[5] = np.nan
    s[int(np.argmax(s))] = np.float32(1.5)  # the first kept box has a NaN coordinate
    b[int(np.argmax(s)), 2] = np.nan
    sets.append(("NaN coordinates", b, s, None, 0.7, 64))
    b, s = nms_boxes(rng, 200, clusters=20)
    s[::9] = np.nan
    s[4::13] = -np.inf
    s[6::17] = np.inf
    s[8::19] = 0.0
    sets.append(("NaN, +-inf and zero scores", b, s, None, 0.7, 64))
    sets.append(("N = 1", np.array([[3, 4, 50, 60]], np.float32), np.array([0.3], np.float32),
                 None, 0.7, 4))
    b, s = nms_boxes(rng, 1061, clusters=60)
    sets.append(("N = 1061 (not a multiple of 32 or 1024)", b, s, None, 0.65, 256))
    b, s = nms_boxes(rng, 600, clusters=30)
    cls = rng.integers(0, 3, 600).astype(np.float32)
    sets.append(("batched_class_nms (class x 4096)", b, s, cls, 0.6, 128))
    b = (np.array([400.0, 200.0, 520.0, 480.0]) + rng.normal(0, 0.5, (cluster_n, 4)))
    sets.append((f"one cluster of {cluster_n} near-identical boxes", b.astype(np.float32),
                 rng.uniform(0.01, 1.0, cluster_n).astype(np.float32), None, 0.7, 256))
    # clusters of 8 consecutive indices: in index order each cluster keeps its
    # first box, so 256 kept take about 2,048 candidates, past two tiers
    per, k = 8, 375
    c = np.repeat(rng.uniform((0, 0), (1440, 800), (k, 2)), per, 0) + rng.normal(0, 2.0,
                                                                              (k * per, 2))
    wh = np.repeat(rng.uniform(20, 120, (k, 2)), per, 0)
    b = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    sets.append(("every score 1.0 across tiers and chunks", b, np.ones(k * per, np.float32),
                 None, 0.5, 256))
    # at max_out 64 the first tier's target is 128 keys: 64 kept take about
    # 512 candidates, so the scan crosses tiers at the fused step's size too
    sets.append(("every score 1.0 across tiers at max_out 64", b, np.ones(k * per, np.float32),
                 None, 0.5, 64))
    b, s = nms_boxes(rng, 5000, clusters=40, size=(60.0, 120.0))
    sets.append(("fewer survivors than max_out past the first tier", b, s, None, 0.3, 256))
    b, s = nms_boxes(rng, 300, clusters=100)
    s[::5] = np.inf  # ties among +inf: the lowest index first
    s[1::7] = np.float32(1e-45)  # subnormal: flushed to zero, never kept
    s[2::11] = np.float32(1e-39)
    s[3::13] = -0.0
    s[4::17] = np.finfo(np.float32).tiny  # the least normal: alive
    sets.append(("+inf, subnormal, -0.0 and FLT_MIN scores", b, s, None, 0.6, 300))
    b, s = nms_boxes(rng, 50, clusters=45)
    sets.append(("max_out larger than N", b, s, None, 0.7, 128))
    sets.append(("N = 0", np.zeros((0, 4), np.float32), np.zeros(0, np.float32), None, 0.7, 16))
    return sets


# K6's float operations an IoU, counted from csrc/nms.cu's pair_iou: the
# intersection (2 max, 2 min, 2 subtractions, 2 clamps, a product), the two
# areas (2 subtractions and a product each), the union (an addition, a
# subtraction, a clamp), the quotient and the comparison with the threshold
K6_OPS_PER_IOU = 9 + 6 + 3 + 2


def k6_work(boxes, scores, keep, thresh, max_out):
    """The work a call's inputs need, from the twin's result and the sorted
    order alone (no kernel counter): (candidates examined, the sorted
    definition's IoUs, the literal loop's IoUs).  The alive candidates
    (score >= FLT_MIN) in order (score descending, index ascending) are
    examined up to the max_out-th kept box, or all of them.  A kept one
    needs its IoU with every box kept before it (none may suppress it); a
    suppressed one at least one, with a box that suppresses it: the least
    count, so that the bound is one no design can beat.  The literal loop
    (the JAX loop, and the kernel's first design) holds every alive
    candidate against the kept box of every step it survives; that count,
    which the first design's bound read from the kernel, is printed for the
    record."""
    s = scores.cpu().numpy()
    idx = np.nonzero(s >= np.finfo(np.float32).tiny)[0]
    order = idx[np.lexsort((idx, -s[idx].astype(np.float64)))]
    pos = np.full(len(s), -1)
    pos[order] = np.arange(len(order))
    kept = keep[keep >= 0].cpu().numpy()
    if len(kept) == max_out:  # the max_out-th kept box ends the scan (max_out 0: at once)
        examined = int(pos[kept[-1]]) + 1 if len(kept) else 0
    else:
        examined = len(order)
    sorted_iou = len(kept) * (len(kept) - 1) // 2 + examined - len(kept)
    literal = 0
    if len(kept):
        # the step at which each alive candidate leaves: kept, or first suppressed
        hit = iou_batch(boxes[torch.from_numpy(kept).to(boxes.device)], boxes) > torch.tensor(
            thresh, dtype=torch.float32, device=boxes.device)
        hit[torch.arange(len(kept)), torch.from_numpy(kept).to(boxes.device)] = True
        first = torch.where(hit.any(0), hit.int().argmax(0), len(kept)).cpu().numpy()[idx]
        literal = int(np.minimum(first, len(kept) - 1).sum() + len(idx) - len(kept))
    return examined, sorted_iou, literal


def k6_bound(n, max_out, examined, sorted_iou):
    """(least ms, by) from what the sorted definition needs on this run's
    data (``k6_work``), one count for every design: every score read once
    (N x 4 bytes: the order needs them all), the boxes of the candidates
    examined read once (x 16; no other box is looked at), the kept indices
    and mask written once (max_out x 5), and the sorted definition's IoUs."""
    return measure.bound_ms(n * 4 + examined * 16 + max_out * 5, sorted_iou * K6_OPS_PER_IOU)


def _k6_set(label, boxes, scores, classes, thresh, max_out, reps=10, timed=True):
    """K6 bit-equal to its twin (both on the card) on one set, and its line:
    the work its inputs need (``k6_work``), the wrapper's ms (CUDA events)
    and, when ``timed``, device ms a call (torch.profiler, every ``nms_*``
    kernel), the twin's ms and the bound.  Returns the row (device, wrapper,
    plain, bound, by), or None untimed."""
    dev = torch.device(CARD)
    b, sc = torch.as_tensor(boxes).to(dev), torch.as_tensor(scores).to(dev)
    c = None if classes is None else torch.as_tensor(classes).to(dev)
    counts = torch.zeros(1, dtype=torch.int64, device=dev)
    if c is not None:  # batched_class_nms: the offset, then the set as plain NMS
        b = b + c.to(torch.float32)[:, None] * CLASS_OFFSET
    got = nms(b, sc, thresh, max_out, counts=counts)
    want = nms_plain(b, sc, thresh, max_out)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"K6 {label}: keep_idx differs from the twin's "
                             f"({int((got[0] != want[0]).sum())} entries)")
    if c is not None:
        via = batched_class_nms(torch.as_tensor(boxes).to(dev), sc, c, thresh, max_out)
        if not torch.equal(via[0], got[0]):
            raise AssertionError(f"K6 {label}: batched_class_nms differs from its offset")
    examined, sorted_iou, literal = k6_work(b, sc, want[0], thresh, max_out)
    kept = int(got[1].sum())
    call = lambda: nms(b, sc, thresh, max_out)  # noqa: E731
    head = (f"K6 {label} (N = {b.shape[0]}, max_out {max_out}): bit-equal to the twin, {kept} "
            f"kept, {examined} candidates examined; IoUs: {sorted_iou} by the sorted definition "
            f"(the least it needs: the bound's), {int(counts)} evaluated by the kernel, {literal} by the literal loop")
    if not timed:
        print(f"{head}; wrapper {measure.event_ms(call, reps=reps):.5f} ms")
        return None
    row = (measure.device_ms_per_call(call, "nms_", reps=reps), measure.event_ms(call, reps=reps),
           measure.event_ms(lambda: nms_plain(b, sc, thresh, max_out), reps=2, warmup=1),
           *k6_bound(b.shape[0], max_out, examined, sorted_iou))
    print(f"{head}; device {row[0]:.5f} ms a call, wrapper {row[1]:.5f} ms, plain {row[2]:.4f} ms, "
          f"bound {row[3]:.3g} ms ({row[4]})")
    return row


# the edge sets that keep device, twin and bound times: the scan's slowest
# input (every candidate of the 23,625 examined) and the sets that cross tiers
K6_TIMED_EDGE_SETS = ("one cluster of", "every score 1.0 across tiers",
                      "fewer survivors than max_out past")


def check_k6(rng, decoded):
    """K6 bit-equal to its twin on the card on the edge sets
    (``nms_edge_sets``: its new sets reach the sorted scan's tiers, chunks
    and the alive rule's edges), on N = 23,625 random clustered boxes
    (YOLOX's anchors at (800, 1440); a third of the scores below the
    detector's conf) at max_out 256 and 64, on the decoded outputs of one
    yolox_x frame (``decoded``: boxes and conf-masked scores) at the
    detector's 256 and the fused step's 64, each with its times and bound
    (of the edge sets, those in ``K6_TIMED_EDGE_SETS`` too, the others with
    the wrapper's time alone);
    and one call's trace lists only ``nms_*`` kernels (no sort, top-k or
    library kernel).  The kernels line takes the yolox frame's two rows."""
    for label, boxes, scores, classes, thresh, max_out in nms_edge_sets(rng):
        _k6_set(label, boxes, scores, classes, thresh, max_out, reps=5,
                timed=label.startswith(K6_TIMED_EDGE_SETS))
    for max_out in (256, 64):
        boxes, scores = nms_boxes(rng, 23625)
        scores[rng.random(23625) < 1 / 3] = -1.0
        _k6_set("random clustered boxes", boxes, scores, None, 0.7, max_out, reps=5)
    boxes, masked = decoded
    rows = [_k6_set("yolox_x frame's decoded outputs", boxes, masked, None, 0.7, max_out, reps=5)
            for max_out in (256, FUSED_MAX_DETS)]
    names = measure.kernels_of_call(lambda: nms(boxes, masked, 0.7, 256))
    print(f"K6: one call's kernels on the card: {names}")
    if not names or not all(n.startswith("nms_") for n in names):
        raise AssertionError(f"K6: a call ran kernels other than nms_*: {names}")
    return {**timing(0.0, rows), "library_ms": None}


def drive(label, fn, ratio, sync_free=True, n_steps=None, once=None):
    """Drive one path with every launch counter at 0; ``ratio`` gives the
    fixed launches per step of the kernels the path must run (others must
    not run at all; an empty ratio, a host tracker's, lets none run), and
    ``n_steps``, where given, the number of steps, so that each of them
    launches exactly its ratio times ``n_steps``; ``once`` the launches the
    path makes once besides its steps (a warm-up call).  A ``sync_free``
    path runs under set_sync_debug_mode("error"), so any host sync in it
    raises."""
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
    torch.cuda.set_sync_debug_mode("error" if sync_free else 0)
    try:
        result = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = {name: wrapper.launches for name, (wrapper, _, _) in KERNELS.items()}
    print(f"launches in {label}: {counts}")
    for k, v in (once or {}).items():
        LAUNCHES[k] += v
        counts[k] -= v
    steps = {counts[k] / w for k, w in ratio.items()}
    if ratio and (min(counts[k] for k in ratio) <= 0 or len(steps) != 1):
        raise AssertionError(f"{label}: launches {counts} are not {ratio} per step")
    if n_steps is not None and steps != {n_steps}:
        raise AssertionError(f"{label}: launches {counts} are not {ratio} x {n_steps} steps")
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
    works: for kind "yolox", the raw heads of ``yolox_raw_heads(*arg)``
    (phase 8); for kind "eval", the MOT rows of ``run_eval`` of ``tracker`` on
    fixture ``arg``; for "obb", the corner rows of ``run_eval_obb`` on
    mmot-mini and the tracks of its replay; for "reid", the replay outputs of
    the cache-fed config (``REID_PARAMS``) over the seeded caches under
    ``arg`` (``reid_caches``), for OccluBoost with each sequence's gap rows
    and resurrections from its final state; for "generate", the det, mask and
    warp caches of phase 9b's ``run_generate`` on the CPU ({"dets/<seq>":
    rows, ...}); for "train", the losses of phase 10c's ``ReIDTrainer`` run
    of model ``tracker`` on the dataset under ``arg``, its checkpoints at
    each step of TRAIN_SEGMENTS and one step later, and the checkpoints of
    one step in float64 from each of TRAIN_SEGMENTS; for "tune", phase 12's
    ``tune_reference``."""
    torch.set_num_threads(1)
    if kind == "train":  # phase 10c's run on the CPU: every step's loss, some checkpoints
        torch.set_num_threads(1)  # it runs beside phases 4-9's host-bound loops
        trainer = ReIDTrainer(train_config(Path(arg), tracker), device="cpu")
        ckpts = {}
        while trainer.step < TRAIN_STEPS:
            if trainer.step in TRAIN_SEGMENTS or trainer.step - 1 in TRAIN_SEGMENTS:
                ckpts[trainer.step] = str(trainer.save_checkpoint(
                    Path(arg).parent / f"{tracker}_cpu_{trainer.step}.pt"))
            trainer.fit(steps=trainer.step + 1, log_every=1)
        exact, truth = ReIDTrainer(trainer.cfg, device="cpu", dtype=torch.float64), {}
        for s0 in TRAIN_SEGMENTS:
            exact.load_checkpoint(Path(ckpts[s0]))
            exact.fit(steps=s0 + 1, log_every=1)
            truth[s0 + 1] = str(exact.save_checkpoint(
                Path(arg).parent / f"{tracker}_cpu64_{s0 + 1}.pt"))
        return [h["loss"] for h in trainer.history], ckpts, truth
    if kind == "generate":  # phase 9b's run on the CPU: dets, masks and warps
        torch.set_num_threads(4)
        with tempfile.TemporaryDirectory() as tmp:
            run_generate(ROOTS["mot17_mini"], Path(tmp), detector=GEN_DETECTOR,
                         detector_model=create_detector(f"{GEN_DETECTOR}.pt", device="cpu"),
                         cmc_method="ecc", device="cpu")
            return {f"{next(k for k in ('dets', 'masks', 'warps') if k in p.parts)}/{p.stem}":
                    np.load(p) for p in Path(tmp).rglob("*.npy")}
    if kind == "yolox":  # the detector's raw heads: a yolox_x forward is some 800 GFLOP
        torch.set_num_threads(4)
        return yolox_raw_heads(*arg)
    if kind == "tune":  # phase 12's CPU references: cli tune and cli research
        with tempfile.TemporaryDirectory() as tmp:
            return tune_reference(Path(tmp))
    if kind == "cli":  # phase 11's CPU references: the CLI's own eval commands
        with tempfile.TemporaryDirectory() as tmp:
            return front_door_eval(tracker, "cpu", Path(tmp))
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


def start_cpu_references(pool, cache_root: Path, train_root: Path) -> dict:
    """Submit every CPU reference of phases 4-12: the three longest first
    (HybridSORT's and StrongSORT's cache-fed replays, StrongSORT's synth-long
    eval, needed late), then the rest in the order the phases read them;
    phase 10c's training runs on ``train_root``, then phase 12's ``tune`` and
    ``research`` and phase 11's evals."""
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
    submit("generate", None, None)
    for model in TRAIN_MODELS:
        submit("train", model, str(train_root))
    present = front_door_modules()
    if present["click"] and present["yaml"]:
        submit("tune", None, None)
    for label, step in FRONT_DOOR_EVALS.items():
        if all(present[m] for m in FRONT_DOOR_STEPS[step]):
            submit("cli", label, None)
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
    """Within the block, ``module.<name>`` (a function of a step, or a
    model's method, whose output nothing writes to afterwards) keeps each of
    its outputs in ``self.outs``."""

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


NAN_FRAMES = (4, 5, 11)  # the frames (0-based) in which ``with_nan_detections`` puts NaN


def with_nan_detections(frames):
    """Copies of (N, 6) detection frames in which detection 1 of frames 4, 5
    and 11 has a NaN x1, and detection 3 of frame 11 a NaN x2 and y2: NaN
    costs reach the auction and NaN-born tracks reach the Kalman bank."""
    out = [d.copy() for d in frames]
    for f in NAN_FRAMES:
        if f < len(out) and len(out[f]) > 3:
            out[f][1, 0] = np.nan
    if len(out) > 11 and len(out[11]) > 3:
        out[11][3, 2:4] = np.nan
    return out


# auction problems with non-finite costs: the special values each holds
NONFINITE = {"NaN": (np.nan,), "+inf": (np.inf,), "-inf": (-np.inf,),
             "NaN and +-inf": (np.nan, np.inf, -np.inf)}


def nonfinite_costs(rng, specials, S=2, R=20, C=16, frac=0.1):
    """(cost (S, R, C) float32, row_mask, col_mask) numpy, uniform costs
    with about ``frac`` of the entries set to each value of ``specials``
    (a -inf cost is an infinite weight: the auction runs to its cap)."""
    cost = rng.uniform(0, 1, (S, R, C)).astype(np.float32)
    for v in specials:
        cost[rng.uniform(size=(S, R, C)) < frac] = v
    return cost, rng.uniform(size=(S, R)) < 0.9, rng.uniform(size=(S, C)) < 0.9


def run_live_nan(tracker):
    """Phase 6a: live ``tracker`` on 20 frames of LIVE_SEQ with NaN
    detections (``with_nan_detections``), cuda against cpu: rows equal (NaN
    where the CPU's are NaN), and a NaN reached the card's Kalman state."""
    frames, img = _live_frames(20)
    frames = with_nan_detections(frames)
    trackers = {d: boxmot_tpu_torch.create_tracker(tracker, device=d) for d in ("cuda", "cpu")}
    n_rows, nan_state = 0, False
    for f, dets in enumerate(frames, start=1):
        g = np.asarray(trackers["cuda"].update(dets, img))
        c = np.asarray(trackers["cpu"].update(dets, img))
        if g.shape != c.shape or not np.array_equal(g[:, 4:], c[:, 4:], equal_nan=True):
            raise AssertionError(f"live {tracker} with NaN detections, frame {f}: ids/conf/cls/"
                                 f"det_ind differ between cuda and cpu")
        if not np.allclose(g[:, :4], c[:, :4], rtol=0, atol=1e-3, equal_nan=True):
            raise AssertionError(f"live {tracker} with NaN detections, frame {f}: boxes differ")
        nan_state |= bool(torch.isnan(trackers["cuda"]._state.mean).any())
        n_rows += len(g)
    if not (n_rows and nan_state):
        raise AssertionError(f"live {tracker} with NaN detections: {n_rows} rows, NaN state "
                             f"{nan_state}")
    print(f"live {tracker}, 20 frames of {LIVE_SEQ.name} with NaN detections in frames "
          f"{[f + 1 for f in NAN_FRAMES]}: {n_rows} rows equal to cpu; NaN-born tracks in the "
          f"card's Kalman state")


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


def reid_checkpoint(root: Path, name: str, seed: int = 0, crop_hw=CROP_HW) -> Path:
    """A torchreid-format checkpoint of OSNet ``name`` with seeded random
    weights, as ``torch.save`` writes a trained one (``state_dict`` with a
    classifier and the batch norms' counters).  The convolutions and the
    linear layer keep PyTorch's seeded initialization; the convolutions'
    batch norms take the running statistics of 32 crops (``crop_hw``) of a
    seeded textured frame (a forward in training mode, cumulative averages),
    so that each layer's output is normalized and the embedding varies with
    the crop (median cosine distance between crops about 0.05); the head's
    batch norm keeps its initial statistics.  With arbitrary running
    statistics the features of all crops nearly coincide (distances about
    1e-6), and an association then breaks its ties at the ulps by which two
    devices' convolutions differ; with the head's normalized too (distances
    about 0.65) it amplifies bf16's rounding to a cosine of 0.90 against
    fp32."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_osnet(name)
    crops = extract_crops(torch.from_numpy(crop_frame(seed + 100)),
                          torch.from_numpy(crop_boxes(np.random.default_rng(seed), 40, False)[8:]),
                          crop_hw)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None  # a cumulative average over the calibration batch
    with torch.no_grad():
        model.train()(crops)
    sd = model.state_dict()
    sd["fc.1.running_mean"].zero_()  # the head's statistics stay the initial ones
    sd["fc.1.running_var"].fill_(1.0)
    gen = torch.Generator().manual_seed(seed)
    sd["classifier.weight"] = torch.randn((751, 512), generator=gen)
    sd["classifier.bias"] = torch.zeros(751)
    path = root / f"{name}_seeded.pth"
    torch.save({"state_dict": sd, "epoch": 1}, path)
    return path


def calibrate_batch_norms(model: torch.nn.Module, x: torch.Tensor, floor: float = 1.0):
    """Set each batch norm's running statistics from ``x``'s forward pass (in
    eval mode, layer after layer, so that each sees its inputs as the
    calibrated net gives them): mean 0 and variance the mean square of its
    input, at least ``floor``.  A loud channel is scaled down to a unit root
    mean square and a quiet one is left as it is.  Subtracting calibrated
    means, or amplifying quiet channels (a floor near 0), makes a random
    YOLOX chaotic: a relative change of 1e-7 at the input, float32 rounding
    between two devices' convolutions, then grows to 1e-4 at the head."""
    def hook(mod, inputs):
        sq = inputs[0].detach().double().square().mean(dim=(0, 2, 3))
        mod.running_mean.zero_()
        mod.running_var.copy_(sq.clamp_min(floor).to(mod.running_var.dtype))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.BatchNorm2d)]
    try:
        with torch.no_grad():
            model.eval()(x)
    finally:
        for h in handles:
            h.remove()


def letterboxed_frames(frames, imgsz):
    """uint8 BGR frames -> a (B, 3, h, w) float32 batch of the detector's
    standardized letterboxes (``YoloXDetector.preprocess``)."""
    std = [standardize_host(letterbox_u8(f, imgsz)[0]) for f in frames]
    return torch.from_numpy(np.stack(std)).permute(0, 3, 1, 2).contiguous()


def yolox_checkpoint(root: Path, name: str, frames, imgsz, seed: int = 0,
                     device="cpu") -> Path:
    """A yolox torch checkpoint (``{"model": state_dict}``, the batch norms'
    counters included) of YOLOX ``name`` with seeded random weights:
    He-scaled convolutions, the class and objectness predictions eight
    times larger (so that the scores spread) and the box regression at a
    unit gain (its width and height logits go through ``exp``: larger ones
    make boxes of 1e12 px or infinite ones on some frames), batch-norm scales
    in [0.5, 1.5], small biases, and batch norms calibrated on the
    letterboxes of ``frames`` (``calibrate_batch_norms``) on ``device``.
    PyTorch's default initialization (a gain of 1/3 a layer) leaves the
    net's output the same for every input.  Written to ``root/<name>.pth``
    (the file name picks the variant)."""
    from boxmot_tpu_torch.models.yolox import build_yolox

    model = build_yolox(name)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod_name, m in model.named_modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                gain = {"cls_preds": 16.0, "obj_preds": 16.0, "reg_preds": 1.0}.get(
                    mod_name.split(".")[-2], 2.0)
                m.weight.normal_(0.0, math.sqrt(gain / fan_in), generator=gen)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.1, generator=gen)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
    model.to(device)
    calibrate_batch_norms(model, letterboxed_frames(frames, imgsz).to(device))
    path = root / f"{name}.pth"
    torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()}, "epoch": 1}, path)
    return path


def run_live_reid(tracker, weights, n_frames=50):
    """Phase 6e (and 10e): the live tracker computing its embeddings with its
    ReID (``create_tracker(tracker, reid_weights=weights)``: a seeded
    osnet_x0_25 checkpoint, or in 10e the name vit_nano, seeded weights; K5
    on the card) from ``n_frames`` seeded textured 1080p frames with
    MOT17-04's detections,
    CMC off, cuda against cpu: ids, conf, cls and det_ind equal, boxes within
    1e-3 px, each frame's features within 1e-4; prints BoT-SORT's smallest
    margin of an appearance distance to its threshold (scaled and not) beside
    the largest feature difference (DeepOCSORT's embedding cost enters its
    assignment with no threshold).  Every frame has detections, so K5
    launches once a frame (one class bank, at most 256 crops)."""
    frames, _ = _live_frames(n_frames)
    img = crop_frame(3)
    kw = {"use_cmc": False} if tracker == "botsort" else {"cmc_off": True}
    trackers = {d: boxmot_tpu_torch.create_tracker(tracker, device=d, reid_weights=weights, **kw)
                for d in ("cuda", "cpu")}
    n_rows, worst, feat_err, margin, update_ms = 0, 0.0, 0.0, math.inf, []
    cfg = trackers["cuda"].cfg
    thr = cfg.appearance_thresh if tracker == "botsort" else None
    for f, dets in enumerate(frames, start=1):
        with _Outputs(trackers["cuda"].model, "features") as gf, \
                _Outputs(botsort, "appearance_distance") as dist:
            t0 = time.perf_counter()
            g = np.asarray(trackers["cuda"].update(dets, img))
            update_ms.append((time.perf_counter() - t0) * 1e3)
        with _Outputs(trackers["cpu"].model, "features") as cf:
            c = np.asarray(trackers["cpu"].update(dets, img))
        for a, b in zip(gf.outs, cf.outs, strict=True):
            feat_err = max(feat_err, float((a.cpu() - b).abs().max()))
        if thr is not None:
            scale = cfg.unconfirmed_emb_scale
            margin = min([margin] + [float(torch.minimum(torch.abs(d - thr),
                                                         torch.abs(d / scale - thr)).min())
                                     for d in dist.outs if d.numel()])
        if g.shape != c.shape or not np.array_equal(g[:, 4:], c[:, 4:]):
            raise AssertionError(f"live {tracker} with ReID, frame {f}: ids/conf/cls/det_ind differ "
                                 f"between cuda and cpu (largest feature difference so far "
                                 f"{feat_err:.3g}, appearance margin {margin:.3g})")
        if len(g):
            worst = max(worst, float(np.abs(g[:, :4] - c[:, :4]).max()))
        if not (worst <= 1e-3 and feat_err <= 1e-4 and np.isfinite(g).all()):
            raise AssertionError(f"live {tracker} with ReID, frame {f}: boxes differ by {worst} px, "
                                 f"features by {feat_err}")
        n_rows += len(g)
    if n_rows == 0:
        raise AssertionError(f"live {tracker} with ReID: no track was emitted in {n_frames} frames")
    what = (f"smallest margin of an appearance distance to its threshold {margin:.3g}"
            if thr is not None else "no appearance threshold")
    print(f"live {tracker} with ReID ({trackers['cuda'].model.model_name}, {Path(str(weights)).name}"
          f"), {n_frames} textured 1080p frames of {LIVE_SEQ.name}'s detections: {n_rows} rows "
          f"equal to cpu (ids, det_ind, cls, conf exact; max box diff {worst:.3g} px); largest "
          f"feature difference {feat_err:.3g}, {what}; cuda update median "
          f"{statistics.median(update_ms[1:]):.3f} ms/frame (host clock, frames 2-{n_frames})")
    if not all(len(d) for d in frames):
        raise AssertionError("a frame without detections: K5's launches are not one a frame")


def mot17_frames() -> dict:
    """{sequence: its frames} of MOT17-mini (MOT17-02's 4 and MOT17-04's 8
    1920 x 1080 JPEGs), read by the port's ``iter_source``."""
    return {seq.name: [f for _, f in iter_source(seq)]
            for seq in sorted(ROOTS["mot17_mini"].iterdir()) if (seq / "img1").is_dir()}


def yolox_raw_heads(ckpt: str, frames) -> list:
    """The raw heads (N, 5 + C) of ``frames`` through the port's detector on
    the CPU (float32), for the card-against-CPU check."""
    det = YoloXDetector(ckpt, device="cpu", imgsz=DET_IMGSZ)
    with torch.no_grad():
        return [det.model(torch.from_numpy(det.preprocess(f)[0]).permute(2, 0, 1)[None])[0]
                .numpy() for f in frames]


def decoded_scores(det, frame):
    """(boxes, conf-masked scores) of a frame as the detector hands them to
    NMS, on the card."""
    with measure.record_calls(registry_mod, ["nms"]) as calls:
        det.process(det.preprocess(frame)[0])
    (boxes, masked, *_), _ = calls["nms"][0]
    return boxes, masked


def _box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (N, 4) and (M, 4) xyxy boxes, float64."""
    a, b = a.astype(np.float64)[:, None], b.astype(np.float64)[None]
    wh = (np.clip(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), 0, None)
          * np.clip(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), 0, None))
    area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])  # noqa: E731
    return wh / np.maximum(area(a) + area(b) - wh, 1e-12)


def _fused_vs_cpu(label, fused, seqs, staged, reid_cpu):
    """Drive ``fused`` over every sequence (reset between them) on the card,
    each frame under set_sync_debug_mode("error") with the launch counts held
    to its ratio, keeping each frame's step inputs (dets, det_valid, embs)
    and K5's crops; then hold its detections to the staged detector's
    (``staged``: {sequence: [Detections]}) and its rows to the same tracker
    run on the CPU from the card's detections and crops (with the CPU's ReID
    on those crops)."""
    cfg = fused.cfg
    ratio = dict(RATIOS["bytetrack"][0] if label == "bytetrack" else boost_ratio(cfg))
    ratio["nms"] = 1
    if fused.reid is not None:
        ratio["extract_crops"] = 1
    fused.warmup(seqs[next(iter(seqs))][0].shape[:2])
    records = {}

    def run():
        for name, frames in seqs.items():
            fused.reset()
            records[name] = []
            for frame in frames:
                with _Outputs(fused, "frame_inputs") as fi, _Outputs(fused_mod, "extract_crops") as cr:
                    rows = fused.update(frame)
                records[name].append((fi.outs[0], cr.outs[0] if cr.outs else None, rows))

    drive(f"fused {label}", run, ratio)
    init_state, step = resolve_tracker(cfg)
    identity = torch.eye(2, 3, dtype=torch.float32)[None]
    n_rows = worst = feat_err = 0.0
    for name, recs in records.items():
        state = init_state(cfg, 1, "cpu")
        for f, ((dets, valid, embs), crops, rows) in enumerate(recs):
            dets, valid = dets.cpu(), valid.cpu()
            n = int(valid.sum())
            if not torch.isfinite(dets).all():
                raise AssertionError(f"fused {label} {name} frame {f + 1}: non-finite detections")
            want = staged[name][f]
            k = min(len(want), FUSED_MAX_DETS)
            ref = np.concatenate([want.xyxy, want.conf[:, None], want.cls[:, None]], 1)[:k]
            if n != k or not np.array_equal(dets[:n, :6].numpy(), ref):
                raise AssertionError(f"fused {label} {name} frame {f + 1}: detections differ "
                                     f"from the staged detector's")
            cpu_embs = None
            if crops is not None:
                feats = reid_cpu._embed(crops.cpu().to(reid_cpu.dtype))
                cpu_embs = torch.where(valid[:, None], feats, 0.0)
                feat_err = max(feat_err, float((embs.cpu() - cpu_embs).abs().max()))
            elif wants_embs(cfg):
                cpu_embs = torch.zeros((len(valid), cfg.feat_dim))
            state, out, mask = step(cfg, state, dets[None], valid[None],
                                    None if cpu_embs is None else cpu_embs[None], identity)
            c, g = out[0][mask[0]].numpy(), np.asarray(rows)
            if g.shape != c.shape or not np.array_equal(g[:, 4:], c[:, 4:]):
                raise AssertionError(f"fused {label} {name} frame {f + 1}: ids/conf/cls/det_ind "
                                     f"differ from the CPU's (features within {feat_err:.3g})")
            if len(g):
                worst = max(worst, float(np.abs(g[:, :4] - c[:, :4]).max()))
            n_rows += len(g)
    if not (n_rows > 0 and worst <= 1e-3 and feat_err <= 1e-4):
        raise AssertionError(f"fused {label}: {n_rows} rows, boxes within {worst} px, features "
                             f"within {feat_err}")
    print(f"fused {label} (yolox_x at {DET_IMGSZ}, max_dets {FUSED_MAX_DETS}) on the 12 MOT17-mini "
          f"frames: detections equal to the staged Detector's; {int(n_rows)} rows equal to the "
          f"same tracker on the CPU fed the card's detections and crops (ids, conf, cls, det_ind "
          f"exact; boxes within {worst:.3g} px; features within {feat_err:.3g})")


def _fused_profile(label, fused, frames, card):
    """ms a frame of ``fused.update`` (host clock, the rows read back; median
    of frames 2-50), and a 16-frame profile: kernels a frame, device busy ms,
    the idle share, K6's, K5's and the convolutions' shares of busy time."""
    fused.reset()
    ms = []
    for frame in frames:
        t0 = time.perf_counter()
        fused.update(frame)
        ms.append((time.perf_counter() - t0) * 1e3)
    prof = measure.profile_steps(lambda: [fused.update_async(fr) for fr in frames[:PROFILE_FRAMES]],
                                 PROFILE_FRAMES)
    busy = prof["busy_ms_per_step"]
    share = lambda pick: sum(t for kn, (_, t) in prof["by_kernel"].items() if pick(kn)) / busy  # noqa: E731
    is_k6 = lambda kn: measure.kernel_name(kn).startswith("nms_")  # noqa: E731
    k6 = [(c, t) for kn, (c, t) in prof["by_kernel"].items() if is_k6(kn)]
    families = {}
    for kn, (c, t) in prof["by_kernel"].items():
        fam = kn.split("<")[0].split("::")[-1].split("(")[0].strip()
        launches, total = families.get(fam, (0.0, 0.0))
        families[fam] = (launches + c, total + t)
    frame_ms = statistics.median(ms[1:])
    print(json.dumps({
        "metric": f"fused_{label}_ms_per_frame", "value": frame_ms, "host_ms": ms,
        "kernels_per_frame": prof["kernels_per_step"], "busy_ms_per_frame": busy,
        "idle_share": 1.0 - busy / frame_ms, "k6_share": share(is_k6),
        "k6_ms_per_frame": sum(t for _, t in k6) if k6 else None,
        "k5_share": share(lambda kn: measure.kernel_name(kn).startswith("crops_")), "conv_share": share(_is_conv),
        "traces": prof["traces"], "imgsz": list(DET_IMGSZ), "max_dets": FUSED_MAX_DETS,
        "top_kernel_families_launches_ms_per_frame":
            dict(sorted(families.items(), key=lambda kv: -kv[1][1])[:6]), "card": card}))


def run_detector_phase(card, ckpt: Path, seqs: dict, cpu_heads):
    """Phase 8: the detector and the fused live step at full width (yolox_x
    at (800, 1440), seeded calibrated weights ``ckpt``) on the card:

    * the raw head of MOT17-04's first frame, card (fp32, TF32 off) against
      the CPU (``cpu_heads``, a worker's future), within 1e-3 of the head's
      largest value;
    * the staged ``Detector`` over the 12 MOT17-mini frames (K6 once a
      frame), K6's kept indices against the twin's on each frame's decoded
      outputs, and ``DetectorReIDPipeline`` with osnet_x0_25
      (``skip_frame_errors=False``, K6 and K5 once a frame) with no failed
      frame;
    * ``FusedLiveTracker`` with ByteTrack and with OccluBoost + osnet_x0_25
      over the 12 frames (``_fused_vs_cpu``);
    * the bf16 tier: decode and NMS in float32, and the detections it shares
      with fp32 (IoU >= 0.5);
    * the timing lines on 50 seeded textured 1080p frames: the detector's ms
      a frame (fp32, bf16) and the fused step's (``_fused_profile``)."""
    det = YoloXDetector(str(ckpt), device=CARD, imgsz=DET_IMGSZ)
    first = seqs["MOT17-04-FRCNN"][0]
    with torch.no_grad():
        head = det.model(torch.from_numpy(det.preprocess(first)[0]).to(CARD).permute(2, 0, 1)[None])
    head = head[0].cpu().numpy()
    cpu = cpu_heads.result()[0]
    diff = float(np.abs(head - cpu).max())
    scale = max(1.0, float(np.abs(cpu).max()))
    print(f"yolox_x raw head {head.shape} of MOT17-04 frame 1, card fp32 (TF32 off) against the "
          f"CPU: max diff {diff:.3g} (head's largest value {scale:.3g})")
    if not (diff <= 1e-3 * scale and np.isfinite(head).all()):
        raise AssertionError(f"yolox_x raw head: card and CPU differ by {diff}")

    runner = Detector(det)
    staged = drive("staged Detector", lambda: {
        name: runner(ROOTS["mot17_mini"] / name) for name in seqs}, {"nms": 1}, sync_free=False)
    n_dets = n_anchors = 0
    for name, frames in seqs.items():
        for f, frame in enumerate(frames):
            boxes, masked = decoded_scores(det, frame)
            n_anchors = boxes.shape[0]
            got = nms(boxes, masked, det.iou, det.MAX_DETS)
            want = nms_plain(boxes, masked, det.iou, det.MAX_DETS)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"K6 on {name} frame {f + 1}: keep_idx differs from the twin")
            n_dets += len(staged[name][f])
    print(f"staged Detector, 12 MOT17-mini frames: {n_dets} detections; K6's kept indices equal "
          f"the twin's on each frame's decoded outputs (N = {n_anchors}, max_out 256)")
    weights = reid_checkpoint(ckpt.parent, "osnet_x0_25", seed=2)
    reid = ReID(weights=weights, device=CARD)
    pipe = DetectorReIDPipeline(det, reid, skip_frame_errors=False)

    def run_pipe():
        for frames in seqs.values():
            for frame in frames:
                dets, embs, _ = pipe(frame)
                if embs is None or embs.shape != (len(dets), reid.feature_dim):
                    raise AssertionError("DetectorReIDPipeline: no embeddings for the detections")

    drive("DetectorReIDPipeline", run_pipe, {"nms": 1, "extract_crops": 1}, sync_free=False)
    if pipe.failed_frames or pipe.frames != 12:
        raise AssertionError(f"DetectorReIDPipeline: {pipe.failed_frames} failed of {pipe.frames}")
    print(f"DetectorReIDPipeline (osnet_x0_25), 12 frames: failed_frames 0; det ms "
          f"{pipe.timing.mean_ms('det_process'):.3f} (process), reid ms "
          f"{pipe.timing.mean_ms('reid'):.3f} a frame")

    reid_cpu = ReID(weights=weights, device="cpu")
    _fused_vs_cpu("bytetrack", FusedLiveTracker(det, None, "bytetrack"), seqs, staged, None)
    _fused_vs_cpu("occluboost", FusedLiveTracker(det, reid, "occluboost"), seqs, staged, reid_cpu)

    det16 = YoloXDetector(str(ckpt), device=CARD, half=True, imgsz=DET_IMGSZ)
    shared = total = total16 = 0
    for name, frames in seqs.items():
        for f, frame in enumerate(frames):
            boxes, score, *_ = det16.process(det16.preprocess(frame)[0])
            if boxes.dtype != torch.float32 or score.dtype != torch.float32:
                raise AssertionError("bf16 tier: decode and NMS must stay float32")
            d16, d32 = det16(frame), staged[name][f]
            if not np.isfinite(d16.xyxy).all():
                raise AssertionError("bf16 tier: non-finite boxes")
            if len(d16) and len(d32):
                shared += int((_box_iou(d16.xyxy, d32.xyxy).max(axis=1) >= 0.5).sum())
            total16, total = total16 + len(d16), total + len(d32)
    print(f"bf16 tier, 12 frames: {total16} detections (fp32 {total}), {shared} of them matched "
          f"to an fp32 detection at IoU >= 0.5; decode and NMS in float32")

    frames, _ = shifted_frames(TIMING_FRAMES, seed=21, step=3.0)
    frames = [np.ascontiguousarray(np.stack([f[..., 0], np.roll(f[..., 0], 7, 1),
                                             np.roll(f[..., 0], 13, 0)], -1)) for f in frames]
    for label, d in (("fp32", det), ("bf16", det16)):
        runner, ms = Detector(d), []
        for frame in frames:
            t0 = time.perf_counter()
            runner.predict_frame(frame)
            ms.append((time.perf_counter() - t0) * 1e3)
        stages = {k: runner.timing.mean_ms(f"det_{k}") for k in ("preprocess", "process",
                                                                  "postprocess")}
        print(json.dumps({"metric": f"detector_yolox_x_{label}_ms_per_frame",
                          "value": statistics.median(ms[1:]), "host_ms": ms,
                          "mean_stage_ms": stages, "imgsz": list(DET_IMGSZ), "card": card}))
    _fused_profile("occluboost_osnet_x0_25", FusedLiveTracker(det, reid, "occluboost"), frames,
                   card)
    _fused_profile("bytetrack", FusedLiveTracker(det, None, "bytetrack"), frames, card)


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


REID_BENCH_CROPS = (32, 64, 256)


def _is_conv(kernel_name: str) -> bool:
    """A convolution's kernel (cuDNN's implicit GEMMs, depthwise and direct
    kernels), by name."""
    n = kernel_name.lower()
    return any(k in n for k in ("conv", "fprop", "implicit_gemm", "depthwise", "cudnn"))


def _call_profile(fn, n) -> dict:
    """Kernels a call, device busy ms a call, the shares of busy time of K5
    (``crops_*``), K6 (``nms_*``) and the convolutions, and the four kernel
    families that take most of it (launches and ms a call), from a profile
    of ``fn`` running ``n`` calls."""
    prof = measure.profile_steps(fn, n)
    busy = prof["busy_ms_per_step"]
    share = lambda pick: sum(t for kn, (_, t) in prof["by_kernel"].items() if pick(kn)) / busy  # noqa: E731
    families = {}
    for kn, (c, t) in prof["by_kernel"].items():
        launches, total = families.get(measure.kernel_name(kn), (0.0, 0.0))
        families[measure.kernel_name(kn)] = (launches + c, total + t)
    return {"kernels_per_call": prof["kernels_per_step"], "busy_ms_per_call": busy,
            "k5_share": share(lambda kn: measure.kernel_name(kn).startswith("crops_")),
            "k6_share": share(lambda kn: measure.kernel_name(kn).startswith("nms_")),
            "conv_share": share(_is_conv), "traces": prof["traces"],
            "top_kernel_families_launches_ms_per_call":
                dict(sorted(families.items(), key=lambda kv: -kv[1][1])[:4])}


def _host_ms(fn, reps=10, warmup=3):
    """(median, all) host milliseconds of ``fn`` (which returns host data)."""
    for _ in range(warmup):
        fn()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), ms


def reid_line(metric, reid, boxes, img, card, **extra):
    """Print one ReID line: ``reid.get_features(boxes, img)``'s ms a call
    (host clock, median of 10: the frame's upload, K5, the backbone and the
    features' copy back, which waits for the card), crops/s, the device's
    idle share and a 16-call profile (``_call_profile``), with ``extra``."""
    call = lambda: reid.get_features(boxes, img)  # noqa: E731
    ms, host = _host_ms(call)
    prof = _call_profile(lambda: [call() for _ in range(16)], 16)
    print(json.dumps({"metric": metric, "ms_per_call": ms, "crops_per_s": len(boxes) / ms * 1e3,
                      "host_ms": host, "idle_share": 1.0 - prof["busy_ms_per_call"] / ms, **extra,
                      **prof, "card": card}))


def run_reid_bench(card, root: Path):
    """Phase 7f: ReID lines at full width, on the card (``reid_line``):
    ``get_features`` of osnet_x1_0 (the widest published OSNet) and
    osnet_x0_25 (the default) from seeded torchreid checkpoints, 256 x 128
    crops, 32 / 64 / 256 person-like boxes of a textured 1080p frame, fp32
    and bf16.  Checks the card's fp32 features against the CPU port's on 8
    crops (1e-4) and bf16 against fp32 (cosine >= 0.99)."""
    img = crop_frame(4)
    rng = np.random.default_rng(12)
    # person-like boxes only: the first rows of crop_boxes are its edge cases
    boxes = {n: crop_boxes(rng, n + 8, False)[8:] for n in REID_BENCH_CROPS}
    for name in ("osnet_x1_0", "osnet_x0_25"):
        weights = reid_checkpoint(root, name, seed=5)
        feats = {}
        for half in (False, True):
            reid = ReID(weights=weights, device="cuda", half=half)
            dtype = "bf16" if half else "fp32"
            for n in REID_BENCH_CROPS:
                reid_line(f"reid_{name}_{dtype}_{n}crops", reid, boxes[n], img, card)
                feats[dtype, n] = reid.get_features(boxes[n], img)
        small, large = REID_BENCH_CROPS[0], REID_BENCH_CROPS[-1]
        cpu = ReID(weights=weights, device="cpu").get_features(boxes[small][:8], img)
        err = float(np.abs(feats["fp32", small][:8] - cpu).max())
        cos = min(float(np.dot(a, b)) for a, b in zip(feats["fp32", large], feats["bf16", large]))
        print(f"ReID {name}: card fp32 features against the CPU port's on 8 crops, max diff "
              f"{err:.3g}; bf16 against fp32 on {large} crops, least cosine {cos:.5f}")
        if not (err <= 1e-4 and cos >= 0.99):
            raise AssertionError(f"ReID {name}: the card's features differ (fp32 vs cpu {err}, "
                                 f"bf16 cosine {cos})")


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


# ---------------------------------------------------------------------------
# Phase 9: cache generation on the card, the yololite predictor (K6 at 256
# anchors) and the ReID backbones beyond OSNet (K5)

LITE_TASKS = {"detect": "yololite.pt", "segment": "yololite-seg.pt", "obb": "yololite-obb.pt",
              "pose": "yololite-pose.pt"}
LITE_CONF = 0.05  # phase 9a's conf: most anchors pass it, so K6 keeps its max_out of 64
GEN_DETECTOR = "yololite-seg"  # phase 9b's detector (masks) and ReID
GEN_REID = "osnet_x0_25"
GEN_BATCH = 8  # the AutoBatcher's batch in 9b's batch_size re-run
ECC_SCALE = 0.15  # ECC's working scale: a warp's translation tolerance is 1e-3 px at it
BACKBONES = ("resnet50", "resnet101", "mobilenetv2_x1_0", "mobilenetv2_x1_4", "lmbn_n",
             "lmbn_ain_n", "mlfn", "cspreid_n", "hacnn")
BACKBONE_CROPS = 64
CHECK_CROPS = 8  # crops of 9c's and 10a's card-against-CPU check of each name


def lite_nms_inputs(model, img, conf=LITE_CONF, classes=None, agnostic=False):
    """(boxes with the class offset, conf-masked scores): what ``model``
    (a ``LiteYOLO``) hands K6 for a BGR frame, on its device."""
    padded, _ = model.letterbox(img)
    mask = torch.from_numpy(model.class_mask(classes)).to(model.device)
    *_, boxes, masked = model.decode(torch.from_numpy(padded).to(model.device), conf, mask,
                                     agnostic)
    return boxes, masked


def lite_outputs(model, img, conf=LITE_CONF) -> dict:
    """``model.program``'s kept rows of a frame on the host, keyed by anchor:
    {anchor: {head: values}} at the net's 256 x 256 input (boxes, keypoints
    and masks before the host's rescale and binarization)."""
    padded, _ = model.letterbox(img)
    res = model.program(torch.from_numpy(padded).to(model.device), conf, 0.7,
                        torch.from_numpy(model.class_mask(None)).to(model.device), False)
    res = {k: v.cpu().numpy() for k, v in res.items()}
    keep = res.pop("mask")
    return {int(a): {k: v[i] for k, v in res.items() if k != "keep_idx"}
            for i, a in enumerate(res["keep_idx"]) if keep[i]}


# head -> (tolerance card vs CPU, what it is)
LITE_TOL = {"xyxy": 1e-3, "conf": 1e-5, "cls": 0.0, "angle": 1e-5, "masks": 1e-4, "kpts": 1e-4}


def _lite_vs_cpu(task, gpu, cpu, frames) -> dict:
    """The card's kept rows against the CPU's, frame by frame: the same
    anchors kept, each head within ``LITE_TOL``; K6's kept indices equal the
    twin's on the card's own decoded boxes and scores.  Returns the worst
    difference a head, and the kept counts."""
    worst, kept = {}, []
    for i, img in enumerate(frames):
        boxes, masked = lite_nms_inputs(gpu, img)
        got, want = nms(boxes, masked, 0.7, MAX_OUT), nms_plain(boxes, masked, 0.7, MAX_OUT)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"yololite {task} frame {i}: K6 differs from its twin")
        g, c = lite_outputs(gpu, img), lite_outputs(cpu, img)
        if set(g) != set(c):
            raise AssertionError(f"yololite {task} frame {i}: the card kept anchors "
                                 f"{sorted(set(g) - set(c))}, the CPU {sorted(set(c) - set(g))}")
        kept.append(len(g))
        for a in g:
            for head, v in g[a].items():
                err = float(np.abs(v.astype(np.float64) - c[a][head]).max())
                worst[head] = max(worst.get(head, 0.0), err)
    for head, err in worst.items():
        if not err <= LITE_TOL[head]:
            raise AssertionError(f"yololite {task}: {head} differs by {err} card vs CPU "
                                 f"(tolerance {LITE_TOL[head]})")
    return {"worst": worst, "kept": kept}


def check_k6_lite(rng):
    """K6 at phase 9a's shape, run in phase 3 with the other kernel checks:
    the yololite predictor's NMS input on a seeded textured 1080p frame (256
    anchors, max_out 64, the class offset 512), class-aware, with every
    score below conf, agnostic and with a ``classes`` filter; each bit-equal
    to the twin on the card, the first timed beside its bound
    (``k6_bound``).  In phase 3, not 9a: after phases 4-8, traces that hold
    nothing but a kernel launched through ctypes lost every launch (20
    calls, six traces in a row, twice), where traces that mix them with
    PyTorch's kernels kept them."""
    model = LiteYOLO("yololite.pt", device=CARD)
    img = crop_frame(int(rng.integers(1000)))
    rows = {}
    for label, kw in (("class-aware", {}), ("every score below conf", {"conf": 1.5}),
                      ("agnostic", {"agnostic": True}), ("classes [1]", {"classes": [1]})):
        boxes, masked = lite_nms_inputs(model, img, **kw)
        rows[label] = _k6_set(f"yololite {label}", boxes, masked, None, 0.7, MAX_OUT, reps=20,
                              timed=label == "class-aware")
    return rows["class-aware"]


def run_lite_phase(card, seqs):
    """Phase 9a: each yololite task on the card through ``predict`` (counted:
    one K6 launch a frame) on the 12 MOT17-mini frames and a seeded textured
    1080p frame, against the same seeded predictor on the CPU
    (``_lite_vs_cpu``); one call's trace lists an ``nms_*`` kernel; and a
    line a task: ms a 1080p frame (host clock, median of 10) and a 16-call
    profile."""
    frames = [f for fs in seqs.values() for f in fs] + [crop_frame(9)]
    for task, weights in LITE_TASKS.items():
        gpu, cpu = LiteYOLO(weights, device="cuda"), LiteYOLO(weights, device="cpu")
        res = drive(f"yololite {task} predict", lambda: [
            gpu(f, conf=LITE_CONF)[0] for f in frames], {"nms": 1}, sync_free=False,
            n_steps=len(frames))
        cmp = _lite_vs_cpu(task, gpu, cpu, frames)
        n = [len(r.boxes) for r in res]
        print(f"yololite {task} on {len(frames)} frames: K6 bit-equal to its twin; kept "
              f"{min(cmp['kept'])}-{max(cmp['kept'])} anchors a frame, card vs CPU (the same "
              f"anchors) worst {cmp['worst']}; {min(n)}-{max(n)} boxes a frame after the host's "
              f"drop of slivers")
        img = frames[-1]
        ms, host = _host_ms(lambda: gpu(img, conf=LITE_CONF))
        padded = torch.from_numpy(gpu.letterbox(img)[0])
        prof = _call_profile(lambda: [gpu.program(padded.to(gpu.device), LITE_CONF, 0.7, torch.ones(
            gpu.nc, device=gpu.device), False) for _ in range(PROFILE_FRAMES)], PROFILE_FRAMES)
        print(json.dumps({"metric": f"yololite_{task}_1080p_ms_per_frame", "value": ms,
                          "host_ms": host, **prof, "card": card}))
    names = measure.kernels_of_call(lambda: gpu(frames[-1], conf=LITE_CONF))
    print(f"yololite: one predict call's kernels on the card include {sorted(set(names))[:12]}")
    if not any(n.startswith("nms_") for n in names):
        raise AssertionError(f"yololite: no nms_* kernel in a predict call: {names}")


def _stage_seconds(t0, marks) -> dict:
    """{sequence: {stage: seconds}} from run_generate's progress reports
    (time, sequence, frame, frames): it reports every frame of each stage in
    turn (detect, embed, warp), so a stage ends at its last report before
    the frame count starts again or the next sequence begins."""
    out, prev, stage = {}, t0, 0
    for i, (t, seq, cur, _) in enumerate(marks):
        nxt = marks[i + 1] if i + 1 < len(marks) else None
        if nxt is None or nxt[1] != seq or nxt[2] <= cur:
            out.setdefault(seq, {})[("detect", "embed", "warp")[stage]] = t - prev
            prev = t
            stage = stage + 1 if nxt is not None and nxt[1] == seq else 0
    return out


def _emb_files(root: Path) -> dict:
    return {p.stem: np.load(p) for p in sorted((root / GEN_DETECTOR / "embs").rglob("*.npy"))}


def _sorted_frame_rows(rows):
    """A permutation of det rows ordering each frame's rows by (x1, y1): the
    card's and the CPU's NMS list near-tied boxes in either order."""
    return np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))


def _check_gen_caches(card_root: Path, cpu: dict, det, reid_cpu) -> None:
    """Phase 9b's caches on the card against the CPU run's (``cpu``, a
    worker's): det rows of the same frames and count within 1e-3 (each
    frame's rows in (x1, y1) order), mask bits equal but for pixels whose
    probability lies within 1e-5 of 0.5 (counted), warps within 1e-3 (the
    translation 1e-3 px at ECC's scale), and the embeddings against the CPU
    ReID's fill over the card's det rows, within 1e-4."""
    from boxmot_tpu_torch.data import cache as cache_mod
    from boxmot_tpu_torch.data.mot import MOTDataset

    side = cache_mod.MASK_SIDE
    for seq in MOTDataset(ROOTS["mot17_mini"]):
        rel = lambda kind: f"{kind}/{seq.name}"  # noqa: E731
        g_det = np.load(cache_mod.det_cache_path(card_root, GEN_DETECTOR, seq.name))
        c_det = cpu[rel("dets")]
        pg, pc = _sorted_frame_rows(g_det), _sorted_frame_rows(c_det)
        if g_det.shape != c_det.shape or not np.array_equal(g_det[pg, 0], c_det[pc, 0]):
            raise AssertionError(f"{seq.name}: det rows differ in count or frames card vs CPU")
        det_err = float(np.abs(g_det[pg] - c_det[pc]).max(initial=0.0))
        g_m = np.load(cache_mod.mask_cache_path(card_root, GEN_DETECTOR, seq.name))
        bits = [np.unpackbits(m[:, 1:].astype(np.uint8), axis=-1)[:, : side * side]
                for m in (g_m[pg], cpu[rel("masks")][pc])]
        differ = bits[0] != bits[1]
        # the probabilities, in the card's row order, of the frames with a differing bit
        near = np.zeros(differ.shape, bool)
        for f in np.unique(g_m[pg][differ.any(1), 0].astype(int)):
            probs = det.model(load_frame(seq.img_paths[f - 1]), conf=det.conf)[0].masks.data
            H, W = probs.shape[1:]
            ys = (np.arange(side) * (H / side)).astype(int).clip(0, H - 1)
            xs = (np.arange(side) * (W / side)).astype(int).clip(0, W - 1)
            near[g_m[:, 0] == f] = (np.abs(probs[:, ys][:, :, xs] - 0.5) <= 1e-5).reshape(
                len(probs), -1)
        near = near[pg]
        g_w = np.load(cache_mod.warp_cache_path(card_root, "ecc", seq.name))
        c_w = cpu[rel("warps")]
        lin = float(np.abs(g_w[:, [1, 2, 4, 5]] - c_w[:, [1, 2, 4, 5]]).max())
        trans = float(np.abs(g_w[:, [3, 6]] - c_w[:, [3, 6]]).max())
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "embs.npy"
            generate_mod._fill_embeddings(
                seq, cache_mod.load_cached_dets_per_frame(
                    cache_mod.det_cache_path(card_root, GEN_DETECTOR, seq.name), seq.seq_length),
                path, reid_cpu, frame_cache=False)
            c_e = np.load(path)
        g_e = np.load(cache_mod.emb_cache_path(card_root, GEN_DETECTOR, GEN_REID, seq.name))
        emb_err = float(np.abs(g_e - c_e).max()) if g_e.shape == c_e.shape else math.inf
        print(f"generate {seq.name} card vs CPU: {len(g_det)} det rows, max diff {det_err:.3g}; "
              f"mask bits: {int(differ.sum())} of {differ.size} differ, "
              f"{int((differ & near).sum())} of them within 1e-5 of 0.5; warps: linear "
              f"{lin:.3g}, translation {trans:.3g} px; embeddings (the CPU's fill over the "
              f"card's det rows) {emb_err:.3g}")
        if not (det_err <= 1e-3 and not (differ & ~near).any() and lin <= 1e-3
                and trans <= 1e-3 / ECC_SCALE and emb_err <= 1e-4):
            raise AssertionError(f"generate {seq.name}: the card's caches differ from the CPU's")


def run_generate_phase(card, root: Path, cpu_jobs):
    """Phase 9b: ``run_generate`` on MOT17-mini on the card (yololite-seg, the
    ReID facade's seeded osnet_x0_25, ECC), counted: one K6 and one K5 launch
    a frame; seconds a sequence by stage and frames/s; its caches against the
    CPU run (``_check_gen_caches``); the embeddings-only re-run over its det
    caches, with frame_group 4 and with batch_size (which warns) against it;
    a trace of ``_fill_embeddings`` lists a ``crops_*`` kernel; and
    ``run_eval`` over the card's caches on the card and on the CPU: sam2mot
    from the mask cache, metrics equal, and BoT-SORT with ``reid`` and
    ``cmc_method``, rows bit-equal."""
    from boxmot_tpu_torch.data.mot import MOTDataset

    data = ROOTS["mot17_mini"]
    det = create_detector(f"{GEN_DETECTOR}.pt", device="cuda")
    reid = ReID(GEN_REID, device="cuda")
    marks = []
    t0 = time.perf_counter()
    stats = drive("run_generate yololite-seg + osnet_x0_25 + ECC", lambda: run_generate(
        data, root / "card", detector=GEN_DETECTOR, detector_model=det, reid_model=reid,
        cmc_method="ecc", device="cuda",
        progress=lambda *a: marks.append((time.perf_counter(), *a))),
        {"nms": 1, "extract_crops": 1}, sync_free=False)
    seconds = time.perf_counter() - t0
    n_frames = sum(len(q.img_paths) for q in MOTDataset(data))
    stages = _stage_seconds(t0, marks)
    print(json.dumps({"metric": "generate_mot17_mini_seconds", "value": seconds,
                      "frames_per_s": n_frames / seconds, "stage_seconds": stages,
                      "stats": stats, "card": card}))
    cpu, waited = _cpu_result(cpu_jobs, ("generate", None, None))
    print(f"waited {waited:.1f} s for the CPU run of run_generate")
    _check_gen_caches(root / "card", cpu, det, ReID(GEN_REID, device="cpu"))

    want = _emb_files(root / "card")
    for label, kw in (("embeddings-only", {}), ("frame_group 4", {"frame_group": 4}),
                      ("batch_size + frame_group 4", {"batch_size": GEN_BATCH,
                                                      "frame_group": 4})):
        out = root / label.replace(" ", "_")
        shutil.copytree(root / "card" / GEN_DETECTOR / "dets", out / GEN_DETECTOR / "dets")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            drive(f"run_generate {label}", lambda: run_generate(
                data, out, detector=GEN_DETECTOR, reid_model=reid, device="cuda", **kw),
                {"extract_crops": 1}, sync_free=False)
            s = time.perf_counter() - t0
        warned = [str(w.message) for w in caught if "frame_group" in str(w.message)]
        got = _emb_files(out)
        err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
        same = all(np.array_equal(got[k], want[k]) for k in want)
        print(f"generate {label} on the card: {s:.3f} s, embeddings against the full run's: "
              f"max diff {err:.3g} (bit-equal: {same}); warnings: {warned}")
        if got.keys() != want.keys() or not err <= 1e-5 or bool(warned) != ("batch_size" in kw):
            raise AssertionError(f"generate {label}: embeddings or warning differ")

    seq = MOTDataset(data).sequences[0]
    dets = load_cached_dets_per_frame(det_cache_path(root / "card", GEN_DETECTOR, seq.name),
                                      seq.seq_length)
    calls = iter(range(1000))
    names = measure.kernels_of_call(lambda: generate_mod._fill_embeddings(
        seq, dets, root / "trace" / f"{next(calls)}.npy", reid, frame_cache=False), calls=2)
    print(f"_fill_embeddings: one call's kernels on the card include {sorted(set(names))[:12]}")
    if not any(n.startswith("crops_") for n in names):
        raise AssertionError(f"_fill_embeddings ran no crops_* kernel: {names}")

    for tracker, kw, ratio in (("sam2mot", {}, {}),
                               ("botsort", {"reid": GEN_REID, "cmc_method": "ecc"},
                                RATIOS["botsort"][0])):
        res = {}
        for dev in ("cuda", "cpu"):
            out = root / "eval" / tracker / dev
            run = lambda: boxmot_tpu_torch.run_eval(  # noqa: E731
                data, tracker, device=dev, cache_root=root / "card", detector=GEN_DETECTOR,
                output_dir=out, **kw)
            t0 = time.perf_counter()
            metrics = drive(f"run_eval {tracker} on the generated caches", run, ratio,
                            sync_free=False) if dev == "cuda" else run()
            res[dev] = ({k: float(metrics["combined"][k]) for k in ("HOTA", "MOTA", "IDF1")},
                        _mot_rows(out), time.perf_counter() - t0)
        (gm, grows, gs), (cm, crows, cs) = res["cuda"], res["cpu"]
        equal = grows.keys() == crows.keys() and all(np.array_equal(grows[k], crows[k])
                                                      for k in grows)
        print(f"eval {tracker} over the card's caches: cuda {gm} in {gs:.3f} s, cpu {cm} in "
              f"{cs:.3f} s; MOT rows bit-equal: {equal}")
        if gm != cm or not equal or not grows:
            raise AssertionError(f"eval {tracker} over the generated caches: cuda differs from cpu")


def run_backbone_bench(card):
    """Phase 9c: each backbone of ``BACKBONES`` through the ReID facade on the
    card (seeded weights, its convolutions' batch norms calibrated on 32
    crops of the frame, ``calibrate_batch_norms``), 64 person-like boxes of
    a seeded textured 1080p frame, 256 x 128 crops (HACNN 160 x 64): the
    card's fp32 features against the CPU's on the first CHECK_CROPS crops
    (1e-4, as phase 7f checks; each crop's features are the batch's row)
    and bf16's against fp32 on all 64 (cosine >= 0.99); a line each
    (``reid_line``)."""
    img = crop_frame(4)
    rng = np.random.default_rng(13)
    boxes = crop_boxes(rng, BACKBONE_CROPS + 8, False)[8:]
    calib = crop_boxes(rng, 40, False)[8:]
    for name in BACKBONES:
        hw = (160, 64) if name == "hacnn" else CROP_HW
        gpu = ReID(model_name=name, device="cuda", crop_hw=hw)
        calibrate_batch_norms(gpu.model, extract_crops(as_frame(img, gpu.device), torch.from_numpy(
            calib).to(gpu.device), hw))
        cpu = ReID(model_name=name, device="cpu", crop_hw=hw)
        bf16 = ReID(model_name=name, device="cuda", crop_hw=hw, half=True)
        for other in (cpu, bf16):
            other.model.load_state_dict(gpu.model.state_dict())
        feats = drive(f"ReID {name}", lambda: gpu.get_features(boxes, img), {"extract_crops": 1},
                      sync_free=False, n_steps=1)
        err = float(np.abs(feats[:CHECK_CROPS] - cpu.get_features(boxes[:CHECK_CROPS], img)).max())
        cos = float(np.min(np.sum(feats * bf16.get_features(boxes, img), axis=1)))
        spread = float(1.0 - np.min(feats @ feats.T))
        reid_line(f"reid_{name}_fp32_{BACKBONE_CROPS}crops", gpu, boxes, img, card,
                  crop_hw=list(hw), feature_dim=gpu.feature_dim, max_abs_err_vs_cpu=err,
                  bf16_least_cosine=cos, largest_cosine_distance_between_crops=spread)
        if not (err <= 1e-4 and cos >= 0.99):
            raise AssertionError(f"ReID {name}: the card's features differ (fp32 vs cpu {err}, "
                                 f"bf16 cosine {cos})")


# phase 10: the transformer backbones, ReID training and CLIP's prompt learning
TRANSFORMERS = (*reid_core.VIT_VARIANTS, *reid_core.CSL_VARIANTS, "clip")
TRANSFORMER_LINES = ("vit_nano_ain_os", "vit_tiny_parts3", "csl_tinyvit_7m", "csl_tinyvit_23m_lmbn",
                     "clip")
TRAIN_MODELS = ("osnet_x0_25", "vit_nano")
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_PK = 20, 5, (16, 4)
TRAIN_IDS, TRAIN_VIEWS, TEST_IDS = 32, 8, 16  # 10c's dataset: identities, JPEGs each, test ids
# 10c: the card also trains SEGMENT_STEPS steps from the CPU run's state at each of these
TRAIN_SEGMENTS, SEGMENT_STEPS = (0, 5, 10, 15), 5
NOISE_GRAD = 1e-6  # a parameter whose step gradient RMS is below this x the largest element's
# 10c's one float32 step from the CPU's state, on the card and on the CPU, each against the
# same step in float64: the card's error at most STEP_RATIO x the CPU's + STEP_FLOOR (read on
# an H100: ratios up to 1.9; between two CPU thread counts at 128 x 64, up to 4.6)
STEP_RATIO, STEP_FLOOR = 10.0, 1e-6
STATE_KINDS = ("params", "batch_stats", "mu", "nu", "ema")
PROMPT_STEPS, PROMPT_BATCH = 3, 32


def train_config(root: Path, model: str, **kw) -> TrainConfig:
    """Phase 10c's configuration: ``model`` at P x K = 16 x 4, 256 x 128,
    TRAIN_STEPS steps (TRAIN_WARMUP of warmup) on ``reid_dataset(root)``."""
    return TrainConfig(model=model, data_root=str(root), crop_hw=CROP_HW, p=TRAIN_PK[0],
                       k=TRAIN_PK[1], steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP, seed=0, **kw)


def reid_dataset(root: Path, seed: int = 0) -> Path:
    """A seeded Market-1501-layout dataset under ``root``: TRAIN_IDS
    identities x TRAIN_VIEWS 256 x 128 JPEGs in ``bounding_box_train`` (half
    from camera 1, half from camera 2), and TEST_IDS other identities with
    one query image (camera 1) and three gallery images (camera 2).  An
    identity is a stack of 3-6 colored horizontal bands with a texture of its
    own (``default_rng((seed, pid))``); each view shifts it by up to 12 px,
    scales its brightness by 0.8-1.2 and adds noise.  Nothing is downloaded;
    about 1 s to write."""
    import cv2

    def person(pid):
        rng = np.random.default_rng((seed, pid))
        bands = int(rng.integers(3, 7))
        colors = rng.integers(0, 256, (bands, 3)).astype(np.float32)
        edges = np.sort(rng.integers(0, 256, bands - 1))
        img = np.repeat(colors[np.searchsorted(edges, np.arange(256))][:, None], 128, axis=1)
        texture = rng.normal(0, 25, (16, 8, 3)).astype(np.float32)
        return img + cv2.resize(texture, (128, 256), interpolation=cv2.INTER_LINEAR)

    splits = (("bounding_box_train", range(1, TRAIN_IDS + 1), (1, 2), TRAIN_VIEWS // 2),
              ("query", range(101, 101 + TEST_IDS), (1,), 1),
              ("bounding_box_test", range(101, 101 + TEST_IDS), (2,), 3))
    for split, pids, cams, views in splits:
        (root / split).mkdir(parents=True, exist_ok=True)
        for pid in pids:
            base = person(pid)
            for cam in cams:
                rng = np.random.default_rng((seed, pid, cam, len(split)))
                for v in range(views):
                    dy, dx = (int(d) for d in rng.integers(-12, 13, 2))
                    img = np.roll(base, (dy, dx), axis=(0, 1)) * rng.uniform(0.8, 1.2)
                    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
                    cv2.imwrite(str(root / split / f"{pid:04d}_c{cam}s1_{v:06d}_00.jpg"), img)
    return root


def _gemm_share(prof: dict) -> float:
    """The share of a profile's busy time in matrix products (cuBLAS and
    CUTLASS gemm kernels, by name; cuDNN's implicit-GEMM convolutions not)."""
    t = sum(ms for kn, (_, ms) in prof["by_kernel"].items()
            if "gemm" in kn.lower() and not _is_conv(kn))
    return t / prof["busy_ms_per_step"]


@contextlib.contextmanager
def recorded_attention():
    """Every call of the transformers' ``attention`` (ViT, CSL-TinyViT's
    windows, CLIP's image tower) while the context holds, its inputs kept."""
    from boxmot_tpu_torch.models import clip_reid as clip_mod
    from boxmot_tpu_torch.models import csl_tinyvit as csl_mod
    from boxmot_tpu_torch.models import vit as vit_mod

    real, calls = vit_mod.attention, []

    def rec(q, k, v, scale, bias=None):
        calls.append((q.clone(), k.clone(), v.clone(), scale, None if bias is None else bias.clone()))
        return real(q, k, v, scale, bias)

    mods = (vit_mod, csl_mod, clip_mod)
    for m in mods:
        m.attention = rec
    try:
        yield calls
    finally:
        for m in mods:
            m.attention = real


def attention_profile(reid, boxes, img) -> dict:
    """The plain attention's ms a ``get_features`` call (its recorded calls,
    ``vit.attention``: two products and a softmax, replayed back to back
    between CUDA events, median of 20: the card's time, as the replay
    launches large kernels faster than the card runs them), and
    ``F.scaled_dot_product_attention``'s on the same inputs (measured, not
    used by the port), with the largest difference between the two.  Not
    from a profile: late in the smoke, traces of these replays alone lost
    some or all of their device events."""
    from boxmot_tpu_torch.models.vit import attention

    with torch.no_grad(), recorded_attention() as calls:
        reid.get_features(boxes, img)
    with torch.no_grad():
        plain = measure.event_ms(lambda: [attention(*c) for c in calls], reps=20, warmup=3)
        sdpa = measure.event_ms(lambda: [F.scaled_dot_product_attention(
            q, k, v, attn_mask=b, scale=s) for q, k, v, s, b in calls], reps=20, warmup=3)
        diff = max(float((attention(*c) - F.scaled_dot_product_attention(
            c[0], c[1], c[2], attn_mask=c[4], scale=c[3])).abs().max()) for c in calls)
    return {"attention_calls": len(calls), "attention_ms_per_call": plain,
            "sdpa_ms_per_call": sdpa, "sdpa_max_abs_diff": diff,
            "attention_shape": list(calls[0][0].shape)}


def run_transformer_phase(card):
    """Phase 10a-b: (a) each of the 17 transformer names (six ViTs, ten
    CSL-TinyViT names, CLIP) through ``ReID`` on the card (seeded weights,
    the same as the CPU's), CHECK_CROPS person-like crops of 256 x 128 from
    a seeded 1080p frame: fp32 (TF32 off) within 1e-4 of the port on the
    CPU, bf16 at cosine >= 0.99 to fp32; (b) a line for each of
    TRANSFORMER_LINES at 64 crops (``reid_line``: host ms a call, median of
    10, a 16-call profile) with the matrix products' share of busy time and
    the attention's (``attention_profile``)."""
    img = crop_frame(4)
    rng = np.random.default_rng(14)
    boxes = crop_boxes(rng, BACKBONE_CROPS + 8, False)[8:]
    for name in TRANSFORMERS:
        gpu = ReID(model_name=name, device="cuda")
        feats = drive(f"ReID {name}", lambda: gpu.get_features(boxes[:CHECK_CROPS], img),
                      {"extract_crops": 1}, sync_free=False, n_steps=1)
        cpu = ReID(model_name=name, device="cpu").get_features(boxes[:CHECK_CROPS], img)
        half = ReID(model_name=name, device="cuda", half=True)
        half.model.load_state_dict(gpu.model.state_dict())
        err = float(np.abs(feats - cpu).max())
        cos = float(np.min(np.sum(feats * half.get_features(boxes[:CHECK_CROPS], img), axis=1)))
        spread = float(1.0 - np.min(feats @ feats.T))
        print(f"ReID {name}: card fp32 against the CPU port's on {CHECK_CROPS} crops, max diff "
              f"{err:.3g}; bf16 least cosine {cos:.5f}; largest cosine distance between crops "
              f"{spread:.3g}; feature width {gpu.feature_dim}")
        if not (err <= 1e-4 and cos >= 0.99):
            raise AssertionError(f"ReID {name}: the card's features differ (fp32 vs cpu {err}, "
                                 f"bf16 cosine {cos})")
        if name in TRANSFORMER_LINES:
            def line():
                prof = measure.profile_steps(lambda: [gpu.get_features(boxes, img)
                                                      for _ in range(4)], 4)
                att = attention_profile(gpu, boxes, img)
                att["attention_share"] = att["attention_ms_per_call"] / prof["busy_ms_per_step"]
                reid_line(f"reid_{name}_fp32_{BACKBONE_CROPS}crops", gpu, boxes, img, card,
                          feature_dim=gpu.feature_dim, gemm_share=_gemm_share(prof), **att)

            drive(f"ReID {name} line", line, {"extract_crops": 1}, sync_free=False)
        del gpu, half
        torch.cuda.empty_cache()


@contextlib.contextmanager
def deterministic_cudnn():
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev


def _resume_gap(straight, cfg, root: Path) -> float:
    """The largest difference between ``straight`` (TRAIN_STEPS steps) and
    half of them, a checkpoint, a new trainer resumed from it and the other
    half: every parameter, batch statistic and EMA value."""
    first = ReIDTrainer(cfg, device="cuda")
    first.fit(steps=TRAIN_STEPS // 2, log_every=TRAIN_STEPS)
    resumed = ReIDTrainer(cfg, device="cuda")
    resumed.load_checkpoint(first.save_checkpoint(root / f"{cfg.model}_mid.pt"))
    resumed.fit(log_every=TRAIN_STEPS)
    gap = max(float((a - b).abs().max()) for a, b in zip(straight.model.state_dict().values(),
                                                         resumed.model.state_dict().values())
              if a.is_floating_point())
    return max(gap, max(float((straight.ema_params[p] - resumed.ema_params[p]).abs().max())
                        for p in straight.ema_params))


def _train_state(path: Path) -> dict:
    """A trainer checkpoint's state by kind: "params" and "batch_stats"
    (the model's parameters and running statistics, by the port's keys),
    Adam's "mu" and "nu" and the "ema" (by Flax path), as float64."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    out = {"params": {}, "batch_stats": {}}
    for k, t in ckpt["model"].items():
        if t.is_floating_point():
            out["batch_stats" if k.endswith(("running_mean", "running_var")) else "params"][k] = \
                t.double()
    out.update({kind: {p: t.double() for p, t in ckpt["opt"][kind].items()}
                for kind in ("mu", "nu")})
    out["ema"] = {p: t.double() for p, t in ckpt["ema_params"].items()}
    return out


def _step_errors(trainer, before: dict, exact: dict, got: dict) -> tuple[dict, list]:
    """One float32 step from the state ``before`` (``got``) against the
    same step in float64 (``exact``): for each kind of state, the norm of
    ``got - exact`` over the norm of the step's change ``exact - before``,
    and the tensor whose own such ratio is largest.  Parameters whose
    gradient is 0 in exact arithmetic (a per-channel affine ahead of a
    batch norm in train mode) move by Adam's normalization of rounding
    noise: they are those whose step gradient (``(mu' - b1 mu) / (1 -
    b1)``, in float64) has an RMS below NOISE_GRAD of the largest
    element's, left out of the parameters, moments and EMA, and returned."""
    from boxmot_tpu_torch.reid.training.optim import ADAM_B1

    grads = {p: (exact["mu"][p] - ADAM_B1 * before["mu"][p]) / (1 - ADAM_B1)
             for p in exact["mu"]}
    top = max(float(g.abs().max()) for g in grads.values())
    noise = sorted(p for p, g in grads.items() if float(g.square().mean().sqrt()) < NOISE_GRAD * top)
    errors = {}
    for kind in STATE_KINDS:
        keys = [k for k in exact[kind]
                if (trainer.paths.get(k, k) if kind == "params" else k) not in noise]
        err = {k: float((got[kind][k] - exact[kind][k]).square().sum()) for k in keys}
        change = {k: float((exact[kind][k] - before[kind][k]).square().sum()) for k in keys}
        total = sum(change.values())
        errors[kind] = {"rel": (sum(err.values()) / total) ** 0.5 if total else 0.0,
                        "worst": max(keys, key=lambda k: err[k] / max(change[k], 1e-300))}
    return errors, noise


def _segments(cfg, cpu_losses, ckpts, truth, root: Path) -> dict:
    """The card's SEGMENT_STEPS steps from the CPU run's state at each of
    TRAIN_SEGMENTS: each step's loss against the CPU's (the largest
    relative difference), and the state after the first step, the card's
    and the CPU's, each against the same step in float64
    (``_step_errors``): the largest ratio of the card's error to STEP_RATIO
    x the CPU's + STEP_FLOOR, by kind, with both errors."""
    trainer = ReIDTrainer(cfg, device="cuda")
    loss_gap, first_gap, worst, noise = 0.0, 0.0, {}, set()
    for s0 in TRAIN_SEGMENTS:
        trainer.load_checkpoint(Path(ckpts[s0]))
        trainer.fit(steps=s0 + 1, log_every=1)
        got = _train_state(trainer.save_checkpoint(root / f"{cfg.model}_card_{s0 + 1}.pt"))
        before, exact = _train_state(Path(ckpts[s0])), _train_state(Path(truth[s0 + 1]))
        card, n = _step_errors(trainer, before, exact, got)
        cpu, _ = _step_errors(trainer, before, exact, _train_state(Path(ckpts[s0 + 1])))
        noise |= set(n)
        for kind in STATE_KINDS:
            score = card[kind]["rel"] / (STEP_RATIO * cpu[kind]["rel"] + STEP_FLOOR)
            if score >= worst.get(kind, {"score": -1.0})["score"]:
                worst[kind] = {"score": score, "card": card[kind]["rel"], "cpu": cpu[kind]["rel"],
                               "card_worst": card[kind]["worst"], "step": s0}
        hist = trainer.fit(steps=s0 + SEGMENT_STEPS, log_every=1)
        losses = [h["loss"] for h in hist[s0:s0 + SEGMENT_STEPS]]
        first_gap = max(first_gap, abs(losses[0] - cpu_losses[s0]) / abs(cpu_losses[s0]))
        loss_gap = max(loss_gap, max(abs(a - b) / abs(b) for a, b in
                                     zip(losses, cpu_losses[s0:s0 + SEGMENT_STEPS])))
        if not np.isfinite(losses).all():
            raise AssertionError(f"train {cfg.model}: a loss is not finite ({losses})")
    del trainer
    return {"segment_first_loss_rel_diff": first_gap, "segment_loss_rel_diff": loss_gap,
            "step_errors": worst, "noise_params": sorted(noise)}


def run_training_phase(card, root: Path, cpu_jobs):
    """Phase 10c: ``ReIDTrainer`` on the card for each of TRAIN_MODELS
    (osnet_x0_25: Adam; vit_nano: AdamW, clip 1.0, layer decay) on
    ``reid_dataset(root)`` at P x K = 16 x 4, 256 x 128, TRAIN_STEPS steps,
    with cuDNN's deterministic algorithms (the default ones accumulate
    weight gradients in another order from run to run: on an H100 a resumed
    run differed by 6e-3 for osnet_x0_25 and 7e-5 for vit_nano after 20
    steps), against the same run on the CPU (a worker's): the first step's
    loss within 1e-4 relative, every step's finite.  The float32 trajectory
    of osnet_x0_25 is chaotic (float32 rounding, amplified by Adam: on an
    H100 its 20 steps drifted 7.0-7.5 % from the CPU's; in float64 the port
    and JAX agree to 1e-13 over 4 steps, tests/test_torch_reid_trainer.py),
    so the straight run's drift is printed, and the later steps are held
    where a drift allowance means something: from the CPU run's state at
    each of TRAIN_SEGMENTS the card trains SEGMENT_STEPS steps, each loss
    within 5 % of the CPU's (the JAX package's drift allowance over a few
    steps, tests/test_reid_training.py:267-272), the first within 1e-4; the
    whole state after the first step (parameters, batch statistics, Adam's
    moments, EMA), the card's and the CPU's, each against the same step in
    float64 from the same state (a CPU worker's), the card's error at most
    STEP_RATIO x the CPU's + STEP_FLOOR (``_segments``); ``evaluate()`` of the card's EMA weights on the card
    against the same weights on the CPU (mAP within 1e-3); half the steps,
    a checkpoint and a resumed trainer against the straight run within
    1e-5; a line (ms a step of that ``fit``, data included; with the
    default algorithms, ms a step on a fixed batch, steps/s, kernels a
    step, busy ms and idle share from a 4-step profile).  The crops are
    made on the host (as in JAX): no hand-written kernel runs."""
    from boxmot_tpu_torch.reid.training.evaluator import evaluate_reid

    for model in TRAIN_MODELS:
        cfg = train_config(root, model)
        with deterministic_cudnn():
            trainer = ReIDTrainer(cfg, device="cuda")
            t0 = time.perf_counter()
            hist = drive(f"train {model}", lambda: trainer.fit(log_every=1), {}, sync_free=False)
            fit_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
            gap = _resume_gap(trainer, cfg, root)
            (cpu, ckpts, truth), waited = _cpu_result(cpu_jobs, ("train", model, None))
            seg = _segments(cfg, cpu, ckpts, truth, root)
        losses = [h["loss"] for h in hist]
        first = abs(losses[0] - cpu[0]) / abs(cpu[0])
        drift = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu))
        on_card = trainer.evaluate()
        on_cpu = evaluate_reid(trainer.inference_backbone().cpu(), trainer.dataset, hw=CROP_HW,
                               device="cpu")
        map_gap = abs(on_card["mAP"] - on_cpu["mAP"])
        images, labels = trainer._next_batch()
        step_ms, step_host = _host_ms(lambda: float(trainer._train_step(images, labels)[0]))
        prof = measure.profile_steps(lambda: [trainer._train_step(images, labels)
                                              for _ in range(4)], 4)
        print(json.dumps({"metric": f"train_{model}_p{TRAIN_PK[0]}k{TRAIN_PK[1]}",
                          "fit_ms_per_step": fit_ms, "fit_steps_per_s": 1e3 / fit_ms,
                          "step_ms": step_ms, "step_host_ms": step_host,
                          "steps_per_s": 1e3 / step_ms,
                          "kernels_per_step": prof["kernels_per_step"],
                          "busy_ms_per_step": prof["busy_ms_per_step"],
                          "idle_share": 1.0 - prof["busy_ms_per_step"] / step_ms,
                          "gemm_share": _gemm_share(prof),
                          "conv_share": sum(ms for kn, (_, ms) in prof["by_kernel"].items()
                                            if _is_conv(kn)) / prof["busy_ms_per_step"],
                          "losses": losses, "cpu_losses": cpu, "first_loss_rel_diff": first,
                          "largest_loss_rel_diff": drift, **seg,
                          "eval_card": on_card,
                          "eval_cpu": on_cpu, "resume_max_abs_diff": gap, "card": card}))
        steps = ", ".join(f"{k} {e['card']:.3g} (cpu {e['cpu']:.3g}; step {e['step']}, "
                          f"{e['card_worst']})" for k, e in seg["step_errors"].items())
        print(f"train {model}: first loss {losses[0]:.6f} (cpu {cpu[0]:.6f}, rel {first:.3g}), "
              f"{TRAIN_STEPS}-step drift {drift:.3g} (printed); {SEGMENT_STEPS}-step segments from the "
              f"cpu's state at {TRAIN_SEGMENTS}: losses {seg['segment_loss_rel_diff']:.3g}, "
              f"first {seg['segment_first_loss_rel_diff']:.3g}; one step's state against float64, "
              f"error over the step's change, the worst against the cpu's: {steps}; noise "
              f"tensors "
              f"{seg['noise_params']}; mAP card {on_card['mAP']:.4f} cpu {on_cpu['mAP']:.4f}, "
              f"resume gap {gap:.3g} (cudnn.deterministic); waited {waited:.1f} s for the cpu run")
        bad_state = {k: (e["card"], e["cpu"]) for k, e in seg["step_errors"].items()
                     if not e["score"] <= 1.0}
        if not (first <= 1e-4 and seg["segment_first_loss_rel_diff"] <= 1e-4
                and seg["segment_loss_rel_diff"] <= 0.05 and not bad_state
                and np.isfinite(losses).all() and map_gap <= 1e-3 and gap <= 1e-5):
            raise AssertionError(f"train {model}: the card's run differs (first {first}, segments "
                                 f"{seg['segment_loss_rel_diff']}, state {bad_state}, mAP gap "
                                 f"{map_gap}, resume gap {gap})")
        del trainer
        torch.cuda.empty_cache()


def clip_state_dict(seed: int = 0) -> dict:
    """A seeded full-size OpenAI CLIP ViT-B/16 state dict (numpy float32):
    the image tower 768 wide, 12 layers, a 14 x 14 grid of 16-pixel patches,
    projected to 512; the text tower 512 wide, 12 layers, 77 positions, the
    49,408-token vocabulary; CLIP's initialization scales."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def tower(prefix, width, layers):
        sd = {}
        for i in range(layers):
            b = f"{prefix}transformer.resblocks.{i}"
            sd.update({f"{b}.ln_1.weight": np.ones(width, np.float32),
                       f"{b}.ln_1.bias": np.zeros(width, np.float32),
                       f"{b}.ln_2.weight": np.ones(width, np.float32),
                       f"{b}.ln_2.bias": np.zeros(width, np.float32),
                       f"{b}.attn.in_proj_weight": normal((3 * width, width), width ** -0.5),
                       f"{b}.attn.in_proj_bias": np.zeros(3 * width, np.float32),
                       f"{b}.attn.out_proj.weight": normal((width, width),
                                                           (width * 2 * layers) ** -0.5),
                       f"{b}.attn.out_proj.bias": np.zeros(width, np.float32),
                       f"{b}.mlp.c_fc.weight": normal((4 * width, width), (2 * width) ** -0.5),
                       f"{b}.mlp.c_fc.bias": np.zeros(4 * width, np.float32),
                       f"{b}.mlp.c_proj.weight": normal((width, 4 * width),
                                                        (width * 2 * layers) ** -0.5),
                       f"{b}.mlp.c_proj.bias": np.zeros(width, np.float32)})
        return sd

    v, t = 768, 512
    return {"visual.conv1.weight": normal((v, 3, 16, 16), (3 * 16 * 16) ** -0.5),
            "visual.class_embedding": normal((v,), v ** -0.5),
            "visual.positional_embedding": normal((1 + 14 * 14, v), v ** -0.5),
            "visual.ln_pre.weight": np.ones(v, np.float32),
            "visual.ln_pre.bias": np.zeros(v, np.float32),
            "visual.ln_post.weight": np.ones(v, np.float32),
            "visual.ln_post.bias": np.zeros(v, np.float32),
            "visual.proj": normal((v, 512), v ** -0.5), **tower("visual.", v, 12),
            "token_embedding.weight": normal((49408, t), 0.02),
            "positional_embedding": normal((77, t), 0.01),
            "ln_final.weight": np.ones(t, np.float32), "ln_final.bias": np.zeros(t, np.float32),
            "text_projection": normal((t, 512), t ** -0.5), "logit_scale": np.float32(4.6052),
            **tower("", t, 12)}


def run_prompt_phase(card, root: Path):
    """Phase 10d: CLIP-ReID at full size from a seeded OpenAI-format
    checkpoint (``clip_state_dict``) through ``convert_clip``: the facade
    loading it from a file (``ReID(weights=...)``, CHECK_CROPS crops, card
    against CPU within 1e-4), then ``learn_identity_prompts`` with the
    converted text tower and tokenizer-embedded template (16 identities x 4
    image features, batch PROMPT_BATCH, PROMPT_STEPS steps) on the card
    against the CPU: losses within rtol 1e-4, the context vectors within
    1e-5; its ms a step."""
    sd = clip_state_dict()
    t0 = time.perf_counter()
    conv = convert_clip(sd)
    convert_s = time.perf_counter() - t0
    path = root / "clip_seeded.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    img = crop_frame(5)
    boxes = crop_boxes(np.random.default_rng(15), CHECK_CROPS + 8, False)[8:]
    feats = {d: ReID(weights=path, model_name="clip", device=d) for d in ("cuda", "cpu")}
    got = drive("ReID clip from a converted checkpoint",
                lambda: feats["cuda"].get_features(boxes, img), {"extract_crops": 1},
                sync_free=False, n_steps=1)
    err = float(np.abs(got - feats["cpu"].get_features(boxes, img)).max())
    del feats
    rng = np.random.default_rng(16)
    labels, dim = np.repeat(np.arange(16), 4), conv["text_config"]["proj_dim"]
    image_feats = (rng.normal(size=(16, dim))[labels] + rng.normal(0, 0.5, (64, dim))).astype(
        np.float32)
    cfg = PromptStageConfig(num_classes=16, batch=PROMPT_BATCH, steps=PROMPT_STEPS, seed=0)
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[dev] = drive(f"learn_identity_prompts {dev}", lambda: learn_identity_prompts(
            image_feats, labels, cfg, pretrained=conv, device=dev), {}, sync_free=False)
        out[dev + "_s"] = time.perf_counter() - t0
    (_, gp, gl), (_, cp, cl) = out["cuda"], out["cpu"]
    loss_gap = float(np.max(np.abs(gl - cl) / np.abs(cl)))
    ctx_gap = float((gp["prompt"]["cls_ctx"] - cp["prompt"]["cls_ctx"]).abs().max())
    print(json.dumps({"metric": "clip_prompt_learning", "convert_clip_s": convert_s,
                      "facade_max_abs_err_vs_cpu": err, "losses": gl.tolist(),
                      "cpu_losses": cl.tolist(), "loss_rel_diff": loss_gap,
                      "cls_ctx_max_abs_diff": ctx_gap,
                      "card_ms_per_step": out["cuda_s"] * 1e3 / PROMPT_STEPS,
                      "cpu_ms_per_step": out["cpu_s"] * 1e3 / PROMPT_STEPS, "card": card}))
    if not (err <= 1e-4 and loss_gap <= 1e-4 and ctx_gap <= 1e-5 and np.isfinite(gl).all()):
        raise AssertionError(f"CLIP prompts: the card differs (facade {err}, losses {loss_gap}, "
                             f"context {ctx_gap})")


# phase 11's sub-steps and the modules beyond numpy, torch and cv2 that each
# needs (the machine with the card may lack them): (b) is tune-kf and an eval
# with its JSON, (b-gsi) that eval's GSI chain, (b-tuned) the tuned eval
FRONT_DOOR_STEPS = {"a": ("click",), "b": ("click",), "b-gsi": ("click", "sklearn"),
                    "b-tuned": ("click", "yaml"), "c": ("click", "yaml"), "d": ("yaml",),
                    "e": ("click",)}
FRONT_DOOR_RECORDED = ("click", "yaml", "rich", "sklearn", "matplotlib", "pyarrow")
# the CLI evals of (b) and (c) that a CPU worker repeats: label -> its sub-step
FRONT_DOOR_EVALS = {"kf_noise": "b", "tuned": "b-tuned", "mmot": "c"}
TUNED = "occluboost_mot17_ablation"


def front_door_modules() -> dict:
    """{module: present} for phase 11's optional modules (not imported)."""
    import importlib.util

    return {m: importlib.util.find_spec(m) is not None for m in FRONT_DOOR_RECORDED}


def front_door_cli(*args):
    """The port's CLI in-process, as ``python -m boxmot_tpu_torch.engine.cli``
    would run ``args``; returns the command's value (an eval's metrics)."""
    from boxmot_tpu_torch.engine.cli import cli

    return cli.main([str(a) for a in args], prog_name="boxmot-tpu-torch", standalone_mode=False)


def _kf_eval_args(kf: Path, device) -> list:
    """(b)'s eval: ByteTrack on MOT17-mini with tune-kf's JSON, and GSI where
    sklearn is installed."""
    gsi = all(front_door_modules()[m] for m in FRONT_DOOR_STEPS["b-gsi"])
    return ["eval", "--data", ROOTS["mot17_mini"], "--kf-noise", kf, "--device", device,
            *(("--postprocessing", "gsi") if gsi else ())]


def front_door_eval(label, device, tmp: Path):
    """One of phase 11's CLI evals on ``device``: "kf_noise" (tune-kf's JSON of
    MOT17-mini into ByteTrack's eval, ``_kf_eval_args``; returns its metrics
    and the JSON's text), "tuned" (OccluBoost with ``TUNED``) or "mmot"
    (ByteTrack on the mmot-mini benchmark, class-averaged)."""
    mot17 = ROOTS["mot17_mini"]
    if label == "kf_noise":
        kf = tmp / "kf.json"
        front_door_cli("tune-kf", "--data", mot17, "--tracker", "bytetrack", "--out", kf)
        return _metrics(front_door_cli(*_kf_eval_args(kf, device))), kf.read_text()
    if label == "tuned":
        res = front_door_cli("eval", "--data", mot17, "--tracker", "occluboost", "--tuned", TUNED,
                             "--device", device)
    else:
        res = front_door_cli("eval", "--benchmark", "mmot-mini", "--tracker", "bytetrack",
                             "--device", device)
    return _metrics(res), None


def _metrics(res) -> dict:
    return {k: float(res["combined"][k]) for k in ("HOTA", "MOTA", "IDF1")}


def _front_door_line(metric, value, card, **extra):
    print(json.dumps({"metric": metric, "value": value, "clock": "host wall", **extra,
                      "card": card}))


def _held_to_cpu(label, got, cpu_jobs):
    (want, _), waited = _cpu_result(cpu_jobs, ("cli", label, None))
    print(f"{label}: cuda {got}, cpu {want} (waited {waited:.1f} s for the cpu)")
    if any(not abs(got[k] - want[k]) <= ATOL for k in want):
        raise AssertionError(f"phase 11 {label}: the card's metrics differ from the CPU's")


def run_front_door_phase(card, ckpt: Path, cpu_jobs):
    """Phase 11: the CLI and the Boxmot API on the card (see the module
    docstring); each sub-step runs where its modules are present, and each
    one that is not run is named."""
    from boxmot_tpu_torch.configs import load_tuned_config

    present = front_door_modules()
    print(f"phase 11 modules present: {present}")
    run = {}
    for step, needs in FRONT_DOOR_STEPS.items():
        missing = [m for m in needs if not present[m]]
        run[step] = not missing
        for m in missing:
            print(f"phase 11 ({step}) not run: module {m} is not installed")
    mot17 = ROOTS["mot17_mini"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if run["a"]:
            t0 = time.perf_counter()
            res = drive("cli eval bytetrack", lambda: front_door_cli(
                "eval", "--data", mot17, "--tracker", "bytetrack", "--device", "cuda"),
                RATIOS["bytetrack"][0])
            seconds = time.perf_counter() - t0
            got = _metrics(res)
            for k, v in PINNED[("mot17_mini", "bytetrack")].items():
                if not abs(got[k] - v) <= ATOL:
                    raise AssertionError(f"cli eval bytetrack {k} = {got[k]} misses the pin {v}")
            _front_door_line("cli_eval_bytetrack_mot17_mini_seconds", seconds, card, **got)
        if run["b"]:
            kf = tmp / "kf.json"
            drive("cli tune-kf", lambda: front_door_cli(
                "tune-kf", "--data", mot17, "--tracker", "bytetrack", "--out", kf), {})
            (_, cpu_json), _ = _cpu_result(cpu_jobs, ("cli", "kf_noise", None))
            if kf.read_text() != cpu_json:
                raise AssertionError("cli tune-kf: the JSON differs from the CPU worker's")
            args = _kf_eval_args(kf, "cuda")
            t0 = time.perf_counter()
            res = drive(f"cli {' '.join(map(str, args[3:]))}",
                        lambda: front_door_cli(*args), RATIOS["bytetrack"][0])
            seconds = time.perf_counter() - t0
            _held_to_cpu("kf_noise", _metrics(res), cpu_jobs)
            _front_door_line("cli_eval_kf_noise_seconds", seconds, card,
                             gsi="--postprocessing" in args, **_metrics(res))
        if run["b-tuned"]:
            params = load_tuned_config(TUNED)
            params.setdefault("with_reid", False)  # as run_eval resolves it without --reid
            t0 = time.perf_counter()
            res = drive(f"cli eval --tuned {TUNED}", lambda: front_door_cli(
                "eval", "--data", mot17, "--tracker", "occluboost", "--tuned", TUNED,
                "--device", "cuda"), boost_ratio(build_replay_config("occluboost", **params)))
            seconds = time.perf_counter() - t0
            _held_to_cpu("tuned", _metrics(res), cpu_jobs)
            _front_door_line("cli_eval_tuned_seconds", seconds, card, tuned=TUNED,
                             **_metrics(res))
        if run["c"]:
            t0 = time.perf_counter()
            res = drive("cli eval --benchmark mmot-mini", lambda: front_door_cli(
                "eval", "--benchmark", "mmot-mini", "--tracker", "bytetrack", "--device", "cuda"),
                RATIOS["bytetrack"][1])
            seconds = time.perf_counter() - t0
            _held_to_cpu("mmot", _metrics(res), cpu_jobs)
            _front_door_line("cli_eval_mmot_mini_seconds", seconds, card, **_metrics(res))
        if run["d"]:
            from boxmot_tpu_torch.api import Boxmot

            t0 = time.perf_counter()
            got = drive("Boxmot.track bytetrack", lambda: Boxmot(
                tracker="bytetrack", device="cuda").track(source=LIVE_SEQ),
                RATIOS["bytetrack"][0], sync_free=False)
            ms = (time.perf_counter() - t0) * 1e3 / len(got)
            want = Boxmot(tracker="bytetrack", device="cpu").track(source=LIVE_SEQ)
            rows = worst = 0
            for f, (g, c) in enumerate(zip(got, want), start=1):
                g, c = np.asarray(g), np.asarray(c)
                if g.shape != c.shape or not np.array_equal(g[:, [4, 6, 7]], c[:, [4, 6, 7]]):
                    raise AssertionError(f"Boxmot.track frame {f}: ids or det_ind differ from cpu")
                worst = max(worst, float(np.abs(g[:, :4] - c[:, :4]).max(initial=0.0)))
                rows += len(g)
            if len(got) != len(want) or not rows or not worst <= 1e-4:
                raise AssertionError(f"Boxmot.track: {rows} rows, boxes differ by {worst} px")
            print(f"Boxmot.track bytetrack over {LIVE_SEQ.name}: {len(got)} frames, {rows} rows "
                  f"equal to the cpu's (ids, det_ind exact; max box diff {worst:.3g} px)")
            _front_door_line("api_track_bytetrack_ms_per_frame", ms, card, frames=len(got))
        if run["e"]:
            import cv2

            video = tmp / "track.mp4"
            n_frames = len(list((LIVE_SEQ / "img1").iterdir()))
            t0 = time.perf_counter()
            rows = drive("cli track yolox_x + osnet_x0_25 + botsort", lambda: front_door_cli(
                "track", "--source", LIVE_SEQ, "--detector", ckpt, "--reid-weights",
                "osnet_x0_25", "--tracker", "botsort", "--save-video", video, "--show-timing",
                "--device", "cuda"),
                {**RATIOS["botsort"][0], "nms": 1, "extract_crops": 1}, sync_free=False,
                n_steps=n_frames, once={"nms": 1, "extract_crops": 1})
            ms = (time.perf_counter() - t0) * 1e3 / n_frames
            cap, written = cv2.VideoCapture(str(video)), 0
            while cap.read()[0]:
                written += 1
            cap.release()
            if written != n_frames or not np.isfinite(rows).all():
                raise AssertionError(f"cli track: {written} video frames of {n_frames}, "
                                     f"{len(rows)} rows")
            print(f"cli track over {LIVE_SEQ.name}: {n_frames} frames, {len(rows)} rows, a video "
                  f"of {written} frames")
            _front_door_line("cli_track_yolox_x_osnet_botsort_ms_per_frame", ms, card,
                             frames=n_frames, note="model build and warm-up included")


# phase 12: tuning, research and the native cores through the CLI
TUNE_TRIALS = 8
TUNE_WORKERS = 4
RESEARCH_CANDIDATES = 4
SOURCE_CANDIDATES = 1  # two children a candidate, each ~13 s on the card
API_TRIALS = 4
NATIVE_TOOLS = ("cmake", "c++")  # what ``cli build`` needs to build native/cpp
# the ``:cpp`` pins of tests/test_pinned_metrics.py on MOT17-mini (a CPU test
# holds them equal)
CPP_PINNED = {
    "bytetrack:cpp": {"HOTA": 0.649859, "MOTA": 0.495283, "IDF1": 0.662461},
    "occluboost:cpp": {"HOTA": 0.649804, "MOTA": 0.492925, "IDF1": 0.660348},
}


def tune_args(work: Path, device, n_workers=1) -> list:
    """Phase 12's ``cli tune``: ByteTrack on MOT17-mini, random search, seed 0."""
    return ["tune", "--data", ROOTS["mot17_mini"], "--tracker", "bytetrack", "--n-trials",
            TUNE_TRIALS, "--backend", "random", "--n-workers", n_workers, "--work-dir", work,
            "--device", device]


def research_args(work: Path, device, *extra) -> list:
    return ["research", "--data", ROOTS["mot17_mini"], "--tracker", "bytetrack", "--work-dir",
            work, "--device", device, *extra]


def _trials(work: Path) -> list:
    """The trials.json of a tune work dir, without the seconds each took."""
    return [{k: v for k, v in t.items() if k != "seconds"}
            for t in json.loads((work / "trials.json").read_text())]


def _research_log(work: Path) -> dict:
    return json.loads((work / "research.json").read_text())


def tune_reference(tmp: Path) -> tuple[list, dict]:
    """Phase 12's CPU references: the trials of ``cli tune`` and the research
    log of ``cli research`` (parameters), on the CPU."""
    front_door_cli(*tune_args(tmp / "tune", "cpu"))
    front_door_cli(*research_args(tmp / "research", "cpu", "--n-candidates",
                                  RESEARCH_CANDIDATES))
    return _trials(tmp / "tune"), _research_log(tmp / "research")


def _close(label, got: dict, want: dict):
    if any(not abs(got[k] - want[k]) <= ATOL for k in ("HOTA", "MOTA", "IDF1")):
        raise AssertionError(f"{label}: metrics {got} differ from the cpu's {want}")


def _pinned(label, got: dict, pins=PINNED[("mot17_mini", "bytetrack")]):
    for k, v in pins.items():
        if not abs(got[k] - v) <= ATOL:
            raise AssertionError(f"{label}: {k} = {got[k]} misses the pin {v}")


def _check_trials(label, got: list, want: list):
    """The card's trials against the CPU worker's: the same params and errors
    (none), metrics within ATOL."""
    if [t["params"] for t in got] != [t["params"] for t in want]:
        raise AssertionError(f"{label}: the trials' params differ from the cpu's")
    if any(t["error"] is not None for t in got + want):
        raise AssertionError(f"{label}: a trial failed: {[t['error'] for t in got + want]}")
    for g, w in zip(got, want):
        _close(f"{label} trial {g['index']}", g["metrics"], w["metrics"])


def run_tuning_phase(card, cpu_jobs):
    """Phase 12: ``cli tune`` with 1 and 4 workers, a rerun, ``cli research``
    over parameters and over source, ``cli build`` and the ``:cpp`` evals, and
    ``Boxmot.tune``, on the card (see the module docstring)."""
    present = front_door_modules()
    missing = [m for m in ("click", "yaml") if not present[m]]
    if missing:
        print(f"phase 12 not run: module(s) {missing} not installed")
        return
    tools = {t: shutil.which(t) for t in NATIVE_TOOLS}
    print(f"phase 12 native build tools: {tools}")
    ratio = RATIOS["bytetrack"][0]
    (cpu_trials, cpu_research), waited = _cpu_result(cpu_jobs, ("tune", None, None))
    print(f"phase 12 cpu references ready (waited {waited:.1f} s)")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        runs = {}
        for workers in (1, TUNE_WORKERS):
            work = tmp / f"tune{workers}"
            t0 = time.perf_counter()
            drive(f"cli tune x{TUNE_TRIALS} --n-workers {workers}",
                  lambda: front_door_cli(*tune_args(work, "cuda", workers)), ratio)
            seconds = time.perf_counter() - t0
            runs[workers] = _trials(work)
            _check_trials(f"cli tune --n-workers {workers}", runs[workers], cpu_trials)
            _front_door_line(f"cli_tune_seconds_per_trial_{workers}_worker", seconds / TUNE_TRIALS,
                             card, trials=TUNE_TRIALS, workers=workers, seconds=seconds)
        _pinned("cli tune's default trial", runs[1][0]["metrics"])
        if runs[TUNE_WORKERS] != runs[1]:
            raise AssertionError(f"cli tune: {TUNE_WORKERS} workers' trials differ from 1 worker's")
        print(f"cli tune: {TUNE_TRIALS} trials, params equal to the cpu's, metrics within {ATOL}, "
              f"{TUNE_WORKERS} workers bit-equal to 1")
        drive("cli tune rerun (resume)", lambda: front_door_cli(*tune_args(tmp / "tune1", "cuda")),
              {})
        if _trials(tmp / "tune1") != runs[1]:
            raise AssertionError("cli tune: a rerun in the same work dir changed its trials")

        t0 = time.perf_counter()
        drive(f"cli research x{RESEARCH_CANDIDATES}", lambda: front_door_cli(*research_args(
            tmp / "research", "cuda", "--n-candidates", RESEARCH_CANDIDATES)), ratio,
            sync_free=False)  # the preflight's live update reads its rows back
        seconds = time.perf_counter() - t0
        got = _research_log(tmp / "research")
        if [h["params"] for h in got["history"]] != [h["params"] for h in cpu_research["history"]]:
            raise AssertionError("cli research: the candidates' params differ from the cpu's")
        for g, w in zip([got["baseline"], *got["history"]],
                        [cpu_research["baseline"], *cpu_research["history"]]):
            if g.get("error") or w.get("error"):
                raise AssertionError(f"cli research: a candidate failed: {g}, {w}")
            _close("cli research", g["metrics"], w["metrics"])
        _pinned("cli research's baseline", got["baseline"]["metrics"])
        _front_door_line("cli_research_seconds_per_candidate", seconds / RESEARCH_CANDIDATES,
                         card, candidates=RESEARCH_CANDIDATES, seconds=seconds)

        work = tmp / "source"
        t0 = time.perf_counter()
        summary = drive(f"cli research --edit-source x{SOURCE_CANDIDATES}", lambda: front_door_cli(
            *research_args(work, "cuda", "--edit-source", "--n-candidates", SOURCE_CANDIDATES)),
            {}, sync_free=False)  # the card's work runs in the children
        seconds = time.perf_counter() - t0
        children = [json.loads(line) for line in (work / "children.jsonl").read_text().splitlines()]
        if len(children) != 2 * (SOURCE_CANDIDATES + 1) or summary["n_evaluated"] != SOURCE_CANDIDATES:
            raise AssertionError(f"cli research --edit-source: {len(children)} children, {summary}")
        if {c["device"] for c in children} != {"cuda"} or any(c["built"] for c in children):
            raise AssertionError(f"cli research --edit-source: a child ran off the card or ran "
                                 f"nvcc: {children}")
        _pinned("cli research --edit-source's baseline", children[1]["metrics"])
        print(f"cli research --edit-source: {len(children)} children on cuda, none ran nvcc; "
              f"{summary['n_failed']} of {SOURCE_CANDIDATES} candidates failed")
        _front_door_line("cli_research_edit_source_seconds_per_child", seconds / len(children),
                         card, children=len(children), seconds=seconds)

        if all(tools.values()):
            from boxmot_tpu_torch import native

            prebuilt = (native._BUILD_DIR / "libboxmot_native.so").exists()
            t0 = time.perf_counter()
            drive("cli build", lambda: front_door_cli("build", "--device", "cuda"), {})
            _front_door_line("cli_build_seconds", time.perf_counter() - t0, card,
                             library_found_built=prebuilt)
            for tracker, workers in (("bytetrack:cpp", TUNE_WORKERS), ("occluboost:cpp", 1)):
                t0 = time.perf_counter()
                res = drive(f"cli eval {tracker}", lambda: front_door_cli(
                    "eval", "--data", ROOTS["mot17_mini"], "--tracker", tracker, "--n-workers",
                    workers, "--device", "cuda"), {})
                seconds = time.perf_counter() - t0
                _pinned(f"cli eval {tracker}", _metrics(res), CPP_PINNED[tracker])
                _front_door_line(f"cli_eval_{tracker.replace(':', '_')}_seconds", seconds, card,
                                 workers=workers, **_metrics(res))
        else:
            for step in ("cli build", "cli eval bytetrack:cpp", "cli eval occluboost:cpp"):
                print(f"phase 12 ({step}) not run: {[t for t, p in tools.items() if not p]} "
                      f"not installed")

        from boxmot_tpu_torch.api import Boxmot

        t0 = time.perf_counter()
        best = drive(f"Boxmot.tune x{API_TRIALS}", lambda: Boxmot(
            tracker="bytetrack", device="cuda").tune(data=ROOTS["mot17_mini"], n_trials=API_TRIALS,
                                                     work_dir=tmp / "api"), ratio)
        seconds = time.perf_counter() - t0
        if _trials(tmp / "api") != runs[1][:API_TRIALS]:
            raise AssertionError("Boxmot.tune: its trials differ from cli tune's first ones")
        want = max((t for t in runs[1][:API_TRIALS]), key=lambda t: t["score"])
        if best["params"] != want["params"]:
            raise AssertionError("Boxmot.tune: its best differs from cli tune's")
        _front_door_line("api_tune_seconds_per_trial", seconds / API_TRIALS, card,
                         trials=API_TRIALS)


# phase 13: ReID export, its runtimes and the sequence-parallel replay
EXPORT_MODEL, EXPORT_HW = "osnet_x0_25", (256, 128)  # the JAX CLI's export defaults
EXPORT_TARGETS = ("checkpoint", "torch", "onnx", "saved_model", "tflite")
TF_TARGETS = ("saved_model", "tflite")
EXPORT_TOL = 5e-3  # the CLI's verification, and the TF and native runtimes' features
EXPORT_BOXES, SHARDED_CROPS = 32, 64
EXPORT_MODULES = ("click", "tensorflow", "msgpack")
RUNTIME_REPS = 3  # timed calls of each reloaded runtime after its first (the C++ one: none)


def export_modules() -> dict:
    """{module: present} for phase 13's optional modules (not imported)."""
    import importlib.util

    return {m: importlib.util.find_spec(m) is not None for m in EXPORT_MODULES}


def _runtime_line(label, backend, boxes, img, want, tol, ratio, card, reps=RUNTIME_REPS):
    """Drive ``backend.get_features`` once against the source features
    (``want``: to the bit where ``tol`` is 0) and ``reps`` times more, timing
    each call after the first (the first too where ``reps`` is 0: ms a call,
    host clock), launching ``ratio`` a call."""
    calls = 1 + reps
    ms = []

    def run():
        t0 = time.perf_counter()
        got = backend.get_features(boxes, img)
        first = (time.perf_counter() - t0) * 1e3
        for _ in range(reps):
            t0 = time.perf_counter()
            backend.get_features(boxes, img)
            ms.append((time.perf_counter() - t0) * 1e3)
        ms.extend([] if reps else [first])
        return got

    got = drive(f"create_reid {label}", run, ratio, sync_free=False,
                n_steps=calls if ratio else None)
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or not err <= tol:
        raise AssertionError(f"phase 13 {label}: features {got.shape} {err} from the source "
                             f"model's (tolerance {tol})")
    print(json.dumps({"metric": f"reid_runtime_{label}_ms_per_call",
                      "value": statistics.median(ms), "ms": ms, "boxes": len(boxes),
                      "max_abs_err": err, "backend": type(backend).__name__, "card": card}))


def run_export_phase(card):
    """Phase 13: ``cli export`` of every target, each artifact reloaded through
    ``create_reid`` on the card, ``sharded_batch_replay`` and
    ``sharded_reid_features`` over ``sequence_mesh()`` and ``Boxmot.export``
    (see the module docstring)."""
    from boxmot_tpu_torch.api import Boxmot
    from boxmot_tpu_torch.native.reid import export_native_reid
    from boxmot_tpu_torch.parallel.replay import (
        sequence_mesh,
        sharded_batch_replay,
        sharded_reid_features,
    )
    from boxmot_tpu_torch.reid.backends import create_reid

    present = export_modules()
    tools = {t: shutil.which(t) for t in NATIVE_TOOLS}
    print(f"phase 13 modules present: {present}; native build tools: {tools}")
    if not present["click"]:
        print("phase 13 (a, b, e) not run: module click is not installed")
    targets = [t for t in EXPORT_TARGETS if present["tensorflow"] or t not in TF_TARGETS]
    for t in EXPORT_TARGETS:
        if t not in targets:
            print(f"phase 13 (a, b: {t}) not run: module tensorflow is not installed")
    src = ReID(model_name=EXPORT_MODEL, device="cuda", crop_hw=EXPORT_HW)
    img = crop_frame(seed=13)
    boxes = crop_boxes(np.random.default_rng(13), EXPORT_BOXES + 6, obb=False)[6:]
    want = src.get_features(boxes, img)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if present["click"]:
            t0 = time.perf_counter()
            arts = drive("cli export", lambda: front_door_cli(
                "export", "--model", EXPORT_MODEL, "--include", ",".join(targets), "--imgsz",
                ",".join(map(str, EXPORT_HW)), "--out-dir", tmp / "exports", "--device", "cuda"),
                {}, sync_free=False)
            print(json.dumps({"metric": "cli_export_seconds", "value": time.perf_counter() - t0,
                              "targets": {t: {"seconds": i["seconds"],
                                              "max_dev": i.get("max_dev")}
                                          for t, i in arts.items()},
                              "clock": "host wall", "card": card}))
            for t in ("onnx", "tflite"):
                if t in arts and not arts[t]["max_dev"] <= EXPORT_TOL:
                    raise AssertionError(f"phase 13 (a): {t} {arts[t]['max_dev']} from the card")
            for t in targets:
                if t == "onnx":
                    continue  # create_reid takes no ONNX file, in either package
                exact = t in ("checkpoint", "torch")
                _runtime_line(t, create_reid(arts[t]["path"], device="cuda", crop_hw=EXPORT_HW),
                              boxes, img, want, 0.0 if exact else EXPORT_TOL,
                              {"extract_crops": 1}, card)
        if all(tools.values()):
            manifest = export_native_reid(EXPORT_MODEL, src.model, tmp / "native", EXPORT_HW)
            _runtime_line("native", create_reid(manifest), boxes, img, want, EXPORT_TOL, {}, card,
                          reps=0)  # ~3.5 s a call on the card's host
        else:
            print(f"phase 13 (b: native) not run: {[t for t, p in tools.items() if not p]} "
                  "not installed")

        # (c) ByteTrack's replay at the bench shape over the mesh (one card here)
        cfg = ByteTrackConfig()
        batch = np.stack([pack_frames(synthetic_frames(N_FRAMES, N_DETS, seed=s), D=D_BENCH,
                                      F=N_FRAMES, det_cols=6)[0] for s in range(N_SEQS)])
        mesh = sequence_mesh()
        ms = []

        def sharded():
            for _ in range(2):  # a warm-up, then the timed run
                t0 = time.perf_counter()
                out = sharded_batch_replay(cfg, batch, mesh)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            return out

        counts_before = {k: LAUNCHES[k] for k in ("fused_iou_cost", "masked_assignment")}
        _, outs, masks = drive(f"sharded_batch_replay bytetrack over {len(mesh)} card(s)",
                               sharded, RATIOS["bytetrack"][0], sync_free=False,
                               n_steps=2 * N_FRAMES)
        _, want_outs, want_masks = batch_replay(cfg, init_states(cfg, N_SEQS, "cuda"),
                                                torch.from_numpy(batch).cuda())
        if not (torch.equal(outs, want_outs) and torch.equal(masks, want_masks)):
            raise AssertionError("phase 13 (c): sharded_batch_replay's rows differ from "
                                 "batch_replay's")
        print(json.dumps({"metric": f"sharded_bytetrack_replay_fps_{N_DETS}dets",
                          "value": N_SEQS * N_FRAMES / (ms[-1] / 1e3), "unit": "frames/s",
                          "clock": "host wall, upload and synchronize included",
                          "shape": [N_SEQS, N_FRAMES, N_DETS, D_BENCH, CAPACITY],
                          "mesh": [str(d) for d in mesh], "ms": ms,
                          "launches": {k: LAUNCHES[k] - v for k, v in counts_before.items()},
                          "card": card}))

        # (d) the data-parallel ReID forward of NHWC crops
        crop_boxes_ = crop_boxes(np.random.default_rng(14), SHARDED_CROPS + 6, obb=False)[6:]
        crops = extract_crops(as_frame(img, "cuda"), torch.from_numpy(crop_boxes_).cuda(),
                              EXPORT_HW).permute(0, 2, 3, 1).contiguous().cpu().numpy()
        t0 = time.perf_counter()
        feats = drive("sharded_reid_features", lambda: sharded_reid_features(src, crops, mesh),
                      {}, sync_free=False)
        seconds = time.perf_counter() - t0
        ref = src._embed(torch.from_numpy(crops).permute(0, 3, 1, 2).cuda()).cpu().numpy()
        err = float(np.abs(feats - ref).max())
        if feats.shape != ref.shape or not err <= 1e-5:
            raise AssertionError(f"phase 13 (d): sharded_reid_features {err} from ReID._embed")
        print(json.dumps({"metric": "sharded_reid_features_ms", "value": seconds * 1e3,
                          "crops": SHARDED_CROPS, "max_abs_err": err, "card": card}))

        # (e) the facade's export of one target
        t0 = time.perf_counter()
        res = drive("Boxmot.export onnx", lambda: Boxmot(reid=EXPORT_MODEL, device="cuda").export(
            include=("onnx",), out_dir=tmp / "api", hw=EXPORT_HW), {}, sync_free=False)
        if not (res["onnx"]["path"].exists() and res["onnx"]["max_dev"] <= EXPORT_TOL):
            raise AssertionError(f"phase 13 (e): Boxmot.export gave {res}")
        print(json.dumps({"metric": "api_export_onnx_seconds", "value": time.perf_counter() - t0,
                          "max_dev": res["onnx"]["max_dev"], "card": card}))


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


def run_phases(lap, smi, cpu_jobs, cache_root, ckpt, seqs, cpu_heads, train_root):
    """Phases 3-13; returns phase 3's timing entries and K4's XYSCR rows."""
    rng = np.random.default_rng(0)
    det = YoloXDetector(str(ckpt), device=CARD, imgsz=DET_IMGSZ)
    decoded = decoded_scores(det, seqs["MOT17-04-FRCNN"][0])
    del det
    step_calls = bench_step_calls()
    checks = {"fused_iou_cost": check_k1(rng, step_calls),
              "masked_assignment": check_k2(rng, step_calls),
              "rotated_iou": check_k3(rng, step_calls)}
    checks["oru_replay"], xyscr_rows = check_k4(rng, step_calls)
    del step_calls
    check_kalman_obb(rng)
    checks["extract_crops"] = check_k5(rng)
    checks["nms"] = check_k6(rng, decoded)
    del decoded
    check_k6_lite(rng)
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
    for tracker in ("bytetrack", "ocsort"):
        drive(f"live {tracker} NaN detections", lambda: run_live_nan(tracker), RATIOS[tracker][0],
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
    lap("phase 6a-d (live)")
    weights = reid_checkpoint(cache_root.parent, "osnet_x0_25", seed=2)
    for tracker in ("botsort", "deepocsort"):  # K5 once a frame: every frame has detections
        drive(f"live {tracker} ReID", lambda: run_live_reid(tracker, weights),
              {**RATIOS[tracker][0], "extract_crops": 1}, sync_free=False)
    lap("phase 6e (live ReID)")
    run_throughput(smi, lap)
    drive("bench ReID", lambda: run_reid_bench(smi, cache_root.parent), {"extract_crops": 1},
          sync_free=False)
    lap("phase 7f (ReID lines)")
    run_detector_phase(smi, ckpt, seqs, cpu_heads)
    lap("phase 8 (the detector and the fused live step)")
    run_lite_phase(smi, seqs)
    lap("phase 9a (yololite)")
    run_generate_phase(smi, cache_root.parent / "generate", cpu_jobs)
    lap("phase 9b (run_generate)")
    run_backbone_bench(smi)
    lap("phase 9c (ReID backbones)")
    run_transformer_phase(smi)
    lap("phase 10a-b (transformer backbones)")
    run_training_phase(smi, train_root, cpu_jobs)
    lap("phase 10c (ReID training)")
    run_prompt_phase(smi, cache_root.parent)
    lap("phase 10d (CLIP prompt learning)")
    drive("live botsort ReID vit_nano", lambda: run_live_reid("botsort", "vit_nano", 20),
          {**RATIOS["botsort"][0], "extract_crops": 1}, sync_free=False)
    lap("phase 10e (live BoT-SORT with vit_nano)")
    run_front_door_phase(smi, ckpt, cpu_jobs)
    lap("phase 11 (the CLI and the API)")
    run_tuning_phase(smi, cpu_jobs)
    lap("phase 12 (tuning, research and the native cores)")
    run_export_phase(smi)
    lap("phase 13 (export, runtimes and the sequence-parallel replay)")
    return checks, xyscr_rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    # a crash in native code prints every thread's Python stack, and the lines
    # before it reach a redirected log
    faulthandler.enable()
    sys.stdout.reconfigure(line_buffering=True)
    t_start = time.perf_counter()

    def lap(label):
        print(f"{label} done at {time.perf_counter() - t_start:.1f} s")

    # the CPU references of phases 4-5, in worker processes that run beside
    # phases 2-5 (spawned, so that no worker inherits the card's context);
    # the pool is shut down on the way out, failure or not
    import multiprocessing

    with contextlib.ExitStack() as stack:
        cache_root = reid_caches(Path(stack.enter_context(tempfile.TemporaryDirectory())) / "cache")
        train_root = reid_dataset(cache_root.parent / "reid-train")
        pool = concurrent.futures.ProcessPoolExecutor(
            CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"))
        stack.callback(pool.shutdown, wait=True, cancel_futures=True)
        cpu_jobs = start_cpu_references(pool, cache_root, train_root)
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {kind}")
        print(f"nvidia-smi: {smi}")
        build_kernels()
        # phase 8's seeded yolox_x, calibrated on the card, and its CPU raw head
        seqs = mot17_frames()
        ckpt = yolox_checkpoint(cache_root.parent, "yolox_x", seqs["MOT17-04-FRCNN"][:2],
                                DET_IMGSZ, device="cuda")
        cpu_heads = pool.submit(cpu_job, "yolox", None, (str(ckpt), seqs["MOT17-04-FRCNN"][:1]))
        lap("phase 2 (kernels built, yolox_x checkpoint written)")
        checks, xyscr_rows = run_phases(lap, smi, cpu_jobs, cache_root, ckpt, seqs, cpu_heads,
                                        train_root)

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"nvidia-smi: {smi}")
    for name, c in checks.items():
        print(f"wrapper ms {name}: {c['wrapper_ms']:.5f} (CUDA events around one call of the "
              f"wrapper, host work included)")
    print(json.dumps({"k4_xyscr": [
        {"set": label, "ms": r[0], "wrapper_ms": r[1], "plain_ms": r[2], "bound_ms": r[3],
         "bound_by": r[4]} for label, r in xyscr_rows]}))
    # library_ms: no single PyTorch call computes K1-K4's functions; K5's is
    # F.grid_sample's sampling of the same crops
    kernels = [
        {"name": name, "route": "cuda", "source": f"boxmot_tpu_torch/csrc/{src}.cu",
         "replaces": replaces, "launches": LAUNCHES[name],
         **{k: checks[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": checks[name].get("library_ms")}
        for name, (_, src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
