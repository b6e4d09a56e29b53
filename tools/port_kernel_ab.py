#!/usr/bin/env python3
"""Time the port's kernels and bench step in one checkout of the port, so
that two checkouts can be compared on one card, in turns.

    python3 tools/port_kernel_ab.py --root DIR [--label NAME]

DIR is the root of a checkout (this repository's or, say, a parent commit
unpacked with ``git archive``).  Its ``boxmot_tpu_torch`` and ``chip_smoke``
(for the bench's seeded frame generators and shape) are imported; the
measurement helpers come from this file's own checkout
(``boxmot_tpu_torch/utils/measure.py``, loaded by path), so both sides are
measured the same way.  On one CUDA card it:

1. builds the checkout's kernels;
2. records the kernel launches of one steady bench step (frame 64 of the
   bench's 8 sequences x 100 detections, D = 128, capacity 256), AABB and
   OBB ByteTrack, and times each kernel's device time per launch on those
   inputs (torch.profiler), and K3 at 4096 x 4096; K1's wrapper time per
   launch (CUDA events around one call) and, where the checkout has it, the
   launch floor: an empty kernel through K1's ctypes path, on one block and
   on the grids of K1's launches in this design and in the first one (one
   pair a thread, 256-thread blocks);
3. profiles 16 bench steps of each: kernels and device busy ms per step,
   the auction's and rotated IoU's device ms per step, and host ms per step
   without the profiler;
4. times the full bench replay (frames/s, the median of 3 launches after a
   warm-up), as chip_smoke.py's bench lines do;
5. OC-SORT AABB with 5 % of the detections missed a frame
   (``synthetic_frames_missed``): records the ORU launch of the step that
   chip_smoke.py's phase 3 records (frame 64 of 65) and times kernel K4's
   device time per launch on its inputs and on chip_smoke.py's all-rejoin
   sets (``oru_inputs`` at 8 x 256, AABB and OBB, gaps 2-31); then profiles
   16 OC-SORT steps of the bench input (frames 64-79): kernels, device busy
   and K4's device ms per step, and host ms per step without the profiler;
6. where the checkout has BoT-SORT (PR 7 on): its AABB step at the bench
   shape with chip_smoke.py's appearance inputs (512-d embeddings made on
   the card, a per-frame translation warp; ``appearance_batch``), the YAML
   thresholds: 16 steps under the profiler (kernels, device busy, and K1's,
   K2's and the embedding product's device ms per step), host ms per step
   without it, and frames/s of the whole bench replay (3 launches after a
   warm-up);
7. where the checkout has OccluBoost: the same for its AABB step
   at ``OccluBoostConfig()``, the configuration bench.py runs;
8. where the checkout has HybridSORT: kernel K4's XYSCR instance timed on
   the ORU launch of a recorded HybridSORT bench step (its YAML tier with
   appearance, 5 % of detections missed, frame 64 of 65, as chip_smoke.py's
   phase 3 records it) and on the all-rejoin XYSCR set (``oru_inputs`` at
   8 x 256, gaps 2-31), and the same AABB step profile as in 6, with K4's
   device ms per step, on 5 % missed;
9. K6 (greedy NMS) on chip_smoke.py's phase 3 inputs: one yolox_x frame's
   decoded outputs (seeded calibrated weights, MOT17-04's first frame; made
   once and kept in ``build/scratch/k6_inputs.pt`` so that checkouts timed
   in turns share them) and 23,625 random clustered boxes with a third of the scores below
   the detector's conf, each at max_out 256 and 64: device ms a call (every
   ``nms_*`` kernel), the wrapper's ms, and its kept indices against the
   twin's;
10. K5 (the ReID crops) on 64 and 256 boxes of phase 3's seeded 1080p
   frame, axis-aligned and rotated, fp32: device ms a call (every
   ``crops_*`` kernel) and the wrapper's ms.

``--sections`` picks among ``trackers`` (steps 2-8), ``k6`` and ``k5``
(all three by default).  It prints one JSON object and appends it to
chiprun_out/port_kernel_ab.jsonl.
Compare two checkouts only within one run on one card, in turns
(A, B, B, A).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
# the yolox_x frame's decoded outputs for step 9, made by the first run and
# read by the others, so that checkouts timed in turns share them
K6_INPUTS = HERE / "build" / "scratch" / "k6_inputs.pt"


def _load_measure():
    spec = importlib.util.spec_from_file_location(
        "port_measure", HERE / "boxmot_tpu_torch" / "utils" / "measure.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--sections", default="trackers,k6,k5",
                    help="comma-separated: trackers (steps 2-8), k6, k5")
    args = ap.parse_args()
    sections = set(args.sections.split(","))
    if not torch.cuda.is_available():
        print("port_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from boxmot_tpu_torch.csrc import build

    import boxmot_tpu_torch
    if Path(boxmot_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {boxmot_tpu_torch.__file__}, not the package under {root}")
    measure = _load_measure()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        list(pool.map(build.build, ("iou_cost", "auction", "rotated_iou", "oru", "crops", "nms")))

    result = {"label": args.label or str(root), "card": smi}
    if "k6" in sections:
        result.update(_k6(cs, measure, K6_INPUTS))
    if "k5" in sections:
        result.update(_k5(cs, measure))
    if "trackers" in sections:
        result.update(_trackers(cs, measure))
    line = json.dumps(result)
    print(line)
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "port_kernel_ab.jsonl", "a") as f:
        f.write(line + "\n")
    return 0


def _k6(cs, measure, inputs: Path) -> dict:
    """Step 9: K6 on the yolox_x frame's decoded outputs and on the random
    clustered boxes, at max_out 256 and 64."""
    from boxmot_tpu_torch.ops.nms import nms, nms_plain

    if not inputs.exists():
        import tempfile

        from boxmot_tpu_torch.detectors.registry import YoloXDetector

        frames = cs.mot17_frames()["MOT17-04-FRCNN"]
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = cs.yolox_checkpoint(Path(tmp), "yolox_x", frames[:2], cs.DET_IMGSZ,
                                       device="cuda")
            det = YoloXDetector(str(ckpt), device="cuda", imgsz=cs.DET_IMGSZ)
            boxes, masked = cs.decoded_scores(det, frames[0])
        inputs.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"boxes": boxes.cpu(), "scores": masked.cpu()}, inputs)
    saved = torch.load(inputs)
    rng = np.random.default_rng(0)
    b, s = cs.nms_boxes(rng, 23625)
    s[rng.random(23625) < 1 / 3] = -1.0
    sets = {"yolox": (saved["boxes"].cuda(), saved["scores"].cuda()),
            "clustered": (torch.from_numpy(b).cuda(), torch.from_numpy(s).cuda())}
    result = {}
    for label, (boxes, scores) in sets.items():
        for max_out in (256, 64):
            call = lambda: nms(boxes, scores, 0.7, max_out)  # noqa: E731
            got, want = call(), nms_plain(boxes, scores, 0.7, max_out)
            key = f"k6_{label}_{max_out}"
            result[f"{key}_equal_to_twin"] = bool(torch.equal(got[0], want[0]))
            result[f"{key}_device_ms_per_call"] = measure.device_ms_per_call(call, "nms_")
            result[f"{key}_wrapper_ms"] = measure.event_ms(call)
    return result


def _k5(cs, measure) -> dict:
    """Step 10: K5 on 64 and 256 boxes of the seeded 1080p frame."""
    from boxmot_tpu_torch.ops.crops import extract_crops

    frame = torch.from_numpy(cs.crop_frame(1)).cuda()
    result = {}
    for n in (64, 256):
        for obb in (False, True):
            boxes = torch.from_numpy(cs.crop_boxes(np.random.default_rng(n), n, obb)).cuda()
            call = lambda: extract_crops(frame, boxes, cs.CROP_HW, obb)  # noqa: E731
            key = f"k5_{'obb' if obb else 'aabb'}_{n}"
            result[f"{key}_device_ms_per_call"] = measure.device_ms_per_call(call, "crops_")
            result[f"{key}_wrapper_ms"] = measure.event_ms(call)
    return result


def _trackers(cs, measure) -> dict:
    """Steps 2-8, with the checkout's port (``main`` has put it first on
    the path)."""
    from boxmot_tpu_torch.engine.replay import batch_replay, init_states, pack_frames
    from boxmot_tpu_torch.ops import fused_iou_cost as fic
    from boxmot_tpu_torch.ops.geometry import obb_corners
    from boxmot_tpu_torch.ops.rotated_iou import rotated_iou
    from boxmot_tpu_torch.trackers import bytetrack
    from boxmot_tpu_torch.trackers.bytetrack import ByteTrackConfig

    result = {}
    paths = {
        "aabb": (ByteTrackConfig(capacity=cs.CAPACITY), cs.synthetic_frames, 6),
        "obb": (ByteTrackConfig(capacity=cs.CAPACITY, is_obb=True),
                lambda n, d, seed: cs.synthetic_obb_frames(n, d, seed=seed, miss=0.0), 7),
    }
    kernels = {"fused_iou_cost": "iou_cost_", "masked_assignment": "auction_",
               "rotated_iou": "rotated_iou_"}
    k1_calls = []  # K1's arguments at the AABB bench step
    for label, (cfg, frames_fn, cols) in paths.items():
        packed = [pack_frames(frames_fn(cs.N_FRAMES, cs.N_DETS, seed=s), D=cs.D_BENCH,
                              F=cs.N_FRAMES, det_cols=cols)[0] for s in range(cs.N_SEQS)]
        batch = torch.from_numpy(np.stack(packed)).cuda()
        states, _, _ = batch_replay(cfg, init_states(cfg, cs.N_SEQS, "cuda"), batch[:, :64])
        names = [n for n in kernels if hasattr(bytetrack, n)]
        with measure.record_calls(bytetrack, names) as rec:
            batch_replay(cfg, states, batch[:, 64:65])
        for name, calls in rec.items():
            times = []
            for a, kw in calls:
                if name == "rotated_iou":  # the kernel alone, corners made beforehand
                    a = [a[0], a[1]] + [obb_corners(x).contiguous() for x in (a[0], a[1])]
                if name == "fused_iou_cost" and len(a) == 2 and torch.equal(*a):
                    a = [a[0], a[0]]  # the step passes one box tensor twice
                times.append(measure.device_ms_per_call(
                    lambda: getattr(bytetrack, name)(*a, **kw), kernels[name]))
                if name == "fused_iou_cost":
                    k1_calls.append(a)
            result[f"{label}_{name}_device_ms_per_launch"] = times
        if label == "aabb":
            result["aabb_fused_iou_cost_wrapper_ms_per_launch"] = [
                measure.event_ms(lambda: fic.fused_iou_cost(*a)) for a in k1_calls]

        # 16 steps under the profiler, and without it on the host clock
        s16, _, _ = batch_replay(cfg, init_states(cfg, cs.N_SEQS, "cuda"), batch[:, :64])
        prof = measure.profile_steps(lambda: batch_replay(cfg, s16, batch[:, 64:80]), 16)
        result[f"{label}_kernels_per_step"] = prof["kernels_per_step"]
        result[f"{label}_busy_ms_per_step"] = prof["busy_ms_per_step"]
        result[f"{label}_profile_traces"] = prof["traces"]
        for name, k in kernels.items():
            hits = [v for key, v in prof["by_kernel"].items() if k in key]
            result[f"{label}_{name}_ms_per_step"] = sum(ms for _, ms in hits)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch_replay(cfg, s16, batch[:, 80:96])
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 16
        result[f"{label}_host_ms_per_step"] = host_ms
        result[f"{label}_idle_share"] = 1.0 - prof["busy_ms_per_step"] / host_ms

        # the whole bench replay, as chip_smoke.py's bench line times it
        ms = []
        for i in range(4):
            st = init_states(cfg, cs.N_SEQS, "cuda")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            batch_replay(cfg, st, batch)
            end.record()
            end.synchronize()
            if i:
                ms.append(start.elapsed_time(end))
        result[f"{label}_replay_fps"] = cs.N_SEQS * cs.N_FRAMES / (statistics.median(ms) / 1e3)

    if hasattr(fic, "empty_launch"):  # the launch floor: an empty kernel at K1's grids
        grids = {(1, 32)}
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for a in k1_calls:
            S, K, D = a[0].shape[0], a[0].shape[1], a[1].shape[1]
            grids.add((S * -(-K * D // 256), 256))  # the one-pair-a-thread design's grid
            g = fic.launch_geometry(S, K, D, sms)
            grids.add((S * g.row_blocks, g.quads * g.lanes))
        result["launch_floor_ms"] = {
            f"{b}x{t}": measure.device_ms_per_call(
                lambda: fic.empty_launch(torch.device("cuda"), b, t), "empty_kernel")
            for b, t in sorted(grids)}
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(cs._obbs(rng, 1, 4096)).cuda() for _ in range(2))
    c1, c2 = (obb_corners(x).contiguous() for x in (a, b))
    result["rotated_iou_4096_device_ms"] = measure.device_ms_per_call(
        lambda: rotated_iou(a, b, c1, c2), "rotated_iou_", reps=5, warmup=2)
    result.update(_ocsort(cs, measure))
    if hasattr(cs, "appearance_batch"):
        from boxmot_tpu_torch.engine.eval import build_replay_config

        result.update(_appearance(cs, measure, "botsort",
                                  build_replay_config("botsort", capacity=cs.CAPACITY)))
    if importlib.util.find_spec("boxmot_tpu_torch.trackers.occluboost") is not None:
        from boxmot_tpu_torch.trackers.occluboost import OccluBoostConfig

        result.update(_appearance(cs, measure, "occluboost",
                                  OccluBoostConfig(capacity=cs.CAPACITY)))
    if importlib.util.find_spec("boxmot_tpu_torch.trackers.hybridsort") is not None:
        from boxmot_tpu_torch.engine.eval import build_replay_config

        cfg = build_replay_config("hybridsort", capacity=cs.CAPACITY)
        result.update(_hybridsort_k4(cs, measure, cfg))
        result.update(_appearance(cs, measure, "hybridsort", cfg, miss=cs.MISS))
    return result


def _ocsort(cs, measure) -> dict:
    """Step 5: K4 on the recorded OC-SORT AABB step and the all-rejoin sets,
    and the 16-step OC-SORT profile, with the checkout's port (``main`` has
    put it first on the path)."""
    from boxmot_tpu_torch.engine.replay import batch_replay, init_states, pack_frames
    from boxmot_tpu_torch.trackers import ocsort
    from boxmot_tpu_torch.trackers.ocsort import OcSortConfig

    result = {}
    cfg = OcSortConfig(capacity=cs.CAPACITY)
    packed = [pack_frames(cs.synthetic_frames_missed(65, cs.N_DETS, seed=100 + s), D=cs.D_BENCH,
                          F=65, det_cols=6)[0] for s in range(cs.N_SEQS)]
    batch = torch.from_numpy(np.stack(packed)).cuda()
    states, _, _ = batch_replay(cfg, init_states(cfg, cs.N_SEQS, "cuda"), batch[:, :64])
    with measure.record_calls(ocsort, ["oru_replay"]) as rec:
        batch_replay(cfg, states, batch[:, 64:])
    sets = {"ocsort_step": rec["oru_replay"][0][0]}
    for seed, obb in enumerate((False, True)):
        layout, tensors, rejoin, gap = cs.oru_inputs(np.random.default_rng(seed), cs.N_SEQS,
                                                     cs.CAPACITY, obb)
        replayed = torch.zeros(cs.N_SEQS, dtype=torch.int32)
        sets[f"all_rejoin_{'obb' if obb else 'aabb'}"] = [
            layout, *(t.cuda() for t in (*tensors, rejoin, gap, replayed))]
    for label, args in sets.items():
        result[f"oru_{label}_device_ms_per_launch"] = measure.device_ms_per_call(
            lambda: ocsort.oru_replay(*args), "oru_")
        result[f"oru_{label}_slots_rejoining"] = int(args[7].sum())
        result[f"oru_{label}_longest_gap"] = int(torch.where(args[7], args[8], 0).max())

    # 16 steps of the bench input under the profiler, and without it on the host clock
    packed = [pack_frames(cs.synthetic_frames_missed(cs.N_FRAMES, cs.N_DETS, seed=s), D=cs.D_BENCH,
                          F=cs.N_FRAMES, det_cols=6)[0] for s in range(cs.N_SEQS)]
    batch = torch.from_numpy(np.stack(packed)).cuda()
    s16, _, _ = batch_replay(cfg, init_states(cfg, cs.N_SEQS, "cuda"), batch[:, :64])
    prof = measure.profile_steps(lambda: batch_replay(cfg, s16, batch[:, 64:80]), 16)
    result["ocsort_kernels_per_step"] = prof["kernels_per_step"]
    result["ocsort_busy_ms_per_step"] = prof["busy_ms_per_step"]
    result["ocsort_profile_traces"] = prof["traces"]
    result["ocsort_oru_replay_ms_per_step"] = sum(
        ms for key, (_, ms) in prof["by_kernel"].items() if "oru_kernel" in key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch_replay(cfg, s16, batch[:, 80:96])
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 16
    result["ocsort_host_ms_per_step"] = host_ms
    result["ocsort_idle_share"] = 1.0 - prof["busy_ms_per_step"] / host_ms
    return result


def _hybridsort_k4(cs, measure, cfg) -> dict:
    """Step 8's kernel times: K4's XYSCR instance on a recorded HybridSORT
    bench step and on the all-rejoin XYSCR set."""
    from boxmot_tpu_torch.engine.replay import batch_replay, init_states
    from boxmot_tpu_torch.trackers import hybridsort

    batch, embs, warps = cs.appearance_batch(cs.N_SEQS, 65, cs.N_DETS, 100, cs.MISS, "cuda")
    states, _, _ = batch_replay(cfg, init_states(cfg, cs.N_SEQS, "cuda"), batch[:, :64], None,
                                embs[:, :64], warps[:, :64])
    with measure.record_calls(hybridsort, ["oru_replay"]) as rec:
        batch_replay(cfg, states, batch[:, 64:], None, embs[:, 64:], warps[:, 64:])
    sets = {"hybridsort_step": rec["oru_replay"][0][0]}
    layout, tensors, rejoin, gap = cs.oru_inputs(np.random.default_rng(2), cs.N_SEQS, cs.CAPACITY,
                                                 "xyscr")
    replayed = torch.zeros(cs.N_SEQS, dtype=torch.int32)
    sets["all_rejoin_xyscr"] = [layout, *(t.cuda() for t in (*tensors, rejoin, gap, replayed))]
    result = {}
    for label, args in sets.items():
        result[f"oru_{label}_device_ms_per_launch"] = measure.device_ms_per_call(
            lambda: hybridsort.oru_replay(*args), "oru_")
        result[f"oru_{label}_slots_rejoining"] = int(args[7].sum())
        result[f"oru_{label}_longest_gap"] = int(torch.where(args[7], args[8], 0).max())
    return result


def _appearance(cs, measure, label, cfg, miss=0.0) -> dict:
    """Steps 6-8: an appearance tracker's AABB step profile and bench
    frames/s at ``cfg``, on ``appearance_batch``'s inputs with ``miss`` of
    the detections missed, with the checkout's port (``main`` has put it
    first on the path); keys start with ``label``."""
    from boxmot_tpu_torch.engine.replay import batch_replay, init_states

    batch, embs, warps = cs.appearance_batch(cs.N_SEQS, cs.N_FRAMES, cs.N_DETS, 0, miss, "cuda")
    st, _, _ = batch_replay(cfg, init_states(cfg, cs.N_SEQS, "cuda"), batch[:, :64], None,
                            embs[:, :64], warps[:, :64])
    prof = measure.profile_steps(
        lambda: batch_replay(cfg, st, batch[:, 64:80], None, embs[:, 64:80], warps[:, 64:80]), 16)
    result = {f"{label}_kernels_per_step": prof["kernels_per_step"],
              f"{label}_busy_ms_per_step": prof["busy_ms_per_step"],
              f"{label}_profile_traces": prof["traces"]}
    for key, pick in (("k1", "iou_cost_kernel"), ("k2", "auction_kernel"), ("k4", "oru_kernel"),
                      ("bmm", "gemm")):
        result[f"{label}_{key}_ms_per_step"] = sum(
            ms for name, (_, ms) in prof["by_kernel"].items() if pick in name.lower())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch_replay(cfg, st, batch[:, 80:96], None, embs[:, 80:96], warps[:, 80:96])
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 16
    result[f"{label}_host_ms_per_step"] = host_ms
    result[f"{label}_idle_share"] = 1.0 - prof["busy_ms_per_step"] / host_ms
    ms = []
    for i in range(4):
        s0 = init_states(cfg, cs.N_SEQS, "cuda")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        batch_replay(cfg, s0, batch, None, embs, warps)
        end.record()
        end.synchronize()
        if i:
            ms.append(start.elapsed_time(end))
    result[f"{label}_replay_fps"] = cs.N_SEQS * cs.N_FRAMES / (statistics.median(ms) / 1e3)
    return result


if __name__ == "__main__":
    sys.exit(main())
