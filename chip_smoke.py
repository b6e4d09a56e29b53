#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (boxmot_tpu_torch) once on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device report: torch's card name and nvidia-smi's name and power limit;
  2. build both hand-written kernels from csrc/ with nvcc;
  3. each kernel against its plain PyTorch twin on the card, at the main
     path's shapes and at ragged / tie-heavy / masked ones, and the median
     time of each (CUDA events);
  4. the slice: run_eval on MOT17-mini and synth-long on the card, with the
     frame loop under torch.cuda.set_sync_debug_mode("error"), held to the
     pinned HOTA/MOTA/IDF1; the kernels' launch counters must rise; the
     MOT rows it writes are held against those of run_eval on the CPU;
  5. the live API over the first 50 frames of MOT17-04-FRCNN, against the
     same tracker on the CPU;
  6. replay throughput at the bench shape (8 sequences x 256 frames x 100
     detections, D = 128, capacity 256), timed with CUDA events.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA card it exits non-zero
before printing any result.
"""

from __future__ import annotations

import configparser
import json
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
from boxmot_tpu_torch.engine.replay import batch_replay, init_states, pack_frames
from boxmot_tpu_torch.ops.fused_iou_cost import fused_iou_cost, fused_iou_cost_plain
from boxmot_tpu_torch.ops.lap import masked_assignment, masked_assignment_plain
from boxmot_tpu_torch.trackers.bytetrack import ByteTrackConfig

ROOT = Path(__file__).resolve().parent
ASSETS = ROOT / "assets"
ROOTS = {"mot17_mini": ASSETS / "MOT17-mini" / "train", "synth_long": ASSETS / "synth-long" / "train"}
LIVE_SEQ = ROOTS["mot17_mini"] / "MOT17-04-FRCNN"
# the ByteTrack pins of tests/test_pinned_metrics.py (a CPU test holds them equal)
PINNED = {
    ("mot17_mini", "bytetrack"): {"HOTA": 0.649859, "MOTA": 0.495283, "IDF1": 0.662461},
    ("synth_long", "bytetrack"): {"HOTA": 0.952785, "MOTA": 0.996300, "IDF1": 0.968698},
}
ATOL = 1e-4
K1_ATOL = 1e-6
# bench shape (bench.py): sequences x frames x detections, det bucket, capacity
N_SEQS, N_FRAMES, N_DETS, D_BENCH, CAPACITY = 8, 256, 100, 128, 256


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


def cuda_ms(fn, reps=50, warmup=5):
    """Median milliseconds of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _boxes(rng, S, n):
    """Track/detection-like xyxy boxes with the step's edge cases mixed in."""
    b = np.zeros((S, n, 4), np.float32)
    b[..., :2] = rng.uniform(0, 1800, (S, n, 2))
    b[..., 2:] = b[..., :2] + rng.uniform(5, 200, (S, n, 2))
    b[:, 0::9] = 0.0  # empty slot
    b[:, 1::9] = [0.0, 0.0, 1.0, 1.0]  # padding detection
    b[:, 2::9, 2] = b[:, 2::9, 0]  # zero width
    return b


def check_k1(rng):
    worst = 0.0
    for S, K, D in ((8, 256, 128), (1, 1, 3), (2, 200, 77)):
        trk = _boxes(rng, S, K)
        det = _boxes(rng, S, D)
        det[:, : D // 2] = trk[:, :1] + rng.uniform(-30, 30, (S, D // 2, 4))
        conf = rng.uniform(0.05, 1.0, (S, D)).astype(np.float32)
        args = [torch.from_numpy(a).cuda() for a in (trk, det, conf)]
        iou, cost = fused_iou_cost(*args)
        ref_iou, ref_cost = fused_iou_cost_plain(*args)
        torch.cuda.synchronize()
        err = max(float((iou - ref_iou).abs().max()), float((cost - ref_cost).abs().max()))
        if not err <= K1_ATOL:
            raise AssertionError(f"K1 at S={S} K={K} D={D}: max abs err {err} > {K1_ATOL}")
        worst = max(worst, err)
        print(f"K1 S={S} K={K} D={D}: max abs err {err:.3g}, bit-equal "
              f"{torch.equal(iou, ref_iou) and torch.equal(cost, ref_cost)}")
    # time at the bench shape: S = 8 sequences, K = 256 slots, D = 128
    main = [torch.from_numpy(a).cuda() for a in
            (_boxes(rng, 8, 256), _boxes(rng, 8, 128), rng.uniform(0.05, 1, (8, 128)).astype(np.float32))]
    ms = cuda_ms(lambda: fused_iou_cost(*main))
    plain_ms = cuda_ms(lambda: fused_iou_cost_plain(*main))
    return worst, ms, plain_ms


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
        row_mask[:4] = False  # all-masked problems
        col_mask[4:, 1:] = False  # single-column problems
    return [torch.from_numpy(a).cuda() for a in (cost.astype(np.float32), row_mask, col_mask)]


def check_k2(rng):
    worst = 0
    for kind in ("dense", "ties", "masked", "iou-like"):
        cost, rm, cm = _problem(rng, kind)
        caps = [torch.zeros(8, dtype=torch.int32, device="cuda") for _ in range(2)]
        got = masked_assignment(cost, rm, cm, 0.8, caps[0])
        want = masked_assignment_plain(cost, rm, cm, 0.8, caps[1])
        torch.cuda.synchronize()
        worst = max(worst, int((got - want).abs().max()))
        if not (torch.equal(got, want) and torch.equal(caps[0], caps[1])):
            bad = int((got != want).sum())
            raise AssertionError(f"K2 {kind}: r2c differs from the twin in {bad} rows")
        print(f"K2 S=8 256x128 {kind}: r2c identical, {int((got >= 0).sum())} matches, "
              f"capped {caps[0].tolist()}")
    cost, rm, cm = _problem(rng, "iou-like")
    cap = torch.zeros(8, dtype=torch.int32, device="cuda")
    ms = cuda_ms(lambda: masked_assignment(cost, rm, cm, 0.8, cap))
    plain_ms = cuda_ms(lambda: masked_assignment_plain(cost, rm, cm, 0.8, cap), reps=10, warmup=1)
    return float(worst), ms, plain_ms


def _mot_rows(out_dir: Path) -> dict:
    """{sequence: MOT rows} of the files run_eval wrote to ``out_dir``."""
    return {p.stem: np.loadtxt(p, delimiter=",", ndmin=2) for p in sorted(out_dir.glob("*.txt"))}


def run_slice():
    """Phase 4.  Returns {kernel: launches} of the slice's run."""
    # the check is live: a host sync under "error" mode raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.zeros(1, device="cuda").item()
    except RuntimeError:
        pass
    else:
        raise AssertionError("set_sync_debug_mode('error') let a host sync through")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        fused_iou_cost.launches = 0
        masked_assignment.launches = 0
        for name, root in ROOTS.items():
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                res = boxmot_tpu_torch.run_eval(root, "bytetrack", device="cuda",
                                                output_dir=out / "cuda" / name)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            seconds = time.perf_counter() - t0
            got = {k: float(res["combined"][k]) for k in ("HOTA", "MOTA", "IDF1")}
            want = PINNED[(name, "bytetrack")]
            print(f"eval {name} on cuda: {got} in {seconds:.3f} s (pins {want})")
            for k, v in want.items():
                if not abs(got[k] - v) <= ATOL:
                    raise AssertionError(f"{name} {k} = {got[k]} misses the pin {v} (atol {ATOL})")
        launches = {"fused_iou_cost": fused_iou_cost.launches,
                    "masked_assignment": masked_assignment.launches}
        print(f"launches in the slice's run: {launches}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel of the path never launched: {launches}")
        # every step launches K1 twice and K2 three times: no step took a twin
        if 2 * launches["masked_assignment"] != 3 * launches["fused_iou_cost"]:
            raise AssertionError(f"launch counts are not 2 K1 : 3 K2 per step: {launches}")

        # the card's MOT rows against the same eval on the CPU
        for name, root in ROOTS.items():
            boxmot_tpu_torch.run_eval(root, "bytetrack", device="cpu", output_dir=out / "cpu" / name)
            gpu, cpu = _mot_rows(out / "cuda" / name), _mot_rows(out / "cpu" / name)
            if gpu.keys() != cpu.keys() or not gpu:
                raise AssertionError(f"{name}: cuda wrote {sorted(gpu)}, cpu wrote {sorted(cpu)}")
            for seq, g in gpu.items():
                c = cpu[seq]
                keys = [0, 1, 6, 7, 8]  # frame, id, conf, cls, det_ind
                if g.shape != c.shape or not np.array_equal(g[:, keys], c[:, keys]):
                    raise AssertionError(f"{seq}: MOT rows differ between cuda and cpu")
                box = float(np.abs(g[:, 2:6] - c[:, 2:6]).max(initial=0.0))
                if not (np.isfinite(g).all() and box <= 1.0):  # boxes are whole pixels
                    raise AssertionError(f"{seq}: MOT boxes differ by {box} px between cuda and cpu")
                print(f"{seq} rows cuda vs cpu: {len(g)} rows, all equal: {np.array_equal(g, c)}")
    return launches


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


def run_live():
    """Phase 5: live update on cuda against the same tracker on the cpu."""
    frames, img = _live_frames(50)
    trackers = {d: boxmot_tpu_torch.create_tracker("bytetrack", device=d) for d in ("cuda", "cpu")}
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
    print(f"live API, 50 frames of {LIVE_SEQ.name}: {n_rows} rows equal to cpu "
          f"(ids, det_ind, cls, conf exact; max box diff {worst:.3g} px); cuda update "
          f"median {statistics.median(update_ms[1:]):.3f} ms/frame (host clock, frames 2-50)")


def run_throughput(card):
    """Phase 6: frames/s at the bench shape; a distinct seeded input per launch."""
    cfg = ByteTrackConfig(capacity=CAPACITY)
    batches = []
    for v in range(6):
        packed = [pack_frames(synthetic_frames(N_FRAMES, N_DETS, seed=v * N_SEQS + s),
                              D=D_BENCH, F=N_FRAMES)[0] for s in range(N_SEQS)]
        batches.append(torch.from_numpy(np.stack(packed)).cuda())
    ms, capped = [], 0
    for i, b in enumerate(batches):  # the first launch is the warm-up
        states = init_states(cfg, N_SEQS, "cuda")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        states, outs, masks = batch_replay(cfg, states, b)
        end.record()
        end.synchronize()
        if not torch.isfinite(outs[masks]).all():
            raise AssertionError("bench replay: non-finite output")
        capped += int(states.lap_capped.sum())
        if i:
            ms.append(start.elapsed_time(end))
    fps = N_SEQS * N_FRAMES / (statistics.median(ms) / 1e3)
    line = {"metric": f"bytetrack_replay_fps_{N_DETS}dets", "value": fps, "unit": "frames/s",
            "shape": [N_SEQS, N_FRAMES, N_DETS, D_BENCH, CAPACITY], "launch_ms": ms,
            "lap_capped": capped, "card": card}
    print(json.dumps(line))
    return fps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {kind}")
    print(f"nvidia-smi: {smi}")

    for name in ("iou_cost", "auction"):
        t0 = time.perf_counter()
        path = build.build(name)
        seconds, log = build.BUILD_LOG.get(name, (time.perf_counter() - t0, "(prebuilt)\n"))
        print(f"built {path.name} in {seconds:.1f} s\n{log.strip()}")

    rng = np.random.default_rng(0)
    k1 = check_k1(rng)
    k2 = check_k2(rng)
    launches = run_slice()
    run_live()
    run_throughput(smi)

    print(f"nvidia-smi: {smi}")
    kernels = [
        {"name": "fused_iou_cost", "route": "cuda", "source": "boxmot_tpu_torch/csrc/iou_cost.cu",
         "replaces": "boxmot_tpu/ops/pallas_kernels.py:59", "launches": launches["fused_iou_cost"],
         "max_abs_err": k1[0], "ms": k1[1], "plain_ms": k1[2]},
        {"name": "masked_assignment", "route": "cuda", "source": "boxmot_tpu_torch/csrc/auction.cu",
         "replaces": "boxmot_tpu/ops/lap.py:37", "launches": launches["masked_assignment"],
         "max_abs_err": k2[0], "ms": k2[1], "plain_ms": k2[2]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
