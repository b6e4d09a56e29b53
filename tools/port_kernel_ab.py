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
   inputs (torch.profiler), and K3 at 4096 x 4096;
3. profiles 16 bench steps of each: kernels and device busy ms per step,
   the auction's and rotated IoU's device ms per step, and host ms per step
   without the profiler;
4. times the full bench replay (frames/s, the median of 3 launches after a
   warm-up), as chip_smoke.py's bench lines do.

It prints one JSON object and appends it to chiprun_out/port_kernel_ab.jsonl.
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from boxmot_tpu_torch.csrc import build
    from boxmot_tpu_torch.engine.replay import batch_replay, init_states, pack_frames
    from boxmot_tpu_torch.ops.geometry import obb_corners
    from boxmot_tpu_torch.ops.rotated_iou import rotated_iou
    from boxmot_tpu_torch.trackers import bytetrack
    from boxmot_tpu_torch.trackers.bytetrack import ByteTrackConfig

    import boxmot_tpu_torch
    if Path(boxmot_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {boxmot_tpu_torch.__file__}, not the package under {root}")
    measure = _load_measure()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        list(pool.map(build.build, ("iou_cost", "auction", "rotated_iou")))

    result = {"label": args.label or str(root), "card": smi}
    paths = {
        "aabb": (ByteTrackConfig(capacity=cs.CAPACITY), cs.synthetic_frames, 6),
        "obb": (ByteTrackConfig(capacity=cs.CAPACITY, is_obb=True),
                lambda n, d, seed: cs.synthetic_obb_frames(n, d, seed=seed, miss=0.0), 7),
    }
    kernels = {"fused_iou_cost": "iou_cost_kernel", "masked_assignment": "auction_kernel",
               "rotated_iou": "rotated_iou_kernel"}
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
                times.append(measure.device_ms(lambda: getattr(bytetrack, name)(*a, **kw),
                                               kernels[name]))
            result[f"{label}_{name}_device_ms_per_launch"] = times

        # 16 steps under the profiler, and without it on the host clock
        s16, _, _ = batch_replay(cfg, init_states(cfg, cs.N_SEQS, "cuda"), batch[:, :64])
        prof = measure.profile_steps(lambda: batch_replay(cfg, s16, batch[:, 64:80]), 16)
        result[f"{label}_kernels_per_step"] = prof["kernels_per_step"]
        result[f"{label}_busy_ms_per_step"] = prof["busy_ms_per_step"]
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

    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(cs._obbs(rng, 1, 4096)).cuda() for _ in range(2))
    c1, c2 = (obb_corners(x).contiguous() for x in (a, b))
    result["rotated_iou_4096_device_ms"] = measure.device_ms(
        lambda: rotated_iou(a, b, c1, c2), "rotated_iou_kernel", reps=5, warmup=2)
    line = json.dumps(result)
    print(line)
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "port_kernel_ab.jsonl", "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
