#!/usr/bin/env python3
"""Probe why ``torch.profiler`` traces lose launches of the port's kernels.

    python3 tools/trace_gap_probe.py [--seconds 150] [--aging small|big|phase8]
        [--variants static,measure,...] [--out FILE]

On one CUDA card, kernel K6 (``csrc/nms.cu``, launched through ctypes) is
traced at the yololite shape (256 boxes, max_out 64) in rounds while the
process ages: between rounds it runs profiled PyTorch work (a small conv
net, many short traces), as ``chip_smoke.py``'s phases 4-8 do.  Each round
traces 20 calls in each of these variants and counts the ``nms_*`` device
events the trace holds:

* ``static``: the port's library (nvcc's default, a static CUDA runtime);
* ``shared``: the same source built with ``-cudart shared``, so that its
  launches go through the CUDA runtime that PyTorch loaded;
* ``static_tail``: as ``static``, with 5 ms of host sleep after the
  synchronize, before the trace stops;
* ``static_head``: as ``static``, with 5 ms of sleep before the first call;
* ``static_mixed``: as ``static``, with a PyTorch kernel before and after;
* ``torch``: 20 PyTorch elementwise kernels (their device events counted);
* ``measure``: K6's calls through ``boxmot_tpu_torch/utils/measure.py``'s
  own trace (``_traced``), as ``chip_smoke.py`` takes them.

``--variants`` picks some of them (all by default).

Each variant's line gives the events held, and the offsets (µs) of the
first and last held device event and of the last host event from the
trace's start.  One JSON line a round goes to standard output, and to
``--out`` where given.

``--aging`` picks what runs between rounds: ``small`` (the default, short
traces of a conv net), ``big`` (one trace of 40,000 elementwise kernels a
round, as large as a 16-frame profile of the fused live step), or
``phase8`` (before the first round only: ``chip_smoke.py``'s phase 8, the
detector and the fused live step with its profiles, after its phase 2,
with its CPU reference in a worker process).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from boxmot_tpu_torch.csrc import build  # noqa: E402
from boxmot_tpu_torch.ops.nms import nms  # noqa: E402
from boxmot_tpu_torch.utils import measure  # noqa: E402

CALLS = 20
_P, _I = ctypes.c_void_p, ctypes.c_int


def shared_runtime_nms():
    """``bmt_nms`` of csrc/nms.cu built with ``-cudart shared``."""
    out = build.BUILD_DIR / "probe" / "nms_cudart_shared.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-cudart", "shared", "-o", str(out),
           str(build.CSRC / "nms.cu")]
    subprocess.run(cmd, check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).bmt_nms
    fn.argtypes = [_P, _P, _I, ctypes.c_float, _I, _P, _P, _P, _P]
    fn.restype = _I
    return fn


def inputs(seed=0, n=256):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 240, (n, 2)).astype(np.float32)
    wh = rng.uniform(4, 60, (n, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], 1)).cuda()
    scores = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).cuda()
    return boxes, scores


def traced(body):
    """(held nms_* events, held elementwise events, first / last device event
    and last host event in µs from the trace's start) of one trace."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        body()
        torch.cuda.synchronize()
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, n_nms, n_elem = [], [], 0, 0
    for evt in res.events():
        if evt.device_type() == cuda:
            if evt.duration_ns() <= 0:
                continue
            dev.append(evt.start_ns() - t0)
            n_nms += "nms_" in evt.name()
            n_elem += "elementwise" in evt.name()
        else:
            host.append(evt.start_ns() + evt.duration_ns() - t0)
    us = lambda v, f: round(f(v) / 1e3, 1) if v else None  # noqa: E731
    return {"nms": n_nms, "elementwise": n_elem, "first_dev_us": us(dev, min),
            "last_dev_us": us(dev, max), "last_host_us": us(host, max)}


def round_line(label, age_s, boxes, scores, shared_fn, names):
    keep = torch.empty(64, dtype=torch.int32, device="cuda")
    mask = torch.empty(64, dtype=torch.bool, device="cuda")
    x = torch.ones(1024, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def static(n=CALLS):
        for _ in range(n):
            nms(boxes, scores, 0.7, 64)

    def shared():
        for _ in range(CALLS):
            rc = shared_fn(boxes.data_ptr(), scores.data_ptr(), boxes.shape[0], 0.7, 64,
                           keep.data_ptr(), mask.data_ptr(), None, stream)
            assert rc == 0, rc

    def tail():
        static()
        torch.cuda.synchronize()
        time.sleep(0.005)

    def head():
        time.sleep(0.005)
        static()

    def mixed():
        x.add_(1)
        static()
        x.add_(1)

    def elementwise():
        for _ in range(CALLS):
            x.add_(1)

    variants = {"static": static, "shared": shared, "static_tail": tail, "static_head": head,
                "static_mixed": mixed, "torch": elementwise}
    line = {"round": label, "age_s": round(age_s, 1)}
    for name in names:
        if name == "measure":
            table = measure._traced(lambda: nms(boxes, scores, 0.7, 64), CALLS)
            line[name] = {"nms": sum(n for k, (n, _) in table.items() if "nms_" in k)}
            continue
        variants[name]()
        torch.cuda.synchronize()
        line[name] = traced(variants[name])
    return line


def age(seconds):
    """Profiled PyTorch work for about ``seconds``: short traces of a small
    conv net, as a long run of step profiles makes."""
    net = torch.nn.Sequential(*[torch.nn.Conv2d(16, 16, 3, padding=1) for _ in range(8)]).cuda()
    x = torch.randn(8, 16, 64, 64, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    end, traces = time.perf_counter() + seconds, 0
    with torch.no_grad():
        while time.perf_counter() < end:
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(4):
                    net(x)
                torch.cuda.synchronize()
            sum(1 for _ in prof.profiler.kineto_results.events())
            traces += 1
    return traces


def age_big(rounds=1):
    """One trace of 40,000 elementwise kernels a round."""
    x = torch.ones(1024, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(rounds):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(40_000):
                x.add_(1)
            torch.cuda.synchronize()
        sum(1 for _ in prof.profiler.kineto_results.events())
    return rounds


def run_phase8():
    """chip_smoke.py's phases 2 and 8, as the smoke runs them."""
    import concurrent.futures  # noqa: PLC0415
    import multiprocessing  # noqa: PLC0415
    import tempfile  # noqa: PLC0415

    import chip_smoke as cs  # noqa: PLC0415

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool, \
            tempfile.TemporaryDirectory() as tmp:
        cs.build_kernels()
        seqs = cs.mot17_frames()
        ckpt = cs.yolox_checkpoint(Path(tmp), "yolox_x", seqs["MOT17-04-FRCNN"][:2], cs.DET_IMGSZ,
                                   device="cuda")
        heads = pool.submit(cs.cpu_job, "yolox", None, (str(ckpt), seqs["MOT17-04-FRCNN"][:1]))
        cs.run_detector_phase(smi, ckpt, seqs, heads)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=150.0)
    ap.add_argument("--out", help="also write the lines to this file")
    ap.add_argument("--aging", choices=("small", "big", "phase8"), default="small")
    ap.add_argument("--variants", default="static,shared,static_tail,static_head,static_mixed,"
                    "torch,measure")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_gap_probe: no CUDA card", file=sys.stderr)
        return 1
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": torch.cuda.get_device_name(0)}))
    build.build("nms")
    shared_fn = shared_runtime_nms()
    boxes, scores = inputs()
    if args.aging == "phase8":
        run_phase8()
    start = time.perf_counter()
    lines = []
    n_traces, rnd = 0, 0
    while True:
        line = round_line(rnd, time.perf_counter() - start, boxes, scores, shared_fn,
                          args.variants.split(","))
        line["aging"] = args.aging
        line["aging_traces_so_far"] = n_traces
        lines.append(json.dumps(line))
        print(lines[-1], flush=True)
        if time.perf_counter() - start >= args.seconds:
            break
        if args.aging == "small":
            n_traces += age(min(15.0, args.seconds / 8))
        elif args.aging == "big":
            n_traces += age_big()
        else:
            time.sleep(min(15.0, args.seconds / 8))
        rnd += 1
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
