"""Driver of a live cell: a camera stream through
``boxmot_tpu_torch.engine.fused.FusedLiveTracker`` in a closed loop.

Set-up makes the frame pool and the weights from the seed (on the card,
by the benchmark's own models), builds the port's detector, ReID and fused
tracker, hands them the weights, and runs ``warmup_frames`` frames (every
kernel built and loaded, cuDNN's plans made) before resetting the tracker.
The window sends the pool's frames in order, each when the last one's rows
are on the host, until ``--seconds`` have passed: ``live_fps`` is every
frame over the window, ``live_frame_ms_p95`` the 95th percentile of the
frames' times from ``update`` called to its rows returned.  The frames in
which an assignment stopped at the auction's iteration cap (the tracker
state's ``lap_capped``) are counted for ``live.capped_pct``; their rows are
held, as every frame's, against the reference, which answers a capped
problem with the exact matching.

What the timed path produced is kept: each frame's detection rows and
embeddings (the tensors ``frame_inputs`` returns, held on the card) and its
emitted rows.  After the window the reference works out each pool frame's
detections and embeddings and the tracks of the first
``track_check_frames`` frames (two cycles of the pool), and ``compare``
holds them against the program's (``check``).  With ``--trace 1`` a slice
of ``trace_frames`` frames runs under the profiler, with ranges around the
detector, ReID, the letterbox and the step; the profiler slows the slice,
so the shares of the untraced frames' time are taken with the untraced
frames' mean time.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import compare, flops, gen, trace, work
from portbench.reference import live as ref
from portbench.reference import models

TRACE_START = 8  # the traced slice starts at this frame of the window
TRACE_TRIES = 3


class Run:
    def __init__(self, cell, seed: int, device, trace: bool = False):
        self.cell, self.seed, self.device, self.trace = cell, seed, device, trace
        self.cfg, self.traffic = cell.config, cell.traffic
        self.attempted = self.failed = 0
        self.summary = None

    def setup(self):
        from boxmot_tpu_torch.detectors.registry import YoloXDetector
        from boxmot_tpu_torch.engine.fused import FusedLiveTracker
        from boxmot_tpu_torch.reid.core import ReID

        cfg, dev = self.cfg, self.device
        self.frames = gen.make(self.traffic, self.seed)
        self.det_sd, self.reid_sd = ref.make_weights(cfg, self.frames,
                                                     self.traffic["params"]["players"],
                                                     self.seed, dev)
        d, r = cfg["detector"], cfg["reid"]
        det = YoloXDetector(d["name"], device=dev, imgsz=tuple(d["imgsz"]), conf=d["conf"],
                            iou=d["iou"], num_classes=d["num_classes"])
        det.model.load_state_dict(self.det_sd)
        reid = ReID(None, device=dev, model_name=r["name"], crop_hw=tuple(r["crop_hw"]))
        reid.model.load_state_dict(self.reid_sd)
        self.fused = FusedLiveTracker(det, reid, cfg["tracker"]["name"],
                                      cfg["tracker"]["params"], max_dets=cfg["max_dets"])
        self.spans = trace.Spans()
        if self.trace:
            self.spans.wrap(det, "detect", "detector.detect")
            self.spans.wrap(det, "preprocess_u8", "detector.preprocess_u8")
            self.spans.wrap(reid, "_embed", "reid._embed")
            self.spans.wrap(self.fused, "_step", "tracker._step")
        self.inputs = []
        inner = self.fused.frame_inputs

        def kept(frame_u8, r):
            out = inner(frame_u8, r)
            self.inputs.append(out)
            return out

        self.fused.frame_inputs = kept
        for frame in self.frames[: self.traffic["warmup_frames"]]:
            self.fused.update(frame)
        self.fused.reset()
        self.inputs.clear()

    def _frame(self, i: int):
        t0 = time.perf_counter()
        rows = self.fused.update(self.frames[i % len(self.frames)])
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.rows.append(np.asarray(rows, np.float32).copy())
        self.capped.append(self.fused._state.lap_capped)  # read after the window

    def window(self, seconds: float):
        self.ms, self.rows, self.capped, traced = [], [], [], set()
        n_traced, tries = self.traffic["trace_frames"], 0
        t0 = time.perf_counter()
        i = 0
        while True:
            if self.trace and self.summary is None and i >= TRACE_START and tries < TRACE_TRIES:
                tries += 1
                cut = trace.Slice()
                cut.start()
                for j in range(i, i + n_traced):
                    self._frame(j)
                summary = cut.stop(self.spans.names, n_traced)
                if summary.agreed or tries == TRACE_TRIES:
                    self.summary, summary.first = summary, i
                traced.update(range(i, i + n_traced))
                i += n_traced
            else:
                self._frame(i)
                i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        self.attempted = len(self.rows)
        capped = [0] + [int(c.sum()) for c in self.capped]
        # frames in which one of the assignments stopped at the auction's iteration cap
        self.capped_frames = sum(b > a for a, b in zip(capped, capped[1:]))
        self.spans.close()
        if self.summary is not None:
            self.summary.work["capped_frames"] = self.capped_frames
            self.summary.work["frames"] = self.attempted
            untraced = [ms for j, ms in enumerate(self.ms) if j not in traced]
            self.summary.work["unit_s"] = (float(np.mean(untraced)) / 1e3 if untraced
                                           else self.summary.window_s / self.summary.units)

    def end_to_end(self) -> dict:
        return {"live_fps": len(self.rows) / self.window_s,
                "live_frame_ms_p95": float(np.percentile(self.ms, 95))}

    def info(self) -> dict:
        """What the window did, for the log: frames, those with a capped
        auction, detections kept and rows emitted a frame, and the frames
        of the track check that emitted rows."""
        T = min(self.traffic["track_check_frames"], len(self.rows))
        return {"frames": len(self.rows), "capped_frames": self.capped_frames,
                "kept_per_frame": float(np.mean([int(v.sum()) for _, v, _ in self.inputs])),
                "rows_per_frame": float(np.mean([len(r) for r in self.rows])),
                "checked_frames_with_rows": sum(len(r) > 0 for r in self.rows[:T])}

    def release(self):
        """Free the program's models and state, the kept outputs aside."""
        self.fused = None
        gc.collect()
        torch.cuda.empty_cache()

    def reference_inputs(self, n_pool: int, tf32: bool = False):
        """The reference's (dets, valid, embs) and work of the first
        ``n_pool`` pool frames, with TF32 on where ``tf32`` (the control)."""
        with models.tf32(tf32):
            model = ref.LiveReference(self.cfg, self.det_sd, self.reid_sd, self.device)
            out = [model.frame_inputs(f) for f in self.frames[:n_pool]]
        return out

    def check(self) -> dict:
        """Two stages, each against the reference from the same inputs: the
        detections and embeddings of every window frame against the
        reference's from the frame; the emitted rows of the first
        ``track_check_frames`` frames against the reference tracker's from
        the program's own detections and embeddings.  The tracker decides by
        thresholds and maxima, so rounding in its inputs (the embeddings of
        the program and the reference differ in the last bits) would change
        its decisions; fed the same inputs it must give the same rows."""
        P = len(self.frames)
        refs = self.reference_inputs(min(P, len(self.inputs)))
        want = [refs[i % P][:3] for i in range(len(self.inputs))]
        numbers = compare.live_detections(self.inputs, want)
        T = min(self.traffic["track_check_frames"], len(self.rows))
        tracks = ref.track(self.cfg, self.inputs[:T], self.device)
        numbers.update(compare.live_tracks(self.rows[:T], tracks))
        if self.summary is not None:
            self._count_work(refs)
        return numbers

    def control(self, n_frames: int) -> dict:
        """The check's numbers with the reference in TF32 in the program's
        place (``tf32``: the precision below the configuration's for its
        convolutions and products), over ``n_frames`` window frames (after
        ``setup``)."""
        self.release()
        P = len(self.frames)
        got, want = (self.reference_inputs(min(P, n_frames), tf32) for tf32 in (True, False))
        got = [got[i % P][:3] for i in range(n_frames)]
        want = [want[i % P][:3] for i in range(n_frames)]
        numbers = compare.live_detections(got, want)
        T = min(self.traffic["track_check_frames"], n_frames)
        with models.tf32(True):
            tracks_tf32 = ref.track(self.cfg, got[:T], self.device)
        numbers.update(compare.live_tracks(tracks_tf32, ref.track(self.cfg, got[:T], self.device)))
        return {"tf32": numbers}

    def _count_work(self, refs):
        """The benchmark's counts for the traced frames: K6's and K5's least
        times from the reference's NMS and crop boxes, and the model FLOPs a
        frame."""
        s, P = self.summary, len(self.frames)
        traced = [refs[j % P][3] for j in range(s.first, s.first + s.units)]
        D = int(self.cfg["max_dets"])
        s.work["k6_bound_ms"] = sum(work.k6_bound(n, D, e, k)[0]
                                    for n, e, k in (w["k6"] for w in traced))
        s.work["k5_bound_ms"] = sum(work.k5_bound(hw, boxes, tuple(self.cfg["reid"]["crop_hw"]))[0]
                                    for hw, boxes in (w["k5"] for w in traced))
        s.work["model_flops_per_frame"] = model_flops(self.cfg)


def model_flops(cfg: dict) -> int:
    """YOLOX's FLOPs at the cell's input and the ReID model's on ``max_dets``
    crops, from the layer shapes of the benchmark's copies."""
    d, r = cfg["detector"], cfg["reid"]
    with torch.device("meta"):
        yolox = models.build_yolox(d["name"], num_classes=d["num_classes"])
        osnet = models.build_osnet(r["name"])
    return (flops.conv_linear_flops(yolox, (1, 3, *d["imgsz"]))
            + flops.conv_linear_flops(osnet, (cfg["max_dets"], 3, *r["crop_hw"])))

