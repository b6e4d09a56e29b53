"""Driver of a replay cell: an offline eval's sequences through
``boxmot_tpu_torch.engine.replay.replay_sequences_outputs``, all of them in
one call, as ``run_eval`` replays a split.

Set-up makes the sequences from the seed (host arrays, as an eval reads
them from its caches), builds the tracker's config and makes
``warmup_calls`` whole calls (every kernel built and loaded, the caching
allocator's blocks made).  The window starts calls until ``--seconds`` have
passed and ends when the last one returns: ``replay_fps`` is the frames of
every sequence of every call that returned, over the window.  A call that
raises on the auction's iteration cap counts as failed.

Every call's results are kept, and the appearance products (``torch.bmm``)
of ``product_steps`` steps of the window's first call, drawn from the seed
(``products.py``); after the window the reference replays the same
sequences once, keeping its products in the same steps, and ``compare``
holds every call's rows and those products against it.  With
``--trace 1`` a slice of ``trace_steps`` steps of the first call runs under
the profiler, with a range around each step; the profiler slows it, so the
shares of a step's time are taken with the untraced calls' time a step.
"""

from __future__ import annotations

import gc
import time

import torch

from portbench import compare, gen, products, trace, work
from portbench.reference import models
from portbench.reference import replay as ref

TRACE_TRIES = 3


class Run:
    def __init__(self, cell, seed: int, device, trace: bool = False):
        self.cell, self.seed, self.device, self.trace = cell, seed, device, trace
        self.cfg, self.traffic = cell.config, cell.traffic
        self.attempted = self.failed = 0
        self.summary = None

    def setup(self):
        from boxmot_tpu_torch.engine import replay
        from boxmot_tpu_torch.engine.eval import build_replay_config

        self.replay = replay
        tcfg = self.cfg["tracker"]
        self.tracker_cfg = build_replay_config(tcfg["name"], **tcfg["params"])
        self.seqs = gen.make(self.traffic, self.seed)
        self.frames_per_call = sum(len(s["dets"]) for s in self.seqs)
        self.spans = trace.Spans()
        step_module = __import__(f"boxmot_tpu_torch.trackers.{tcfg['name']}", fromlist=["_"])
        attr = f"{tcfg['name']}_step"
        if self.trace:
            self.spans.wrap(step_module, attr, "tracker.step")
        for _ in range(self.traffic["warmup_calls"]):
            self._call()
        self.results, self.call_s = [], []
        if self.trace:
            self._slice_steps(step_module, attr)
        # the products of sampled steps of the window's first call
        self.steps = products.sample_steps(self.seed, max(len(s["dets"]) for s in self.seqs),
                                           self.traffic["product_steps"])
        self.products = {}
        self.spans.wrap_with(step_module, attr, products.recording(
            getattr(step_module, attr), self.steps, self.products))

    def _slice_steps(self, module, attr: str):
        """Trace ``trace_steps`` steps of the window's first call from its
        step ``trace_first_step`` on (again on the next steps, at most
        ``TRACE_TRIES`` times, where the trace lost launches)."""
        inner = getattr(module, attr)
        first, n = self.traffic["trace_first_step"], self.traffic["trace_steps"]
        seen = {"i": 0, "tries": 0, "start": first}
        cut = trace.Slice()

        def step(*args, **kwargs):
            i = seen["i"]
            seen["i"] += 1
            if self.summary is None and i == seen["start"]:
                cut.start()
            out = inner(*args, **kwargs)
            if self.summary is None and i == seen["start"] + n - 1:
                seen["tries"] += 1
                summary = cut.stop([*self.spans.names, "aten::bmm"], n)
                if summary.agreed or seen["tries"] == TRACE_TRIES:
                    self.summary, summary.first = summary, seen["start"]
                seen["start"] = i + 1
            return out

        self.spans.wrap_with(module, attr, step)

    def _call(self):
        try:
            return self.replay.replay_sequences_outputs(self.tracker_cfg, self.seqs,
                                                        device=self.device)
        except RuntimeError as exc:
            if "iteration cap" not in str(exc):
                raise
            return None

    def window(self, seconds: float):
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            self.results.append(self._call())
            self.call_s.append(time.perf_counter() - t)
            # a traced run makes one untraced call at least, to time a step by
            if time.perf_counter() - t0 >= seconds and (not self.trace or len(self.call_s) > 1):
                break
        self.window_s = time.perf_counter() - t0
        self.attempted = len(self.results)
        self.failed = sum(r is None for r in self.results)
        self.spans.close()
        self.products = {k: [t.cpu() for t in v] for k, v in self.products.items()}
        if self.summary is not None:
            steps = len(self.seqs[0]["dets"])
            self.summary.work["unit_s"] = float(sum(self.call_s[1:]) / len(self.call_s[1:])) / steps

    def end_to_end(self) -> dict:
        done = self.attempted - self.failed
        return {"replay_fps": done * self.frames_per_call / self.window_s}

    def info(self) -> dict:
        """What the window did, for the log: calls, each call's seconds, and
        rows emitted a sequence-frame in the first call."""
        first = next((r for r in self.results if r is not None), None)
        rows = None if first is None else float(sum(m.sum() for _, m in first)) / self.frames_per_call
        return {"calls": self.attempted, "failed": self.failed, "call_s": self.call_s,
                "rows_per_frame": rows}

    def release(self):
        """Free the program's state (the kept results are host arrays)."""
        gc.collect()
        torch.cuda.empty_cache()

    def check(self) -> dict:
        oru = [] if self.summary is not None else None
        want = {}
        outs, masks, capped = ref.replay(self.cfg, self.seqs, self.device, record_oru=oru,
                                         record_products=(self.steps, want))
        readings = [compare.replay_outputs(r, outs, masks) for r in self.results if r is not None]
        numbers = compare.worst(readings) if readings else {}
        numbers["product_gap"] = products.gap(self.products, want)
        numbers["reference_capped"] = int(capped.sum())
        if oru is not None:
            first = self.summary.first
            self.summary.work["k4_bound_ms"] = sum(
                work.k4_bound(*dims, rejoin, gap)[0]
                for dims, rejoin, gap in oru[first:first + self.summary.units])
        return numbers

    def control(self, n_frames=None) -> dict:
        """The check's numbers with the reference in the program's place with
        TF32 products, the precision below the configuration's float32 with
        TF32 off (after ``setup``; every call replays the same frames, so
        ``n_frames`` is not used)."""
        want, got = {}, {}
        outs, masks, capped = ref.replay(self.cfg, self.seqs, self.device,
                                         record_products=(self.steps, want))
        with models.tf32(True):
            t_outs, t_masks, _ = ref.replay(self.cfg, self.seqs, self.device,
                                            record_products=(self.steps, got))
        rows = [(t_outs[s], t_masks[s]) for s in range(len(self.seqs))]
        return {"tf32": {**compare.replay_outputs(rows, outs, masks),
                         "product_gap": products.gap(got, want),
                         "reference_capped": int(capped.sum())}}
