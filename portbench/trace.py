"""Spans and the reading of a traced window.

In a ``--trace 1`` run the drivers wrap some of the port's calls in
``torch.profiler.record_function`` ranges (``Spans``): bound methods and
module attributes are replaced from here, and no file of the program is
edited.  A slice of the window runs under ``torch.profiler`` with CUPTI
(``Slice``); ``summarize`` reads the profiler's raw events and gives, for
the slice: its length, the union of the device's busy intervals, each
kernel's launches and device time, and for each range its count, its host
time and the device time of the work launched inside it.  A kernel belongs
to a range when the host call that launched it (linked by the CUPTI
correlation id) lies inside the range.

A short trace of kernels launched only through ctypes has been seen to
lose every device event on an H100 (``tools/trace_gap_probe.py``): every
traced slice here holds PyTorch operators, waits ``TAIL_S`` after the last
synchronize, and is taken again when its launches of the port's kernels
differ from the program's own launch counters (``launch_counts``).
"""

from __future__ import annotations

import bisect
import functools
import importlib
import time

import torch

TAIL_S = 0.005
# counter name -> (module, wrapper whose ``launches`` counts a kernel, kernel name prefix)
COUNTERS = {
    "k2": ("boxmot_tpu_torch.ops.lap", "masked_assignment", "auction_"),
    "k4": ("boxmot_tpu_torch.ops.oru", "oru_replay", "oru_"),
    "k5": ("boxmot_tpu_torch.ops.crops", "extract_crops", "crops_"),
    "k6": ("boxmot_tpu_torch.ops.nms", "nms", "nms_"),
}


def kernel_name(name: str) -> str:
    """A trace's kernel name without return type, namespaces, template and
    parameters (``utils/measure.py::kernel_name``)."""
    base = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return base.split("<")[0].split("(")[0].split("::")[-1].strip()


class Spans:
    """Named ranges around attributes of the port's objects and modules, put
    back by ``close``."""

    def __init__(self):
        self._undo = []
        self.names: list[str] = []

    def wrap(self, owner, attr: str, name: str) -> None:
        """``owner.attr`` inside a range ``name``."""
        inner = getattr(owner, attr)

        @functools.wraps(inner)
        def ranged(*args, **kwargs):
            with torch.profiler.record_function(name):
                return inner(*args, **kwargs)

        self.wrap_with(owner, attr, ranged)
        self.names.append(name)

    def wrap_with(self, owner, attr: str, fn) -> None:
        """``owner.attr`` replaced by ``fn`` until ``close``."""
        had = attr in vars(owner) if not isinstance(owner, type) else True
        self._undo.append((owner, attr, getattr(owner, attr), had))
        setattr(owner, attr, fn)

    def close(self) -> None:
        for owner, attr, inner, had in reversed(self._undo):
            if had:
                setattr(owner, attr, inner)
            else:
                delattr(owner, attr)
        self._undo.clear()


def launch_counts() -> dict[str, int]:
    """The program's own launch counter of each kernel (``build.count_launch``)."""
    return {k: getattr(getattr(importlib.import_module(mod), fn), "launches", 0)
            for k, (mod, fn, _) in COUNTERS.items()}


class Summary:
    """What a traced slice shows; ``units`` (frames or steps) and ``work``
    (the benchmark's counts for the slice) are set by the driver."""

    def __init__(self, window_s, busy_s, kernels, ranges, gaps, linked, device_events):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernels = kernels  # short name -> [launches, device s]
        # name -> {"count", "host_s", "device_s", "period_s" (start to start)}
        self.ranges = ranges
        self.gaps = gaps  # range open on the host mid-gap (or "(outside)") -> idle s
        self.linked = linked  # share of device events linked to a host launch
        self.device_events = device_events
        self.units = 0
        self.work: dict = {}

    def kernel_s(self, prefix: str) -> tuple[int, float]:
        """(launches, device s) of the kernels whose short name starts with
        ``prefix``."""
        hits = [v for k, v in self.kernels.items() if k.startswith(prefix)]
        return sum(n for n, _ in hits), sum(s for _, s in hits)

    def range_stat(self, name: str, key: str) -> float | None:
        got = self.ranges.get(name)
        return None if not got or not got["count"] else got[key]

    def breakdown(self) -> dict:
        ops = sorted(((k, s) for k, (_, s) in self.kernels.items()), key=lambda kv: -kv[1])
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, s] for k, s in ops[:10]],
                "idle_gaps": [[k, s] for k, s in gaps[:10]]}


def _union(intervals):
    """Merged (start, end) intervals of sorted ones."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(spans, starts, t):
    """The name of the shortest range of ``spans`` {name: sorted [(start,
    end)]} that holds time ``t``, or "(outside)"."""
    best, length = "(outside)", None
    for name, ivs in spans.items():
        i = bisect.bisect_right(starts[name], t) - 1
        if i >= 0 and ivs[i][1] >= t and (length is None or ivs[i][1] - ivs[i][0] < length):
            best, length = name, ivs[i][1] - ivs[i][0]
    return best


def summarize(prof, range_names, window_s: float) -> Summary:
    """Read the profiler's raw events (``utils/measure.py::_kernel_table``
    reads them so too: ``key_averages`` would build a Python object an event
    and take far longer on a window of some 100,000 kernels)."""
    cuda = torch.autograd.DeviceType.CUDA
    wanted = set(range_names)
    device, launch, spans = [], {}, {name: [] for name in wanted}
    for evt in prof.profiler.kineto_results.events():
        name = evt.name()
        if evt.device_type() == cuda:
            if evt.duration_ns() > 0 and not evt.is_user_annotation() and name not in wanted:
                device.append((evt.start_ns(), evt.end_ns(), name, evt.correlation_id(),
                               evt.linked_correlation_id()))
        elif name in wanted:
            spans[name].append((evt.start_ns(), evt.end_ns()))
        elif name.startswith("cu") and evt.correlation_id():
            launch[evt.correlation_id()] = evt.start_ns()
    device.sort()
    kernels: dict[str, list] = {}
    for s, e, name, _, _ in device:
        k = kernels.setdefault(kernel_name(name), [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e9
    busy = _union([(s, e) for s, e, *_ in device])
    busy_s = sum(e - s for s, e in busy) / 1e9
    ranges, linked = {}, 0
    starts = {}
    for name, ivs in spans.items():
        ivs.sort()
        starts[name] = [s for s, _ in ivs]
        ranges[name] = {"count": len(ivs), "host_s": sum(e - s for s, e in ivs) / 1e9,
                        "device_s": 0.0,
                        "period_s": (ivs[-1][0] - ivs[0][0]) / (len(ivs) - 1) / 1e9
                        if len(ivs) > 1 else None}
    for s, e, _, corr, link in device:
        t = launch.get(corr, launch.get(link))
        if t is None:
            continue
        linked += 1
        for name, ivs in spans.items():
            i = bisect.bisect_right(starts[name], t) - 1
            if i >= 0 and ivs[i][1] >= t:
                ranges[name]["device_s"] += (e - s) / 1e9
    gaps: dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        where = _innermost(spans, starts, (e0 + s1) // 2)
        gaps[where] = gaps.get(where, 0.0) + (s1 - e0) / 1e9
    return Summary(window_s, busy_s, kernels, ranges, gaps,
                   linked / len(device) if device else 0.0, len(device))


class Slice:
    """A profiler started and stopped by hand around a slice of the window
    (a run of frames, or of steps inside a call)."""

    def start(self) -> None:
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.before = launch_counts()
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, range_names, units: int) -> Summary:
        """The slice's ``Summary``, the card synchronized first and
        ``TAIL_S`` waited before the profiler stops; ``agreed`` says whether
        its launches match the program's counters."""
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        time.sleep(TAIL_S)
        self.prof.__exit__(None, None, None)
        summary = summarize(self.prof, range_names, window_s)
        summary.units = units
        summary.agreed = counts_agree(self.before, launch_counts(), summary)
        self.prof = None
        return summary


def counts_agree(before: dict, after: dict, summary: Summary) -> bool:
    """Whether the trace holds as many launches of each of the port's
    kernels as the program counted, and at least one device event."""
    if not summary.device_events:
        return False
    return all(summary.kernel_s(prefix)[0] == after[k] - before[k]
               for k, (_, _, prefix) in COUNTERS.items())
