"""Device-time measurement on the card: kernel times and step profiles.

Used by ``chip_smoke.py`` and ``tools/port_kernel_ab.py``; the tracker
paths never call it.  It imports only torch, so a script can load it by
file path beside another checkout of the port.

* ``device_ms_per_call`` gives the device time a call of a function spends
  in every kernel whose name starts with a prefix (``iou_cost_``,
  ``nms_``, ...), from ``torch.profiler``'s CUPTI trace: the kernels' own
  run on the card, without the wrapper's host checks, allocations and
  ctypes call (which a CUDA-event pair around one call would include).  A
  kernel made of several launches is timed whole, whatever its launches;
  for a wrapper that launches one kernel a call it is the time a launch.
* ``record_calls`` keeps the arguments of the kernel wrappers a step calls,
  so that a kernel can be timed on the inputs the main path gives it.
* ``profile_steps`` gives the device busy time of a run of steps, and each
  kernel's share of it, from a trace that another one confirms.
* ``bound_ms`` is the least time the card could take for some work: the
  larger of its bytes over the memory rate and its operations over the
  float32 rate (NVIDIA H100 SXM data sheet, 700 W).
"""

from __future__ import annotations

import contextlib
import statistics
import time

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
RETAKE_PAUSE_S = 0.5
# host time a trace waits, after the card is synchronized, before it stops
# (``_traced``)
TRACE_TAIL_S = 0.005


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations", whichever sets it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_table(prof) -> dict[str, tuple[int, float]]:
    """{kernel name: (launches, device us)} of the device events of a trace,
    read from the profiler's raw events: ``key_averages`` would first turn
    every event, the host's operators too, into a Python object, which takes
    about 10 s for the 100,000 events of 16 steps of the heaviest tracker."""
    cuda = torch.autograd.DeviceType.CUDA
    table = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == cuda and evt.duration_ns() > 0:
            n, us = table.get(evt.name(), (0, 0.0))
            table[evt.name()] = (n + 1, us + evt.duration_ns() / 1e3)
    return table


def kernel_name(name: str) -> str:
    """A trace's kernel name without its return type, namespaces, template
    and parameters: ``void (anonymous namespace)::crops_kernel<true,
    float>(...)`` -> ``crops_kernel``."""
    base = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return base.split("<")[0].split("(")[0].split("::")[-1].strip()


def _traced(fn, calls: int) -> dict[str, tuple[int, float]]:
    """The kernel table (``_kernel_table``) of a trace of ``calls`` calls of
    ``fn``, the card synchronized and ``TRACE_TAIL_S`` waited before the
    trace ends.  On an H100, traces of a few ms that held no PyTorch
    operator (only kernels launched through ctypes) now and then held none
    of their device events, where the same calls followed by the wait, or
    mixed with a PyTorch kernel, kept every one
    (``tools/trace_gap_probe.py``).  The wait is a guard: the cause is not
    known, and the retakes (``_retaken``, ``settled_trace``) stay."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_TAIL_S)
    return _kernel_table(prof)


def _retaken(take, ok, tries: int = 6):
    """The first of up to ``tries`` results of ``take()`` that ``ok``
    accepts, else the last.  A trace now and then loses device events, and
    the losses come in runs, so each retake waits a moment."""
    for attempt in range(tries):
        if attempt:
            time.sleep(RETAKE_PAUSE_S)
        got = take()
        if ok(got):
            break
    return got


def device_ms_per_call(fn, prefix: str, reps: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds a call of ``fn`` spends in the kernels whose
    name (``kernel_name``) starts with ``prefix``, over ``reps`` calls under
    the profiler.  A trace now and then loses device events, so no trace of
    a single call is relied on (on an H100, traces of one call of K2 lost its
    launch six times in a row, where traces of 20 calls held 19): a trace of
    ``reps`` calls that holds fewer than ``reps`` / 2 launches is taken
    again (``_retaken``); a call's launches are the held launches over
    ``reps``, rounded, and the mean is over the calls the trace holds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def matched():
        hits = [(k, us) for name, (k, us) in _traced(fn, reps).items()
                if kernel_name(name).startswith(prefix)]
        return sum(k for k, _ in hits), sum(us for _, us in hits)

    launches, us = _retaken(matched, lambda got: got[0] >= reps / 2)
    if launches < reps / 2:
        raise RuntimeError(f"the profiler saw {launches} launches of {prefix!r}* kernels in "
                           f"{reps} calls")
    per_call = round(launches / reps)
    return us / (launches / per_call) / 1e3


def kernels_of_call(fn, calls: int = 5) -> list[str]:
    """The names (``kernel_name``) of the kernels a call of ``fn`` runs on
    the card, from a trace of ``calls`` calls after a warm-up call (taken
    again while it holds no device event, ``_retaken``)."""
    fn()
    torch.cuda.synchronize()
    return _retaken(lambda: sorted(kernel_name(name) for name in _traced(fn, calls)), bool)


def event_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median milliseconds of one call, from CUDA events around each call:
    the wrapper's time (host work included when the device waits for it)."""
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


@contextlib.contextmanager
def record_calls(module, names):
    """Within the block, each ``module.<name>`` (a kernel wrapper as a step
    module imported it) records the arguments of its calls, cloned, in the
    yielded {name: [(args, kwargs), ...]}, then runs as before."""
    calls = {name: [] for name in names}
    real = {name: getattr(module, name) for name in names}

    def clone(x):
        return x.clone() if torch.is_tensor(x) else x

    def recorder(name):
        def wrapper(*args, **kwargs):
            calls[name].append(([clone(a) for a in args],
                                {k: clone(v) for k, v in kwargs.items()}))
            return real[name](*args, **kwargs)
        return wrapper

    for name in names:
        setattr(module, name, recorder(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(module, name, fn)


def settled_trace(kernel_counts: list[int]) -> int | None:
    """Which of the step traces taken so far to keep, from their kernel
    counts in order: the latest one whose count an earlier trace matches;
    after three traces of which no two agree, the one with the most kernels
    (a trace loses device events, it never gains them); else None, to take
    another.  An empty trace agrees with none: late in a long run on an
    H100, two traces in a row of only ``F.scaled_dot_product_attention``
    held no device event.  After six empty traces, the last."""
    if kernel_counts[-1] and kernel_counts[-1] in kernel_counts[:-1]:
        return len(kernel_counts) - 1
    if len(kernel_counts) >= 3 and any(kernel_counts) or len(kernel_counts) >= 6:
        return max(range(len(kernel_counts)), key=lambda i: (kernel_counts[i], i))
    return None


def profile_steps(fn, n_steps: int) -> dict:
    """Profile ``fn`` (which runs ``n_steps`` steps and returns nothing the
    host waits for); per step: kernels launched, device busy ms, and each
    kernel's (launches, device ms).  A trace now and then loses device
    events, so ``fn`` is traced until two traces agree on the kernel count,
    at most three times, six while they are empty (``settled_trace``);
    ``traces`` says how many."""
    torch.cuda.synchronize()
    tables, keep = [], None
    while keep is None:
        if tables and not tables[-1]:
            time.sleep(RETAKE_PAUSE_S)  # losses come in runs
        tables.append(_traced(fn, 1))
        keep = settled_trace([sum(n for n, _ in t.values()) for t in tables])
    table = tables[keep]
    return {
        "kernels_per_step": sum(n for n, _ in table.values()) / n_steps,
        "busy_ms_per_step": sum(us for _, us in table.values()) / n_steps / 1e3,
        "by_kernel": {k: (n / n_steps, us / n_steps / 1e3) for k, (n, us) in table.items()},
        "traces": len(tables),
    }
