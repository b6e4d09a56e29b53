"""Device-time measurement on the card: kernel times and step profiles.

Used by ``chip_smoke.py`` and ``tools/port_kernel_ab.py``; the tracker
paths never call it.  It imports only torch, so a script can load it by
file path beside another checkout of the port.

* ``device_ms`` gives a kernel's device time per launch from
  ``torch.profiler``'s CUPTI trace: the kernel's own run on the card,
  without the wrapper's host checks, allocations and ctypes call (which a
  CUDA-event pair around one call would include).
* ``record_calls`` keeps the arguments of the kernel wrappers a step calls,
  so that a kernel can be timed on the inputs the main path gives it.
* ``profile_steps`` gives the device busy time of a run of steps, and each
  kernel's share of it.
* ``bound_ms`` is the least time the card could take for some work: the
  larger of its bytes over the memory rate and its operations over the
  float32 rate (NVIDIA H100 SXM data sheet, 700 W).
"""

from __future__ import annotations

import contextlib
import statistics

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations", whichever sets it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_table(prof) -> dict[str, tuple[int, float]]:
    """{kernel name: (launches, device us)} of the device events of a trace."""
    return {evt.key: (evt.count, float(evt.device_time_total)) for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA and evt.device_time_total > 0}


def device_ms(fn, kernel: str, reps: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per launch of the kernels whose name holds
    ``kernel``, over ``reps`` calls of ``fn`` under the profiler."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    # a trace now and then loses device events; the mean is over those it
    # holds, and a trace that lost most of them is taken again
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [(n, us) for name, (n, us) in _kernel_table(prof).items() if kernel in name]
        launches = sum(n for n, _ in hits)
        if launches >= reps // 2:
            return sum(us for _, us in hits) / launches / 1e3
    raise RuntimeError(f"the profiler saw {launches} launches of {kernel!r} in {reps} calls")


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


def profile_steps(fn, n_steps: int) -> dict:
    """Profile ``fn`` (which runs ``n_steps`` steps and returns nothing the
    host waits for); per step: kernels launched, device busy ms, and each
    kernel's (launches, device ms)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    table = _kernel_table(prof)
    return {
        "kernels_per_step": sum(n for n, _ in table.values()) / n_steps,
        "busy_ms_per_step": sum(us for _, us in table.values()) / n_steps / 1e3,
        "by_kernel": {k: (n / n_steps, us / n_steps / 1e3) for k, (n, us) in table.items()},
    }
