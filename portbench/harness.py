"""The general part of the benchmark: a cell and its files found by name, the
look for a card, the clock around set-up and the window, the check that
decides ``correct``, the per-layer readers and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* a configuration: the ``file`` of its ``configs`` entry;
* a traffic mix: ``portbench/traffic/<traffic>.json``; its ``kind`` names
  the generator (``gen.py``) and the driver (``drivers/<kind>.py``);
* a cell's limits on the compared numbers: ``portbench/limits/<cell>.json``;
* a cell held out of ``BENCHMARK.json`` until the program can pass it: its
  entries in ``portbench/parked.json`` (``control.py`` and the tests find
  it there, a run never does);
* a per-layer metric: ``portbench/metrics/<metric>.py``, whose ``read``
  takes a trace's ``Summary`` and returns a number, or None where it finds
  nothing to read (the metric is then left out of the line).

The result, the last line of standard output, is one JSON object: correct,
attempted, failed, metrics, device (and with ``--trace 1`` the device's busy
and window seconds and a breakdown), then ``checks``, each compared number
beside its limit.  The same numbers end standard error.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "boxmot_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_bench(root: Path, parked: bool = False) -> dict:
    """``BENCHMARK.json``; with ``parked``, the cells held out of it
    (``portbench/parked.json``, its layout) added to its lists."""
    bench = load_json(root / "BENCHMARK.json")
    if parked:
        held = load_json(root / "portbench" / "parked.json")
        bench = {**bench, **{k: bench[k] + held[k]
                             for k in ("configs", "workloads", "end_to_end", "per_layer")}}
    return bench


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic, limits
    and metrics."""

    def __init__(self, root: Path, bench: dict, name: str):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = found[0]
        entry = next(c for c in bench["configs"] if c["name"] == self.workload["config"])
        self.config = load_json(root / entry["file"])
        self.traffic = load_json(root / "portbench" / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(root / "portbench" / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def load_reader(root: Path, name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(sys.modules)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules, compared whole, that no run may hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w() -> float | None:
    """The card's power limit in W as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def decide(checks: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every limited number present
    and at most its limit."""
    table = {name: {"value": checks.get(name), "limit": limit} for name, limit in limits.items()}
    ok = all(v["value"] is not None and v["value"] <= v["limit"] for v in table.values())
    return ok, table


def per_layer_metrics(root: Path, cell: Cell, summary) -> dict:
    out = {}
    for m in cell.per_layer:
        value = load_reader(root, m["name"])(summary)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv, t_start: float, root: Path) -> int:
    parser = argparse.ArgumentParser(prog="portbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = Cell(root, load_bench(root), args.workload)

    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} card(s)", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    power = power_limit_w()
    run = load_driver(cell.traffic["kind"]).Run(cell, args.seed, device, trace=bool(args.trace))
    run.setup()
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    torch.cuda.reset_peak_memory_stats(device)
    run.window(args.seconds)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    e2e = run.end_to_end()
    t_window = time.perf_counter()
    run.release()
    correct, table = decide(run.check(), cell.limits)
    info = {"setup_s": setup_s, "window_end_s": t_window - t_start,
            "check_s": time.perf_counter() - t_window, **run.info()}
    if args.trace:
        info.update(trace_linked=run.summary.linked, trace_agreed=run.summary.agreed,
                    trace_device_events=run.summary.device_events)
    print("info " + json.dumps(info), file=sys.stderr)
    if args.trace:
        metrics = per_layer_metrics(root, cell, run.summary)
    else:
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                   "memory_peak_bytes": peak, "power_limit_w": power}
    result = result_line(correct, run.attempted, run.failed, metrics, device_info, table,
                         run.summary if args.trace else None)
    for name, v in table.items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                table: dict, summary=None) -> dict:
    """The result object; with a trace's ``summary`` the device's busy and
    window seconds and the breakdown; ``checks`` last."""
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dict(device)}
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    result["checks"] = table
    return result
