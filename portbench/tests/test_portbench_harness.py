"""The harness: every file a cell, traffic mix or metric names is found by
name; the result line's keys; no card, no result; and no module of JAX or
of the JAX package is ever loaded."""

import json
import os
import subprocess
import sys
import types

import pytest

from portbench import harness, trace
from portbench.tests.conftest import ROOT

BENCH = harness.load_json(ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("parked", [False, True])
def test_every_named_file_is_found(parked):
    bench = harness.load_bench(ROOT, parked=parked)
    for w in bench["workloads"]:
        cell = harness.Cell(ROOT, bench, w["name"])
        assert cell.config["name"] == w["config"]
        assert harness.load_driver(cell.traffic["kind"]).Run
        assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(ROOT, m["name"]))
    for c in bench["configs"]:
        assert harness.load_json(ROOT / c["file"])["name"] == c["name"]


def test_parked_cells_stay_out_of_the_benchmark():
    """A parked cell is found by ``control.py`` and the tests, never by a
    run, and shares no name with ``BENCHMARK.json``."""
    held = harness.load_json(ROOT / "portbench" / "parked.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert not {e["name"] for e in held[key]} & {e["name"] for e in BENCH[key]}
    with pytest.raises(SystemExit):
        harness.Cell(ROOT, BENCH, held["workloads"][0]["name"])


def test_result_line_keys():
    summary = trace.Summary(2.0, 1.5, {"k": [3, 0.5]}, {}, {"(outside)": 0.4}, 1.0, 3)
    table = {"x": {"value": 0, "limit": 0}}
    device = {"platform": "gpu", "kind": "card", "count": 1, "memory_peak_bytes": 1}
    line = harness.result_line(True, 4, 0, {"m": {"value": 1.0, "unit": "ms"}}, device, table,
                               summary)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert line["device"]["busy_s"] == 1.5 and line["device"]["window_s"] == 2.0
    assert line["breakdown"] == {"device_ops": [["k", 0.5]], "idle_gaps": [["(outside)", 0.4]]}
    assert list(harness.result_line(False, 1, 1, {}, device, table)) == [
        "correct", "attempted", "failed", "metrics", "device", "checks"]
    json.dumps(line)


def test_decide_holds_every_number_to_its_limit():
    assert harness.decide({"a": 0, "b": 1e-4}, {"a": 0, "b": 1e-3})[0]
    assert not harness.decide({"a": 1, "b": 1e-4}, {"a": 0, "b": 1e-3})[0]
    assert not harness.decide({"a": 0}, {"a": 0, "b": 1e-3})[0]


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints nothing on stdout."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                           BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, env=env, cwd=tmp_path,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("jaxtyping_like"))
    monkeypatch.setitem(sys.modules, "boxmot_tpu_torch_like", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", types.ModuleType("flax.core"))
    assert harness.forbidden_modules() == ["flax"]


IMPORT_WALK = """
import pkgutil, importlib, sys, torch
import portbench
from portbench import harness
from portbench.tests.conftest import LIVE, REPLAY, drive
for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
for name in (LIVE, REPLAY):
    drive(name, 5, frames=2)
for m in harness.FORBIDDEN:
    assert m.split(".")[0] not in {k.split(".")[0] for k in sys.modules}, m
print("clean", len(sys.modules))
"""


def test_import_walk_loads_no_jax():
    """Every module of ``portbench`` and both drivers' runs (program paths
    and reference) load no module whose top-level name is jax, jaxlib,
    flax, optax or boxmot_tpu (``boxmot_tpu_torch`` is another name)."""
    proc = subprocess.run([sys.executable, "-c", IMPORT_WALK], capture_output=True, text=True,
                          cwd=ROOT, timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-3000:]
