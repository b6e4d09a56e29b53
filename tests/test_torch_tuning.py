"""The port's tuner (``boxmot_tpu_torch.engine.tuning``) against the JAX
package's, on the CPU, and the repairs that let trials run in threads.

The random, grid and TPE backends give the JAX backends' suggestions bit for
bit from the same specs, seed and history; ``Tuner`` and ``run_tune`` over
ByteTrack on MOT17-mini (4 trials, seed 0) give JAX's params exactly and its
HOTA/MOTA/IDF1 within 1e-4, write trials.json and best.yaml, resume without
running a trial, and give the same trials with 2 and 4 worker threads as
with 1; over ``bytetrack:cpp`` they give JAX's trials exactly.  The CLI's
``tune`` and ``Boxmot.tune`` give the JAX CLI's lines and facade's result.

The repairs: a kernel is compiled once however many threads ask for it
(``csrc/build.py``, with a fake nvcc), the replay's sync-debug lift is
re-entrant across threads, the launch counters count every launch of
concurrent threads, and no class of the port defines a method twice.
"""

from __future__ import annotations

import ast
import ctypes
import json
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from boxmot_tpu.engine.tuning import backends as jbackends
from boxmot_tpu.engine.tuning import tuner as jtuner
from boxmot_tpu_torch.engine.tuning import backends as tbackends
from boxmot_tpu_torch.engine.tuning import tuner as ttuner
from tests.test_pinned_metrics import ROOTS

REPO = Path(__file__).resolve().parent.parent
PORT_PKG = REPO / "boxmot_tpu_torch"
MOT17 = ROOTS["mot17_mini"]
ATOL = 1e-4
METRICS = ("HOTA", "MOTA", "IDF1")
SPECS = {
    "x": {"type": "uniform", "range": [0.0, 1.0]},
    "y": {"type": "loguniform", "range": [0.01, 10.0]},
    "n": {"type": "qrandint", "range": [2, 10, 2]},
    "k": {"type": "randint", "range": [1, 5]},
    "mode": {"type": "choice", "options": ["a", "b", "c"]},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _one_jax_device(monkeypatch):
    """The JAX reference replays its sequences on one CPU device (see
    tests/test_torch_cli.py)."""
    import jax

    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda backend=None: real(backend)[:1])


def _below_docstring(path: Path) -> str:
    src = path.read_text()
    doc = ast.parse(src).body[0]
    return "".join(src.splitlines(keepends=True)[doc.end_lineno:])


def test_backends_module_is_a_copy_of_the_original():
    assert _below_docstring(PORT_PKG / "engine/tuning/backends.py") == \
        _below_docstring(REPO / "boxmot_tpu/engine/tuning/backends.py")


def _score(params):
    """A synthetic objective: on ``SPECS`` its peak is at x=0.7, y=1, n=6,
    mode b; on a tracker's space, the sum of the numeric params."""
    if "x" not in params:
        return sum(float(v) for v in params.values() if isinstance(v, (int, float)))
    return (-(params["x"] - 0.7) ** 2 - np.log(params["y"]) ** 2 * 0.1
            - (params["n"] - 6) ** 2 * 0.01 + (0.5 if params["mode"] == "b" else 0.0)
            + 0.01 * params["k"])


def _suggestions(module, name, specs, n, seed):
    """``n`` suggestions of backend ``name``, each fed back with its score
    (every fifth as a failed trial)."""
    backend = module.create_backend(name, specs, seed=seed)
    history = []
    for i in range(n):
        params = backend.suggest(history)
        if params is None:
            break
        failed = i % 5 == 4
        history.append({"params": params, "score": float("-inf") if failed else _score(params),
                        "error": "boom" if failed else None})
    return [h["params"] for h in history]


@pytest.mark.parametrize("name", ["random", "grid", "tpe"])
@pytest.mark.parametrize("seed", [0, 7])
def test_backend_suggestions_equal_jax(name, seed):
    """30 suggestions from the same specs, seed and synthetic history are
    JAX's, bit for bit (TPE past its 8 start-up trials)."""
    got = _suggestions(tbackends, name, SPECS, 30, seed)
    want = _suggestions(jbackends, name, SPECS, 30, seed)
    assert len(got) == 30 and got == want
    assert json.dumps(got) == json.dumps(want)


def test_backends_on_a_tracker_space_and_their_errors():
    from boxmot_tpu.configs import flatten_specs as jflat
    from boxmot_tpu.configs import load_tracker_config as jload
    from boxmot_tpu_torch.configs import flatten_specs, load_tracker_config

    specs = flatten_specs(load_tracker_config("occluboost"))
    assert specs == jflat(jload("occluboost"))
    for name in ("random", "tpe"):
        assert _suggestions(tbackends, name, specs, 12, 3) == \
            _suggestions(jbackends, name, specs, 12, 3)
    rng_t, rng_j = np.random.default_rng(1), np.random.default_rng(1)
    assert ttuner.sample_config(specs, rng_t) == jtuner.sample_config(specs, rng_j)
    assert len(tbackends.GridBackend(SPECS, n_points=2)) == len(jbackends.GridBackend(SPECS, n_points=2))
    for module in (tbackends, jbackends):
        with pytest.raises(ValueError, match="unknown tuning backend"):
            module.create_backend("optuna", SPECS)
        with pytest.raises(ValueError, match="unknown search space type"):
            module.sample_param({"type": "bogus"}, np.random.default_rng(0))


def _trials(tuner_or_dir):
    trials = tuner_or_dir.trials if hasattr(tuner_or_dir, "trials") else \
        json.loads((Path(tuner_or_dir) / "trials.json").read_text())
    return [{k: t[k] for k in ("index", "params", "metrics", "score", "error")} for t in trials]


def _assert_trials_close(got, want):
    assert [t["params"] for t in got] == [t["params"] for t in want]
    assert [t["error"] for t in got] == [t["error"] for t in want] == [None] * len(want)
    for g, w in zip(got, want):
        for k in METRICS:
            assert abs(g["metrics"][k] - w["metrics"][k]) <= ATOL, (k, g, w)


@pytest.fixture(scope="module")
def jax_tune(tmp_path_factory):
    """The JAX package's run_tune: ByteTrack on MOT17-mini, 4 trials, seed 0."""
    import jax

    real = jax.devices
    jax.devices = lambda backend=None: real(backend)[:1]
    try:
        work = tmp_path_factory.mktemp("jax_tune")
        best = jtuner.run_tune(MOT17, "bytetrack", n_trials=4, work_dir=work, seed=0)
    finally:
        jax.devices = real
    return best, work


def test_tuner_equals_jax_and_resumes(tmp_path, jax_tune, monkeypatch):
    """The port's run_tune gives JAX's params exactly and its metrics within
    1e-4, the same best, trials.json and best.yaml; a second fit in the
    same work dir runs no trial."""
    import yaml

    jbest, jwork = jax_tune
    seen = []
    best = ttuner.run_tune(MOT17, "bytetrack", n_trials=4, work_dir=tmp_path, seed=0,
                           device="cpu", trial_callback=seen.append)
    _assert_trials_close(_trials(tmp_path), _trials(jwork))
    assert [t["index"] for t in seen] == [0, 1, 2, 3]
    assert best["params"] == jbest["params"]
    assert abs(best["score"] - jbest["score"]) <= 2 * ATOL
    assert type(best).__name__ == "TuneResult" and best.summary().startswith("score ")
    assert yaml.safe_load((tmp_path / "best.yaml").read_text()) == \
        yaml.safe_load((jwork / "best.yaml").read_text())

    tuner = ttuner.Tuner(MOT17, "bytetrack", work_dir=tmp_path, device="cpu")
    monkeypatch.setattr(tuner, "_evaluate", lambda params: pytest.fail("a trial ran on resume"))
    assert len(tuner.trials) == 4
    again = tuner.fit(n_trials=4)
    assert again["params"] == best["params"] and again["score"] == best["score"]
    typed = tuner.trial_results()
    assert [t.ok for t in typed] == [True] * 4 and typed[1].config == tuner.trials[1]["params"]


@pytest.mark.parametrize("n_workers", [2, 4])
def test_threaded_trials_equal_serial(tmp_path, n_workers):
    """Trials run in batches of worker threads are the serial run's, bit for
    bit, in the same order."""
    serial = ttuner.Tuner(MOT17, "bytetrack", work_dir=tmp_path / "serial", seed=0, device="cpu")
    serial.fit(n_trials=5)
    threaded = ttuner.Tuner(MOT17, "bytetrack", work_dir=tmp_path / "threaded", seed=0,
                            device="cpu")
    threaded.fit(n_trials=5, n_workers=n_workers)
    assert _trials(threaded) == _trials(serial)


def test_cpp_tuner_equals_jax(tmp_path):
    """Over the native cores (``bytetrack:cpp``, host code in both packages)
    the trials are JAX's exactly, with 3 worker threads as with 1."""
    want = jtuner.Tuner(MOT17, "bytetrack:cpp", work_dir=tmp_path / "jax", seed=2)
    want.fit(n_trials=4)
    got = ttuner.Tuner(MOT17, "bytetrack:cpp", work_dir=tmp_path / "port", seed=2, device="cpu")
    got.fit(n_trials=4, n_workers=3)
    assert _trials(got) == _trials(want)


def _lines(output: str) -> list[str]:
    keep = ("trial ", "best score", "  ")
    return [line for line in output.splitlines() if line.startswith(keep) and "INFO" not in line]


def test_cli_tune_prints_what_the_jax_cli_prints(tmp_path, jax_tune):
    from boxmot_tpu.engine.cli import cli as jcli
    from boxmot_tpu_torch.engine.cli import cli

    args = ["tune", "--data", str(MOT17), "--n-trials", "4", "--seed", "0"]
    port = CliRunner().invoke(cli, [*args, "--work-dir", str(tmp_path / "port"), "--device",
                                    "cpu", "--n-workers", "2"])
    assert port.exit_code == 0, port.output
    want = CliRunner().invoke(jcli, [*args, "--work-dir", str(tmp_path / "jax")])
    assert want.exit_code == 0, want.output
    assert _lines(port.output) == _lines(want.output)
    assert len(_lines(port.output)) == 4 + 1 + 5
    assert (tmp_path / "port" / "best.yaml").exists()


def test_boxmot_tune_equals_jax(tmp_path, jax_tune):
    from boxmot_tpu.api import Boxmot as JBoxmot
    from boxmot_tpu_torch.api import Boxmot

    got = Boxmot(tracker="bytetrack", device="cpu").tune(data=MOT17, n_trials=4,
                                                        work_dir=tmp_path / "port")
    want = JBoxmot(tracker="bytetrack").tune(data=MOT17, n_trials=4, work_dir=tmp_path / "jax")
    assert got["params"] == want["params"] == jax_tune[0]["params"]
    for k in METRICS:
        assert abs(got["metrics"][k] - want["metrics"][k]) <= ATOL


# -- the repairs that let trials run in threads ------------------------------

def test_threads_share_one_kernel_build(tmp_path, monkeypatch):
    """Eight threads asking for one kernel at once get one library from one
    compile (a fake nvcc that sleeps, then builds a stub with g++), and no
    temporary file is left behind."""
    from boxmot_tpu_torch.csrc import build

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    stub = tmp_path / "stub.cpp"
    stub.write_text('extern "C" const char* bmt_cuda_error_string(int) { return "ok"; }\n'
                    'extern "C" int bmt_fake(int x) { return x + 1; }\n')
    runs = tmp_path / "runs.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(f"""#!/bin/sh
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
echo "$out" >> {runs}
sleep 0.5
exec {gxx} -shared -fPIC -o "$out" {stub}
""")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "_LOCKS", {})
    monkeypatch.setattr(build, "BUILD_LOG", {})
    barrier = threading.Barrier(8)
    results = [None] * 8

    def worker(i):
        barrier.wait()
        if i % 2:
            results[i] = build.build("iou_cost")
        else:
            results[i] = build.entry("iou_cost", "bmt_fake", [ctypes.c_int])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(runs.read_text().splitlines()) == 1
    path = build.library_path("iou_cost")
    assert [r for r in results[1::2]] == [path] * 4
    fns = results[0::2]
    assert all(fn(41) == 42 for fn in fns) and fns[0].restype is ctypes.c_int
    assert build._LOADED["iou_cost"]._name == str(path) and list(build.BUILD_LOG) == ["iou_cost"]
    assert sorted(p.name for p in (tmp_path / "kernels").iterdir()) == [path.name]


def test_sync_debug_lift_is_reentrant_across_threads(monkeypatch):
    """Four threads inside ``sync_allowed`` at once: the mode is lifted while
    any is inside, set back once, by the last one out, and a second round
    finds it as the caller left it."""
    from boxmot_tpu_torch.engine import replay

    state = {"mode": 2, "sets": []}

    def set_mode(mode):
        state["sets"].append(mode)
        state["mode"] = mode

    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: state["mode"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    inside, seen = threading.Barrier(4), []

    def trial(i):
        with replay.sync_allowed():
            inside.wait()
            seen.append(state["mode"])
            threading.Event().wait(0.02 * i)  # leave one after another
        seen.append(state["mode"] if i < 3 else None)

    for _ in range(2):
        threads = [threading.Thread(target=trial, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and state["mode"] == 2
    assert state["sets"] == [0, 2, 0, 2]
    assert seen.count(0) >= 4 * 2 and 2 not in seen[:4]


def test_launch_counters_count_every_thread(monkeypatch):
    """16 threads (more than this host's cores) count at once, with the
    interpreter switching threads every microsecond: no launch is lost."""
    import sys

    from boxmot_tpu_torch.csrc import build
    from boxmot_tpu_torch.ops.fused_iou_cost import fused_iou_cost

    monkeypatch.setattr(fused_iou_cost, "launches", 0)
    start = threading.Barrier(16)

    def launch():
        start.wait()
        for _ in range(5000):
            build.count_launch(fused_iou_cost)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert fused_iou_cost.launches == 16 * 5000
    wrappers = ("crops.py", "fused_iou_cost.py", "lap.py", "nms.py", "oru.py", "rotated_iou.py")
    for name in wrappers:
        src = (PORT_PKG / "ops" / name).read_text()
        assert "launches += 1" not in src and "build.count_launch(" in src


def test_no_class_or_module_defines_a_name_twice():
    """An AST scan of the port: no function or method is defined twice in one
    class or module body (a property's setter aside), as StrongSORT's shell
    once defined ``_lost_mask``."""
    dups = []
    for path in sorted(PORT_PKG.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in [tree, *(n for n in ast.walk(tree) if isinstance(n, ast.ClassDef))]:
            names = [f.name for f in node.body
                     if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                     and not any(isinstance(d, ast.Attribute) and d.attr in ("setter", "deleter")
                                 for d in f.decorator_list)]
            dups += [f"{path.relative_to(REPO)}:{getattr(node, 'name', '<module>')}.{n}"
                     for n in set(names) if names.count(n) > 1]
    assert dups == []


def test_strongsort_lost_mask_stays_on_the_device():
    from boxmot_tpu_torch.trackers.strongsort import StrongSort

    trk = StrongSort(device="cpu")
    trk.update(np.array([[10, 10, 60, 100, 0.9, 0]], np.float32), np.zeros((120, 120, 3), np.uint8),
               np.ones((1, 512), np.float32))
    mask = trk._lost_mask(trk._state)
    assert isinstance(mask, torch.Tensor) and mask.dtype == torch.bool
