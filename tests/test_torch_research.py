"""The port's research loop (``boxmot_tpu_torch.engine.research``) against
the JAX package's, on the CPU.

``ResearchRunner`` over ByteTrack on MOT17-mini (3 candidates, seed 0) gives
JAX's candidate params exactly and its metrics within 1e-4, and resumes;
``default_objective`` and ``PenaltyConfig.score`` equal JAX's on a grid of
inputs; ``validate_candidate``, ``change_summary`` and the AST proposer give
JAX's text from the same source and seed; the LLM proposer talks to a
scripted local endpoint.  The sandbox: ``SourceWorkspace`` preflights the
port's tracker in a child process, contains a broken candidate and is
seeded with the parent's kernel libraries; ``SourceResearchRunner`` runs 2
candidates on the CPU; and the child loads no module of JAX, jaxlib, flax
or the JAX package.  The CLI's ``research`` (parameters) prints what the
JAX CLI prints, ``research --edit-source`` runs end to end, and
``Boxmot.research`` equals JAX's.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from boxmot_tpu.engine.research import candidates as jcand
from boxmot_tpu.engine.research import runner as jrunner
from boxmot_tpu_torch.engine.research import candidates as tcand
from boxmot_tpu_torch.engine.research import runner as trunner
from tests.test_pinned_metrics import PINNED, ROOTS

REPO = Path(__file__).resolve().parent.parent
MOT17 = ROOTS["mot17_mini"]
ATOL = 1e-4
METRICS = ("HOTA", "MOTA", "IDF1")
PORT_BYTETRACK = "boxmot_tpu_torch/trackers/bytetrack.py"
FORBIDDEN = ("[m for m in sys.modules if m in ('jax', 'jaxlib', 'flax')"
             " or m == 'boxmot_tpu' or m.startswith(('boxmot_tpu.', 'jax.', 'jaxlib.', 'flax.'))]")


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


@pytest.fixture(scope="module")
def jax_research(tmp_path_factory):
    """The JAX ResearchRunner: ByteTrack on MOT17-mini, 3 candidates, seed 0."""
    import jax

    real = jax.devices
    jax.devices = lambda backend=None: real(backend)[:1]
    try:
        runner = jrunner.ResearchRunner(MOT17, "bytetrack", seed=0,
                                        work_dir=tmp_path_factory.mktemp("jax_research"))
        best = runner.run(n_candidates=3)
    finally:
        jax.devices = real
    return runner, best


def test_research_runner_equals_jax_and_resumes(tmp_path, jax_research, monkeypatch):
    want, want_best = jax_research
    runner = trunner.ResearchRunner(MOT17, "bytetrack", seed=0, work_dir=tmp_path, device="cpu")
    stages = []
    runner.phase_callback = lambda stage, done, total: stages.append((stage, done, total))
    best = runner.run(n_candidates=3)
    assert runner.baseline["params"] == want.baseline["params"]
    for k, v in PINNED[("mot17_mini", "bytetrack")].items():
        assert abs(runner.baseline["metrics"][k] - v) <= ATOL
    assert [h["params"] for h in runner.history] == [h["params"] for h in want.history]
    assert [h["error"] for h in runner.history] == [h["error"] for h in want.history]
    for got, ref in zip([runner.baseline, *runner.history], [want.baseline, *want.history]):
        for k in METRICS:
            assert abs(got["metrics"][k] - ref["metrics"][k]) <= ATOL, (k, got, ref)
    assert best["params"] == want_best["params"]
    assert stages[0] == ("baseline", 0, 0) and stages[-1] == ("candidates", 3, 3)

    again = trunner.ResearchRunner(MOT17, "bytetrack", work_dir=tmp_path, device="cpu")
    monkeypatch.setattr(again, "_evaluate", lambda params: pytest.fail("a candidate ran on resume"))
    assert len(again.history) == 3 and again.run(n_candidates=3)["score"] == best["score"]


def test_preflight_builds_on_the_device_and_rejects_garbage():
    runner = trunner.ResearchRunner(MOT17, "bytetrack", device="cpu")
    runner.preflight({"track_thresh": 0.5})
    with pytest.raises(Exception):
        runner.preflight({"track_thresh": "garbage"})
    cpp = trunner.ResearchRunner(MOT17, "bytetrack:cpp", device="cpu")
    assert cpp.specs == runner.specs
    cpp.preflight({"track_thresh": 0.5})


def test_objectives_equal_jax_on_a_grid():
    base = {"HOTA": 0.6, "IDF1": 0.55, "MOTA": 0.5}
    configs = [({}, {}), ({"hota_tolerance": 0.01, "idf1_penalty": 2.0},
                         {"hota_tolerance": 0.01, "idf1_penalty": 2.0})]
    for h in np.linspace(0.4, 0.8, 5):
        for i in np.linspace(0.4, 0.7, 4):
            for m in np.linspace(0.3, 0.7, 3):
                metrics = {"HOTA": float(h), "IDF1": float(i), "MOTA": float(m)}
                assert trunner.default_objective(metrics, base) == \
                    jrunner.default_objective(metrics, base)
                for tkw, jkw in configs:
                    assert trunner.PenaltyConfig(**tkw).score(metrics, base) == \
                        jrunner.PenaltyConfig(**jkw).score(metrics, base)


def test_mutation_proposer_equals_jax():
    from boxmot_tpu.configs import load_tracker_config as jload
    from boxmot_tpu_torch.configs import load_tracker_config

    for name in ("bytetrack", "occluboost"):
        specs = load_tracker_config(name)
        assert specs == jload(name)
        tprop, jprop = trunner.mutation_proposer(specs), jrunner.mutation_proposer(specs)
        trng, jrng = np.random.default_rng(4), np.random.default_rng(4)
        history = []
        for i in range(6):
            got, want = tprop(history, trng), jprop(history, jrng)
            assert got == want
            history.append({"params": got, "score": float(i % 3), "error": None})


def test_candidate_text_helpers_equal_jax():
    """The same source and seed give JAX's candidates, summaries and errors."""
    texts = {PORT_BYTETRACK: (REPO / PORT_BYTETRACK).read_text(),
             "boxmot_tpu/trackers/bytetrack.py": (REPO / "boxmot_tpu/trackers/bytetrack.py").read_text(),
             "cfg.yaml": "a: 1\n"}
    tprop, jprop = tcand.ast_mutation_proposer(), jcand.ast_mutation_proposer()
    trng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    changed = 0
    for _ in range(8):
        got, want = tprop(texts, None, trng), jprop(texts, None, jrng)
        assert got == want
        assert tcand.validate_candidate(got) == jcand.validate_candidate(want) == []
        assert tcand.change_summary(texts, got) == jcand.change_summary(texts, want)
        changed += bool(tcand.change_summary(texts, got))
    assert changed >= 5
    for bad in ({"a.py": "def broken(:\n"}, {"c.yaml": "a: [1,"}, {"a.py": "x = 1\n"}):
        assert tcand.validate_candidate(bad) == jcand.validate_candidate(bad)
    assert tcand.normalize_editable_files("bytetrack") == (PORT_BYTETRACK,)
    assert tcand.normalize_editable_files("ocsort:cpp") == ("boxmot_tpu_torch/trackers/ocsort.py",)
    assert tcand.normalize_editable_files("x", [REPO / PORT_BYTETRACK, PORT_BYTETRACK]) == \
        (PORT_BYTETRACK,)
    with pytest.raises(FileNotFoundError):
        tcand.normalize_editable_files("not_a_tracker")
    with pytest.raises(ValueError, match="unknown proposer"):
        tcand.create_proposer("gpt")


def _llm_server(transform):
    """An OpenAI-compatible /chat/completions stub on localhost: ``transform``
    maps the user message (the fenced sources) to the reply."""

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            req = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
            user = next(m["content"] for m in req["messages"] if m["role"] == "user")
            body = json.dumps({"choices": [{"message": {"role": "assistant",
                                                        "content": transform(user)}}]}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _edit(user):
    src = re.search(r"```file=" + re.escape(PORT_BYTETRACK) + r"\n(.*?)```", user, re.S).group(1)
    return f"A narrower gate.\n```file={PORT_BYTETRACK}\n" + \
        src.replace("match_thresh: float = 0.8\n", "match_thresh: float = 0.85\n") + "```"


def test_llm_proposer_against_a_scripted_endpoint(monkeypatch):
    seed = tcand.read_candidate((PORT_BYTETRACK,))
    monkeypatch.delenv("BOXMOT_LLM_ENDPOINT", raising=False)
    with pytest.raises(ValueError, match="needs an endpoint"):
        tcand.create_proposer("llm")
    for transform, changed in ((_edit, True), (lambda user: "no edits", False),
                               (lambda user: f"```file={PORT_BYTETRACK}\ndef broken(:\n```", False)):
        srv = _llm_server(transform)
        try:
            url = f"http://127.0.0.1:{srv.server_port}/v1/chat/completions"
            got = tcand.create_proposer("llm", endpoint=url)(seed, None, np.random.default_rng(0))
            want = jcand.create_proposer("llm", endpoint=url)(seed, None, np.random.default_rng(0))
        finally:
            srv.shutdown()
        assert got == want and (got != seed) == changed
    assert "match_thresh: float = 0.85" in _edit("```file=" + PORT_BYTETRACK + "\n"
                                                 + seed[PORT_BYTETRACK] + "```")


def test_source_workspace_preflight_contains_a_broken_candidate(tmp_path, monkeypatch):
    from boxmot_tpu_torch.csrc import build

    kernels = tmp_path / "kernels"
    kernels.mkdir()
    (kernels / "iou_cost-0123456789abcdef.so").write_bytes(b"lib")
    monkeypatch.setattr(build, "BUILD_DIR", kernels)
    ws = tcand.SourceWorkspace(tmp_path / "run")
    try:
        assert (ws.workspace / "build" / "torch_kernels" / "iou_cost-0123456789abcdef.so"
                ).read_bytes() == b"lib"
        assert not (ws.workspace / "boxmot_tpu").exists()
        seed = tcand.read_candidate((PORT_BYTETRACK,))
        ws.write_candidate(seed)
        assert ws.preflight("bytetrack", device="cpu") == {
            "ok": True, "mode": "preflight", "device": "cpu", "built": []}
        ws.write_candidate({PORT_BYTETRACK: seed[PORT_BYTETRACK] + "\nraise RuntimeError('boom')\n"})
        res = ws.preflight("bytetrack", device="cpu")
        assert not res["ok"] and "boom" in res["error"] and res["device"] == "cpu"
        lines = (tmp_path / "run" / "children.jsonl").read_text().splitlines()
        assert [json.loads(line)["ok"] for line in lines] == [True, False]
    finally:
        ws.cleanup()
    assert not ws.workspace.exists()


def test_source_research_runner_on_the_cpu(tmp_path):
    runner = trunner.SourceResearchRunner(MOT17, "bytetrack", work_dir=tmp_path, seed=0,
                                          device="cpu")
    try:
        summary = runner.run(n_candidates=2)
    finally:
        runner.workspace.cleanup()
    assert summary["n_evaluated"] == 2 and type(summary).__name__ == "ResearchResult"
    for k, v in PINNED[("mot17_mini", "bytetrack")].items():
        assert abs(runner.baseline["metrics"][k] - v) <= ATOL
    for h in runner.history:
        assert h["error"] is None, h
        assert set(h["metrics"]) == set(METRICS) and np.isfinite(h["score"])
        assert abs(h["score"] - (h["metrics"]["HOTA"] - h["breakdown"]["total_penalty"])) < 1e-12
    children = [json.loads(line) for line in (tmp_path / "children.jsonl").read_text().splitlines()]
    assert len(children) == 6 and {c["device"] for c in children} == {"cpu"}
    assert json.loads((tmp_path / "source_research.json").read_text())["baseline"] == runner.baseline


def test_research_child_leaves_jax_out(tmp_path):
    """The sandbox's child script, run as the runner runs it, evaluates the
    port's ByteTrack to the pins with no module of JAX or the JAX package."""
    ws = tcand.SourceWorkspace(tmp_path)
    try:
        manifest = tmp_path / "m.json"
        manifest.write_text(json.dumps({"mode": "eval", "tracker": "bytetrack", "params": None,
                                        "data_root": str(MOT17), "eval_kwargs": {},
                                        "device": "cpu", "workspace": str(ws.workspace)}))
        code = ("import runpy, sys, json\n"
                f"sys.argv = ['child', {str(manifest)!r}]\n"
                f"runpy.run_path({str(ws._script)!r}, run_name='__main__')\n"
                f"print(json.dumps({FORBIDDEN}))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                             text=True, timeout=300)
    finally:
        ws.cleanup()
    assert out.returncode == 0, out.stderr
    payload, bad = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert bad == [] and payload["ok"] and payload["device"] == "cpu"
    for k, v in PINNED[("mot17_mini", "bytetrack")].items():
        assert abs(payload["metrics"][k] - v) <= ATOL


def _lines(output: str) -> list[str]:
    return [line for line in output.splitlines()
            if line.startswith(("best score", "  ")) and "INFO" not in line]


def test_cli_research_prints_what_the_jax_cli_prints(tmp_path, jax_research):
    from boxmot_tpu.engine.cli import cli as jcli
    from boxmot_tpu_torch.engine.cli import cli

    args = ["research", "--data", str(MOT17), "--n-candidates", "3", "--seed", "0"]
    port = CliRunner().invoke(cli, [*args, "--work-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert port.exit_code == 0, port.output
    want = CliRunner().invoke(jcli, [*args, "--work-dir", str(tmp_path / "jax")])
    assert want.exit_code == 0, want.output
    assert _lines(port.output) == _lines(want.output) and len(_lines(port.output)) == 6


def test_cli_research_edit_source_end_to_end(tmp_path):
    from boxmot_tpu_torch.engine.cli import cli

    res = CliRunner().invoke(cli, ["research", "--data", str(MOT17), "--edit-source",
                                   "--n-candidates", "1", "--work-dir", str(tmp_path),
                                   "--device", "cpu"], standalone_mode=False)
    assert res.exception is None, res.output
    summary = res.return_value
    assert summary["n_evaluated"] == 1 and "evaluated 1 source candidates" in res.output
    assert not list(tmp_path.glob("workspace_*"))
    assert {json.loads(line)["device"] for line in
            (tmp_path / "children.jsonl").read_text().splitlines()} == {"cpu"}


def test_boxmot_research_equals_jax(tmp_path, jax_research):
    from boxmot_tpu.api import Boxmot as JBoxmot
    from boxmot_tpu_torch.api import Boxmot

    got = Boxmot(tracker="bytetrack", device="cpu").research(data=MOT17, n_candidates=3,
                                                            work_dir=tmp_path / "port")
    want = JBoxmot(tracker="bytetrack").research(data=MOT17, n_candidates=3,
                                                 work_dir=tmp_path / "jax")
    assert got["params"] == want["params"] == jax_research[1]["params"]
    for k in METRICS:
        assert abs(got["metrics"][k] - want["metrics"][k]) <= ATOL
