"""Source-code candidates for the research loop, run on the card
(counterpart of ``boxmot_tpu/engine/research/candidates.py``).

A candidate is a mapping {repo-relative file path: full source text} over a
set of *editable files* (by default the port's step module of the tracker,
``boxmot_tpu_torch/trackers/<name>.py``).  Candidates are

1. *validated*  -- every .py must byte-compile, every .yaml must parse;
2. *preflighted* -- loaded in a child process from a workspace copy of the
   port's package, where the tracker must build on the device and take a
   probe frame (nothing a broken candidate does can corrupt the parent);
3. *evaluated*  -- same sandbox, a full ``run_eval``, one JSON line back.

The child runs on ``device`` (the card unless the caller asks for the
CPU) and imports nothing of JAX or of the JAX package.  Each child is a new
process with its own CUDA context, started with ``subprocess.run`` (never
forked from a parent that has touched CUDA).  The workspace's
``build/torch_kernels/`` is seeded with the parent checkout's kernel
libraries, which are keyed by a hash of their source, so a child runs
``nvcc`` only for a kernel whose source a candidate edited.  Every child's
JSON line (ok, metrics or error, its device and the kernels it built) is
appended to ``children.jsonl`` in the run directory.

The proposers and the text helpers (``validate_candidate``,
``change_summary``, the AST literal mutator and the LLM proposer, which
reads its endpoint only from its arguments or the environment) are copies
of the JAX package's.
"""

from __future__ import annotations

import ast
import difflib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Protocol

import numpy as np
import yaml

from boxmot_tpu_torch.csrc import build as kernel_build
from boxmot_tpu_torch.trackers.zoo import parse_tracker_spec

PACKAGE_ROOT = Path(__file__).resolve().parents[3]  # repo root (contains boxmot_tpu_torch/)

_COPY_IGNORE = shutil.ignore_patterns("__pycache__", "*.pyc", ".git", "build")


# ---------------------------------------------------------------------------
# candidate basics
# ---------------------------------------------------------------------------


def normalize_editable_files(tracker: str, editable_files=None) -> tuple[str, ...]:
    """Default editable set: the tracker's step module (candidates.py:19-52)."""
    if editable_files:
        rels = []
        for f in editable_files:
            p = Path(f)
            if p.is_absolute():
                p = p.relative_to(PACKAGE_ROOT)
            if not (PACKAGE_ROOT / p).exists():
                raise FileNotFoundError(f"editable file not found: {p}")
            rels.append(p.as_posix())
        return tuple(dict.fromkeys(rels))
    base_name, _ = parse_tracker_spec(tracker)
    mod = PACKAGE_ROOT / "boxmot_tpu_torch" / "trackers" / f"{base_name.lower()}.py"
    if not mod.exists():
        raise FileNotFoundError(f"no tracker module for {tracker!r}: {mod}")
    return (mod.relative_to(PACKAGE_ROOT).as_posix(),)


def read_candidate(files) -> dict[str, str]:
    return {f: (PACKAGE_ROOT / f).read_text() for f in files}


def validate_candidate(candidate: dict[str, str]) -> list[str]:
    """Syntax-level validation; returns a list of error strings (empty = ok)."""
    errors = []
    for file_path, content in candidate.items():
        suffix = Path(file_path).suffix.lower()
        if suffix == ".py":
            try:
                compile(content, file_path, "exec")
            except SyntaxError as exc:
                errors.append(f"{file_path}: {exc.msg} (line {exc.lineno})")
        elif suffix in (".yaml", ".yml"):
            try:
                yaml.safe_load(content)
            except yaml.YAMLError as exc:
                errors.append(f"{file_path}: {exc}")
    return errors


def change_summary(seed: dict[str, str], candidate: dict[str, str]) -> list[dict]:
    out = []
    for path, text in candidate.items():
        base = seed.get(path, "")
        if text == base:
            continue
        added = removed = 0
        for line in difflib.unified_diff(base.splitlines(), text.splitlines(), lineterm=""):
            if line.startswith("+") and not line.startswith("+++"):
                added += 1
            elif line.startswith("-") and not line.startswith("---"):
                removed += 1
        out.append({"path": path, "added": added, "removed": removed})
    return out


# ---------------------------------------------------------------------------
# offline proposer: AST mutation of tunable literals
# ---------------------------------------------------------------------------


class _LiteralSites(ast.NodeVisitor):
    """Collect mutable literal sites: numeric / boolean defaults in function
    signatures and dataclass-style class-level assignments."""

    def __init__(self):
        self.sites = []  # (lineno, col, kind, value)

    def _add(self, node):
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float, bool)):
            self.sites.append(node)

    def visit_FunctionDef(self, node):
        for default in list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None
        ]:
            self._add(default)
        self.generic_visit(node)

    def visit_ClassDef(self, node):
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                self._add(stmt.value)
            elif isinstance(stmt, ast.Assign):
                self._add(stmt.value)
        self.generic_visit(node)


class Proposer(Protocol):
    """Source-candidate proposer contract (the role the reference GEPA
    loop fills with a reflection LM, boxmot/engine/research/runner.py:52,712).

    Called with the current-best candidate as ``{repo-relative path:
    source text}``, structured ``feedback`` about the last round (or
    None on the first call), and the loop's RNG; returns a new candidate
    mapping.  Returning the input unchanged is a legal no-op.  Syntax
    errors are survivable — the runner validates and records a failed
    trial — but well-behaved proposers validate before returning.
    """

    def __call__(
        self, candidate: dict[str, str], feedback, rng: np.random.Generator
    ) -> dict[str, str]: ...  # pragma: no cover - typing protocol


def create_proposer(spec: str = "ast", **kwargs) -> "Proposer":
    """Proposer registry: ``ast`` (offline literal mutation, the default)
    or ``llm`` (endpoint-backed reflection, reference runner.py:712)."""
    if spec == "ast":
        return ast_mutation_proposer(**kwargs)
    if spec == "llm":
        return llm_proposer(**kwargs)
    raise ValueError(f"unknown proposer {spec!r} (expected 'ast' or 'llm')")


def llm_proposer(
    endpoint: str | None = None,
    model: str | None = None,
    api_key: str | None = None,
    timeout: float = 120.0,
    max_retries: int = 2,
) -> "Proposer":
    """LLM-backed source proposer (the reference GEPA reflection step,
    boxmot/engine/research/runner.py:52,712).

    Speaks the OpenAI-compatible chat-completions JSON dialect over
    plain urllib (no SDK dependency).  Configuration falls back to env:
    ``BOXMOT_LLM_ENDPOINT`` (e.g. http://host:port/v1/chat/completions),
    ``BOXMOT_LLM_MODEL``, ``BOXMOT_LLM_API_KEY``.  The model receives
    the editable sources in fenced blocks plus the last round's scores/
    errors, and must reply with one fenced block per file it edits:

        ```file=boxmot_tpu_torch/trackers/bytetrack.py
        <full new file text>
        ```

    Files the reply does not mention stay unchanged; replies that parse
    to no valid edit (or fail syntax validation) leave the candidate
    unchanged, which the runner records as a no-op rather than crashing
    the loop.
    """
    import os

    endpoint = endpoint or os.environ.get("BOXMOT_LLM_ENDPOINT")
    model = model or os.environ.get("BOXMOT_LLM_MODEL", "gpt-4o-mini")
    api_key = api_key or os.environ.get("BOXMOT_LLM_API_KEY")
    if not endpoint:
        raise ValueError(
            "llm proposer needs an endpoint: pass endpoint= or set "
            "BOXMOT_LLM_ENDPOINT"
        )

    def _chat(messages: list[dict]) -> str:
        import json as _json
        import urllib.request

        body = _json.dumps(
            {"model": model, "messages": messages, "temperature": 0.7}
        ).encode()
        headers = {"Content-Type": "application/json"}
        if api_key:
            headers["Authorization"] = f"Bearer {api_key}"
        last_err = None
        for _ in range(max_retries + 1):
            try:
                req = urllib.request.Request(endpoint, data=body, headers=headers)
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    payload = _json.loads(resp.read().decode())
                return payload["choices"][0]["message"]["content"]
            except Exception as exc:  # noqa: BLE001 - network boundary
                last_err = exc
        raise RuntimeError(f"llm endpoint failed after retries: {last_err}")

    _FENCE = re.compile(
        r"```(?:[a-zA-Z0-9_+-]*[:=\s])?file[:=]?\s*(?P<path>[^\n`]+)\n"
        r"(?P<body>.*?)```",
        re.DOTALL,
    )
    # also accept the bare ```python:path/to/file.py dialect
    _FENCE_ALT = re.compile(
        r"```[a-zA-Z0-9_+-]*[:=](?P<path>[^\n`]+\.py)\n(?P<body>.*?)```",
        re.DOTALL,
    )

    def _parse_edits(reply: str, candidate: dict[str, str]) -> dict[str, str]:
        edits: dict[str, str] = {}
        for pat in (_FENCE, _FENCE_ALT):
            for m in pat.finditer(reply):
                path = m.group("path").strip()
                if path in candidate:
                    edits[path] = m.group("body")
        return edits

    def propose(candidate: dict[str, str], feedback, rng: np.random.Generator):
        files = "\n\n".join(
            f"```file={path}\n{text}```" for path, text in candidate.items()
        )
        fb = ""
        if feedback:
            fb = "\nLast round feedback (scores/errors):\n" + json.dumps(
                feedback, indent=1, default=str
            )
        messages = [
            {
                "role": "system",
                "content": (
                    "You are improving a multi-object tracker. Edit the "
                    "source files to raise HOTA without regressing IDF1/"
                    "MOTA. Reply with one fenced block per edited file, "
                    "opened as ```file=<repo-relative-path>, containing "
                    "the FULL new file text. Keep edits small and valid "
                    "Python."
                ),
            },
            {"role": "user", "content": files + fb},
        ]
        try:
            reply = _chat(messages)
        except RuntimeError:
            return dict(candidate)  # endpoint down: no-op round
        edits = _parse_edits(reply, candidate)
        if not edits:
            return dict(candidate)
        new = dict(candidate)
        new.update(edits)
        if validate_candidate({k: new[k] for k in edits}):
            return dict(candidate)  # syntactically broken reply: no-op
        return new

    return propose


def ast_mutation_proposer(scale: float = 0.3, max_sites: int = 3):
    """Offline source proposer: perturb tunable literals in the editable
    files (numeric defaults scaled, booleans flipped), preserving syntax by
    construction.  Mirrors the role of the reference's reflection LM with a
    deterministic, dependency-free mechanism."""

    def propose(candidate: dict[str, str], feedback, rng: np.random.Generator):
        new = dict(candidate)
        py_files = [f for f in candidate if f.endswith(".py")]
        if not py_files:
            return new
        target = py_files[int(rng.integers(len(py_files)))]
        src = candidate[target]
        tree = ast.parse(src)
        visitor = _LiteralSites()
        visitor.visit(tree)
        sites = [s for s in visitor.sites if not isinstance(s.value, bool) or True]
        if not sites:
            return new
        picks = rng.choice(
            len(sites), size=min(max_sites, len(sites)), replace=False
        )
        lines = src.splitlines(keepends=True)
        # Apply replacements right-to-left so column offsets stay valid.
        chosen = sorted(
            (sites[int(i)] for i in picks),
            key=lambda n: (n.lineno, n.col_offset),
            reverse=True,
        )
        for node in chosen:
            old_text = ast.get_source_segment(src, node)
            if old_text is None:
                continue
            value = node.value
            if isinstance(value, bool):
                new_text = str(not value)
            elif isinstance(value, int) and not isinstance(value, bool):
                step = max(1, int(round(abs(value) * scale)))
                new_text = str(max(0, value + int(rng.choice([-step, step]))))
            else:
                factor = float(np.exp(rng.normal(0.0, scale)))
                new_text = repr(round(value * factor, 6))
            row = node.lineno - 1
            line = lines[row]
            col = node.col_offset
            if line[col:col + len(old_text)] != old_text:
                continue  # multi-line or offset mismatch: skip conservatively
            lines[row] = line[:col] + new_text + line[col + len(old_text):]
        mutated = "".join(lines)
        if not validate_candidate({target: mutated}):
            new[target] = mutated
        return new

    return propose


# ---------------------------------------------------------------------------
# sandboxed execution
# ---------------------------------------------------------------------------

_CHILD_SCRIPT = r"""
import json, sys
manifest = json.load(open(sys.argv[1]))
sys.path.insert(0, manifest["workspace"])
import numpy as np
device = manifest.get("device", "cuda")
payload = {"ok": False}
try:
    if manifest["mode"] == "preflight":
        from boxmot_tpu_torch.trackers.zoo import create_tracker
        trk = create_tracker(manifest["tracker"], device=device,
                             tracker_config=manifest.get("params"))
        probe = np.array([[10, 10, 60, 100, 0.9, 0.0]], np.float32)
        img = np.zeros((64, 64, 3), np.uint8)
        for _ in range(3):
            trk.update(probe, img)
            probe = probe + 2.0 * np.array([1, 1, 1, 1, 0, 0], np.float32)
        payload = {"ok": True}
    else:
        from boxmot_tpu_torch.engine.eval import run_eval
        res = run_eval(
            manifest["data_root"], manifest["tracker"], device=device,
            tracker_params=manifest.get("params"),
            **manifest.get("eval_kwargs", {}),
        )
        c = res["combined"]
        payload = {"ok": True, "metrics": {
            "HOTA": float(c["HOTA"]), "MOTA": float(c["MOTA"]),
            "IDF1": float(c["IDF1"]),
        }}
except Exception as exc:  # noqa: BLE001 - sandbox boundary
    payload = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
from boxmot_tpu_torch.csrc.build import BUILD_LOG
payload.update(mode=manifest["mode"], device=device, built=sorted(BUILD_LOG))
print(json.dumps(payload))
"""


class SourceWorkspace:
    """Isolated copy of the boxmot_tpu_torch package that candidates are
    written into and run from, with the parent's kernel libraries."""

    def __init__(self, run_dir: Path):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.workspace = Path(tempfile.mkdtemp(prefix="workspace_", dir=str(self.run_dir)))
        shutil.copytree(
            PACKAGE_ROOT / "boxmot_tpu_torch",
            self.workspace / "boxmot_tpu_torch",
            ignore=_COPY_IGNORE,
        )
        # kernel libraries are keyed by a hash of their source: the
        # workspace's csrc/build.py finds the parent's, and rebuilds only a kernel
        # whose source a candidate changed
        kernels = self.workspace / kernel_build.BUILD_SUBDIR
        kernels.mkdir(parents=True)
        for lib in kernel_build.BUILD_DIR.glob("*.so"):
            shutil.copy2(lib, kernels / lib.name)
        self._script = self.workspace / "_research_child.py"
        self._script.write_text(_CHILD_SCRIPT)

    def write_candidate(self, candidate: dict[str, str]) -> None:
        for file_path, content in candidate.items():
            dst = self.workspace / file_path
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_text(content)

    def _run_child(self, manifest: dict, timeout: float) -> dict:
        mpath = self.workspace / "_manifest.json"
        manifest = dict(manifest, workspace=str(self.workspace))
        mpath.write_text(json.dumps(manifest))
        env = dict(os.environ)
        env.setdefault("BOXMOT_TPU_NO_NATIVE", "1")  # no cmake churn per child
        try:
            proc = subprocess.run(
                [sys.executable, str(self._script), str(mpath)],
                capture_output=True, text=True, timeout=timeout, env=env,
            )
        except subprocess.TimeoutExpired:
            return self._log({"ok": False, "error": f"timeout after {timeout}s"})
        for line in reversed(proc.stdout.strip().splitlines() or [""]):
            try:
                return self._log(json.loads(line))
            except json.JSONDecodeError:
                continue
        return self._log({
            "ok": False,
            "error": f"no JSON payload (rc={proc.returncode}): {proc.stderr[-500:]}",
        })

    def _log(self, payload: dict) -> dict:
        with open(self.run_dir / "children.jsonl", "a") as f:
            f.write(json.dumps(payload) + "\n")
        return payload

    def preflight(self, tracker: str, params=None, timeout: float = 300.0,
                  device="cuda") -> dict:
        return self._run_child(
            {"mode": "preflight", "tracker": tracker, "params": params, "device": str(device)},
            timeout,
        )

    def evaluate(self, tracker: str, data_root, params=None, eval_kwargs=None,
                 timeout: float = 1800.0, device="cuda") -> dict:
        return self._run_child(
            {
                "mode": "eval",
                "tracker": tracker,
                "params": params,
                "data_root": str(data_root),
                "eval_kwargs": eval_kwargs or {},
                "device": str(device),
            },
            timeout,
        )

    def save_snapshot(self, candidate: dict[str, str], name: str) -> Path:
        dst_dir = self.run_dir / name
        for file_path, content in candidate.items():
            dst = dst_dir / file_path
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_text(content)
        return dst_dir

    def cleanup(self) -> None:
        shutil.rmtree(self.workspace, ignore_errors=True)
