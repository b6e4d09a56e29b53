"""Research loop: propose -> preflight -> evaluate -> score, on the card
(counterpart of ``boxmot_tpu/engine/research/runner.py``).

``ResearchRunner`` asks a proposal function for tracker configurations
(``propose_fn(history, rng) -> params``; by default ``mutation_proposer``,
which perturbs a few parameters of the best candidate within the tracker's
search space), preflights each (the tracker must build on ``device`` and
take a probe frame), evaluates it with ``run_eval`` on ``device`` and
scores it against the baseline with a penalty-aware objective over
HOTA/IDF1/MOTA.  ``SourceResearchRunner`` does the same over candidates of
tracker *source* (``candidates.py``), each preflighted and evaluated in a
child process from a sandboxed copy of the package, on ``device`` too.
Both accept ``name:cpp`` trackers, whose search space is the plain name's.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from boxmot_tpu_torch.configs import flatten_config, load_tracker_config
from boxmot_tpu_torch.engine.results import ResearchResult
from boxmot_tpu_torch.engine.tuning.tuner import sample_param
from boxmot_tpu_torch.trackers.zoo import parse_tracker_spec


def default_objective(metrics: dict, baseline: dict) -> float:
    """Reward HOTA gains; penalize IDF1/MOTA regressions harder than they
    reward."""
    d_hota = metrics["HOTA"] - baseline["HOTA"]
    d_idf1 = metrics["IDF1"] - baseline["IDF1"]
    d_mota = metrics["MOTA"] - baseline["MOTA"]
    penalty = 0.5 * max(0.0, -d_idf1) + 0.5 * max(0.0, -d_mota)
    return float(d_hota + 0.25 * d_idf1 + 0.25 * d_mota - penalty)


def mutation_proposer(specs: dict, scale: float = 0.25):
    """Default proposer: perturb a few params of the best candidate."""

    def propose(history: list[dict], rng: np.random.Generator) -> dict:
        base = flatten_config(specs)
        ok = [h for h in history if h.get("error") is None]
        if ok:
            base = dict(max(ok, key=lambda h: h["score"])["params"])
        params = dict(base)
        keys = list(specs)
        n_mut = max(1, int(rng.integers(1, max(2, len(keys) // 2))))
        for key in rng.choice(keys, size=min(n_mut, len(keys)), replace=False):
            spec = specs[key]
            if spec.get("type") in ("uniform", "loguniform") and rng.uniform() < 0.7:
                lo, hi = spec["range"]
                cur = float(params.get(key, spec["default"]))
                step = (hi - lo) * scale * rng.normal()
                params[key] = float(np.clip(cur + step, lo, hi))
            else:
                params[key] = sample_param(spec, rng)
        return params

    return propose


class ResearchRunner:
    def __init__(
        self,
        data_root: Path,
        tracker_type: str,
        propose_fn=None,
        objective=default_objective,
        work_dir: Path | None = None,
        seed: int = 0,
        eval_kwargs: dict | None = None,
        device="cuda",
    ):
        self.data_root = Path(data_root)
        self.tracker_type = tracker_type
        self.device = device
        base_name, _ = parse_tracker_spec(tracker_type)
        self.specs = load_tracker_config(base_name)
        self.propose_fn = propose_fn or mutation_proposer(self.specs)
        self.objective = objective
        self.work_dir = Path(work_dir) if work_dir else None
        self.rng = np.random.default_rng(seed)
        self.eval_kwargs = dict(eval_kwargs or {})
        self.phase_callback = None  # optional: phase_callback(stage, done, total)
        self.history: list[dict] = []
        self.baseline: dict | None = None
        if self.work_dir:
            self.work_dir.mkdir(parents=True, exist_ok=True)
            log = self.work_dir / "research.json"
            if log.exists():
                state = json.loads(log.read_text())
                self.history = state["history"]
                self.baseline = state["baseline"]

    def _save(self):
        if self.work_dir:
            (self.work_dir / "research.json").write_text(
                json.dumps({"history": self.history, "baseline": self.baseline}, indent=1)
            )

    def preflight(self, params: dict) -> None:
        """The candidate must build on the device and take a probe frame."""
        from boxmot_tpu_torch.trackers.zoo import create_tracker

        trk = create_tracker(self.tracker_type, device=self.device, tracker_config=params)
        probe = np.array([[10, 10, 60, 100, 0.9, 0.0]], np.float32)
        img = np.zeros((64, 64, 3), np.uint8)
        trk.update(probe, img)

    def _evaluate(self, params: dict) -> dict:
        from boxmot_tpu_torch.engine.eval import run_eval

        res = run_eval(self.data_root, self.tracker_type, device=self.device,
                       tracker_params=params, **self.eval_kwargs)
        c = res["combined"]
        return {"HOTA": float(c["HOTA"]), "MOTA": float(c["MOTA"]), "IDF1": float(c["IDF1"])}

    def _phase(self, stage: str, done: int = 0, total: int = 0) -> None:
        if self.phase_callback is not None:
            self.phase_callback(stage, done, total)

    def run(self, n_candidates: int = 10) -> dict:
        if self.baseline is None:
            self._phase("baseline")
            base_params = flatten_config(self.specs)
            self.baseline = {"params": base_params, "metrics": self._evaluate(base_params)}
            self._save()
        self._phase("candidates", len(self.history), n_candidates)
        while len(self.history) < n_candidates:
            params = self.propose_fn(self.history, self.rng)
            t0 = time.perf_counter()
            try:
                self.preflight(params)
                metrics = self._evaluate(params)
                score = self.objective(metrics, self.baseline["metrics"])
                error = None
            except Exception as exc:
                metrics, score, error = {}, float("-inf"), str(exc)
            self.history.append({
                "params": params,
                "metrics": metrics,
                "score": score,
                "error": error,
                "seconds": round(time.perf_counter() - t0, 2),
            })
            self._save()
            self._phase("candidates", len(self.history), n_candidates)
        return self.best()

    def best(self) -> dict:
        ok = [h for h in self.history if h.get("error") is None]
        candidates = ok + [
            {"params": self.baseline["params"], "metrics": self.baseline["metrics"], "score": 0.0}
        ]
        return max(candidates, key=lambda h: h["score"])


class PenaltyConfig:
    """Regression-penalty scoring weights."""

    def __init__(
        self,
        hota_tolerance=0.0, idf1_tolerance=0.0, mota_tolerance=0.0,
        hota_penalty=1.0, idf1_penalty=0.5, mota_penalty=0.5,
    ):
        self.hota_tolerance = hota_tolerance
        self.idf1_tolerance = idf1_tolerance
        self.mota_tolerance = mota_tolerance
        self.hota_penalty = hota_penalty
        self.idf1_penalty = idf1_penalty
        self.mota_penalty = mota_penalty

    def score(self, metrics: dict, baseline: dict) -> tuple[float, dict]:
        hota = float(metrics.get("HOTA", 0.0))
        reg = {
            k: max(
                0.0,
                float(baseline.get(k, 0.0)) - float(metrics.get(k, 0.0))
                - getattr(self, f"{k.lower()}_tolerance"),
            )
            for k in ("HOTA", "IDF1", "MOTA")
        }
        total = sum(
            reg[k] * getattr(self, f"{k.lower()}_penalty")
            for k in ("HOTA", "IDF1", "MOTA")
        )
        return hota - total, {"regressions": reg, "total_penalty": total}


class SourceResearchRunner:
    """Research over *source-code* candidates: {file: text} mappings over the
    editable tracker files, proposed by a pluggable function (offline
    default: AST literal mutation), preflighted and evaluated on ``device``
    in a child process of a sandboxed workspace, scored with regression
    penalties against the baseline.
    """

    def __init__(
        self,
        data_root,
        tracker_type: str,
        editable_files=None,
        proposal_fn=None,
        work_dir=None,
        seed: int = 0,
        eval_kwargs: dict | None = None,
        penalties: PenaltyConfig | None = None,
        device="cuda",
    ):
        from boxmot_tpu_torch.engine.research.candidates import (
            SourceWorkspace,
            ast_mutation_proposer,
            normalize_editable_files,
            read_candidate,
        )

        self.data_root = Path(data_root)
        self.tracker_type = tracker_type
        self.device = device
        self.editable_files = normalize_editable_files(tracker_type, editable_files)
        self.seed_candidate = read_candidate(self.editable_files)
        self.proposal_fn = proposal_fn or ast_mutation_proposer()
        self.work_dir = Path(work_dir) if work_dir else Path("research_results")
        self.rng = np.random.default_rng(seed)
        self.eval_kwargs = dict(eval_kwargs or {})
        self.penalties = penalties or PenaltyConfig()
        self.workspace = SourceWorkspace(self.work_dir)
        self.phase_callback = None  # optional: phase_callback(stage, done, total)
        self.history: list[dict] = []
        self.baseline: dict | None = None
        log = self.work_dir / "source_research.json"
        if log.exists():
            state = json.loads(log.read_text())
            self.history = state["history"]
            self.baseline = state["baseline"]

    def _save(self):
        (self.work_dir / "source_research.json").write_text(
            json.dumps({"history": self.history, "baseline": self.baseline}, indent=1)
        )

    def _eval_candidate(self, candidate: dict[str, str], tag: str) -> dict:
        from boxmot_tpu_torch.engine.research.candidates import validate_candidate

        errors = validate_candidate(candidate)
        if errors:
            return {"ok": False, "error": "; ".join(errors), "stage": "validate"}
        self.workspace.write_candidate(candidate)
        pre = self.workspace.preflight(self.tracker_type, device=self.device)
        if not pre.get("ok"):
            return {"ok": False, "error": pre.get("error"), "stage": "preflight"}
        res = self.workspace.evaluate(self.tracker_type, self.data_root,
                                      eval_kwargs=self.eval_kwargs, device=self.device)
        if not res.get("ok"):
            return {"ok": False, "error": res.get("error"), "stage": "eval"}
        return {"ok": True, "metrics": res["metrics"]}

    def run(self, n_candidates: int = 8) -> dict:
        from boxmot_tpu_torch.engine.research.candidates import change_summary

        if self.baseline is None:
            if self.phase_callback is not None:
                self.phase_callback("baseline", 0, 0)
            base = self._eval_candidate(self.seed_candidate, "baseline")
            if not base.get("ok"):
                raise RuntimeError(f"baseline evaluation failed: {base.get('error')}")
            self.baseline = {"metrics": base["metrics"]}
            self._save()
        best_candidate = dict(self.seed_candidate)
        if self.phase_callback is not None:
            self.phase_callback("candidates", len(self.history), n_candidates)
        while len(self.history) < n_candidates:
            feedback = [
                {
                    "score": h["score"],
                    "changes": h["changes"],
                    "error": h["error"],
                    "metrics": h.get("metrics", {}),
                }
                for h in self.history
            ]
            candidate = self.proposal_fn(best_candidate, feedback, self.rng)
            t0 = time.perf_counter()
            tag = f"candidate_{len(self.history):03d}"
            result = self._eval_candidate(candidate, tag)
            if result.get("ok"):
                score, breakdown = self.penalties.score(result["metrics"], self.baseline["metrics"])
                entry = {
                    "tag": tag,
                    "changes": change_summary(self.seed_candidate, candidate),
                    "metrics": result["metrics"],
                    "score": score,
                    "breakdown": breakdown,
                    "error": None,
                }
                prev_best = max(
                    (h["score"] for h in self.history if h["error"] is None),
                    default=float("-inf"),
                )
                if score > max(prev_best, 0.0):
                    best_candidate = dict(candidate)
                    self.workspace.save_snapshot(candidate, "best_candidate")
            else:
                entry = {
                    "tag": tag,
                    "changes": change_summary(self.seed_candidate, candidate),
                    "metrics": {},
                    "score": float("-inf"),
                    "error": f"[{result.get('stage')}] {result.get('error')}",
                }
            entry["seconds"] = round(time.perf_counter() - t0, 2)
            self.history.append(entry)
            self._save()
            if self.phase_callback is not None:
                self.phase_callback("candidates", len(self.history), n_candidates)
        ok = [h for h in self.history if h["error"] is None]
        best = max(ok, key=lambda h: h["score"]) if ok else None
        return ResearchResult(
            baseline=self.baseline,
            best=best,
            n_evaluated=len(self.history),
            n_failed=len(self.history) - len(ok),
        )


def run_research(
    data_root,
    tracker_type: str = "bytetrack",
    n_candidates: int = 10,
    work_dir=None,
    seed: int = 0,
    propose_fn=None,
    eval_kwargs: dict | None = None,
    device="cuda",
) -> dict:
    runner = ResearchRunner(
        data_root,
        tracker_type,
        propose_fn=propose_fn,
        work_dir=work_dir,
        seed=seed,
        eval_kwargs=eval_kwargs,
        device=device,
    )
    return runner.run(n_candidates=n_candidates)
