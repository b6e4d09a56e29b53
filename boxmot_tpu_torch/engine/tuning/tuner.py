"""Tracker hyperparameter tuning over cached replays, on the card
(counterpart of ``boxmot_tpu/engine/tuning/tuner.py``).

Each trial is one ``run_eval`` on ``device``: a replay of the benchmark's
cached detections through the port's tracker step, scored by the metric
stack.  Trials run in suggestion-ordered batches of ``n_workers`` threads,
as in the JAX tuner: the suggestions are drawn serially, the batch's evals
run concurrently, and the records are kept in suggestion order, so
trials.json, resume and the best trial are those of a serial run of the
same suggestions.  On the card the trials share the default stream, so the
device work of a batch runs one kernel after another while the host work of
its trials (dispatch, the metric stack) overlaps; the kernels' launch and
build are safe across threads (``csrc/build.py``), and so is the replay's
one device-to-host copy (``engine/replay.py::sync_allowed``).  A
``name:cpp`` tracker tunes over the native cores on the host.

The search space comes from the tracker's YAML specs (uniform,
loguniform, qrandint, choice, grid_search), the strategy from
``backends.py`` (``random``, ``grid`` or ``tpe``); trial history persists
to ``trials.json``, so runs resume.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from boxmot_tpu_torch.configs import flatten_config, flatten_specs, load_tracker_config
from boxmot_tpu_torch.engine.results import TuneResult, TuneTrialResult
from boxmot_tpu_torch.engine.tuning.backends import create_backend, sample_param
from boxmot_tpu_torch.trackers.zoo import parse_tracker_spec


def sample_config(specs: dict, rng: np.random.Generator) -> dict:
    return {k: sample_param(v, rng) for k, v in specs.items()}


def default_objective(metrics: dict) -> float:
    """HOTA primary with MOTA and IDF1 support."""
    return float(metrics["HOTA"] + 0.5 * metrics["MOTA"] + 0.5 * metrics["IDF1"])


class Tuner:
    def __init__(
        self,
        data_root: Path,
        tracker_type: str,
        base_params: dict | None = None,
        search_space: dict | None = None,
        objective=default_objective,
        work_dir: Path | None = None,
        seed: int = 0,
        eval_kwargs: dict | None = None,
        backend: str = "random",
        backend_kwargs: dict | None = None,
        trial_callback=None,
        device="cuda",
    ):
        self.data_root = Path(data_root)
        self.tracker_type = tracker_type
        self.device = device
        self.base_params = dict(base_params or {})
        # "name:cpp" tunes over the native cores; the search space comes
        # from the plain tracker name
        base_name, _ = parse_tracker_spec(tracker_type)
        self.specs = flatten_specs(search_space or load_tracker_config(base_name))
        self.objective = objective
        self.work_dir = Path(work_dir) if work_dir else None
        self.rng = np.random.default_rng(seed)
        self.eval_kwargs = dict(eval_kwargs or {})
        self.backend = create_backend(backend, self.specs, seed=seed, **(backend_kwargs or {}))
        self.trial_callback = trial_callback
        self.trials: list[dict] = []
        if self.work_dir:
            self.work_dir.mkdir(parents=True, exist_ok=True)
            log = self.work_dir / "trials.json"
            if log.exists():
                self.trials = json.loads(log.read_text())

    def _save(self):
        if self.work_dir:
            (self.work_dir / "trials.json").write_text(json.dumps(self.trials, indent=1))

    def _evaluate(self, params: dict) -> dict:
        from boxmot_tpu_torch.engine.eval import run_eval

        res = run_eval(
            self.data_root,
            self.tracker_type,
            device=self.device,
            tracker_params={**self.base_params, **params},
            **self.eval_kwargs,
        )
        c = res["combined"]
        return {"HOTA": float(c["HOTA"]), "MOTA": float(c["MOTA"]), "IDF1": float(c["IDF1"])}

    def _measure(self, params: dict) -> dict:
        """Evaluate one config; returns an unindexed trial record.  Safe to
        call from several threads at once."""
        t0 = time.perf_counter()
        try:
            metrics = self._evaluate(params)
            score = self.objective(metrics)
            error = None
        except Exception as exc:  # a failed trial is recorded, not fatal
            metrics, score, error = {}, float("-inf"), str(exc)
        return {
            "params": params,
            "metrics": metrics,
            "score": score,
            "error": error,
            "seconds": round(time.perf_counter() - t0, 2),
        }

    def _record(self, rec: dict) -> None:
        rec["index"] = len(self.trials)
        self.trials.append(rec)
        self._save()
        if self.trial_callback is not None:
            self.trial_callback(rec)

    def _run_trial(self, params: dict) -> None:
        self._record(self._measure(params))

    def _suggest_batch(self, want: int, done: set) -> list[dict]:
        """Draw up to ``want`` fresh configs from the backend, serially on the
        caller's thread (adaptive backends see the history up to the previous
        batch)."""
        batch, stalls = [], 0
        while len(batch) < want and stalls < 50:
            params = self.backend.suggest(self.trials)
            if params is None:  # grid exhausted
                break
            key = json.dumps(params, sort_keys=True)
            if key in done:
                # duplicate suggestion from a stochastic backend: skip it
                # but guarantee progress with a fresh random draw
                params = sample_config(self.specs, self.rng)
                key = json.dumps(params, sort_keys=True)
                if key in done:
                    stalls += 1  # small discrete space may be exhausted
                    continue
            stalls = 0
            done.add(key)
            batch.append(params)
        return batch

    def fit(self, n_trials: int = 20, include_default: bool = True, n_workers: int = 1) -> dict:
        """Run trials (resuming any persisted history); returns the best.

        ``n_workers > 1`` evaluates each batch of suggestions in a thread
        pool and records the results in suggestion order.
        """
        done = {json.dumps(t["params"], sort_keys=True) for t in self.trials}
        if include_default and not self.trials:
            defaults = flatten_config(self.specs)
            self._run_trial(defaults)
            done.add(json.dumps(defaults, sort_keys=True))

        n_workers = max(int(n_workers), 1)
        while len(self.trials) < n_trials:
            want = min(n_workers, n_trials - len(self.trials))
            batch = self._suggest_batch(want, done)
            if not batch:
                break
            if len(batch) == 1:
                self._run_trial(batch[0])
            else:
                with ThreadPoolExecutor(max_workers=len(batch)) as pool:
                    recs = list(pool.map(self._measure, batch))
                for rec in recs:  # suggestion order, deterministic
                    self._record(rec)
        return self.best()

    def best(self) -> TuneResult:
        ok = [t for t in self.trials if t.get("error") is None]
        if not ok:
            raise RuntimeError("no successful trials")
        return TuneResult(max(ok, key=lambda t: t["score"]))

    def trial_results(self) -> list:
        """Typed per-trial results."""
        return [TuneTrialResult(t) for t in self.trials]


def run_tune(
    data_root,
    tracker_type: str = "bytetrack",
    n_trials: int = 20,
    work_dir=None,
    seed: int = 0,
    base_params: dict | None = None,
    eval_kwargs: dict | None = None,
    backend: str = "random",
    trial_callback=None,
    n_workers: int = 1,
    device="cuda",
) -> dict:
    """Tune ``tracker_type`` on ``device`` and return the best trial; with a
    ``work_dir``, also write ``best.yaml`` there."""
    tuner = Tuner(
        data_root,
        tracker_type,
        base_params=base_params,
        work_dir=work_dir,
        seed=seed,
        eval_kwargs=eval_kwargs,
        backend=backend,
        trial_callback=trial_callback,
        device=device,
    )
    best = tuner.fit(n_trials=n_trials, n_workers=n_workers)
    if work_dir:
        import yaml

        (Path(work_dir) / "best.yaml").write_text(yaml.safe_dump(best["params"]))
    return best
