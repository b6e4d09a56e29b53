"""A copy of ``boxmot_tpu/engine/results.py``.

Typed workflow results (``ValidationResult``, ``GenerateResult``,
``TuneResult``, ``TuneTrialResult``, ``ExportResult``, ``TrackRunResult``,
``TrainResult``, ``ResearchResult``): dict subclasses with attribute
accessors and a summary (role mirror of the reference's
boxmot/engine/workflows/results.py:136-504).
"""

from __future__ import annotations


class WorkflowResult(dict):
    """dict-compatible base: result["key"] and result.key both work."""

    _fields: tuple[str, ...] = ()

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def summary(self) -> str:
        return ", ".join(f"{k}={self[k]}" for k in self._fields if k in self)


class ValidationResult(WorkflowResult):
    """Eval output: per_seq + combined metric dicts (results.py:136)."""

    _fields = ("combined",)

    @property
    def hota(self) -> float:
        return float(self["combined"]["HOTA"])

    @property
    def mota(self) -> float:
        return float(self["combined"]["MOTA"])

    @property
    def idf1(self) -> float:
        return float(self["combined"]["IDF1"])

    def summary(self) -> str:
        return (
            f"HOTA {100 * self.hota:.2f}  MOTA {100 * self.mota:.2f}  "
            f"IDF1 {100 * self.idf1:.2f}"
        )


class GenerateResult(WorkflowResult):
    """Cache-generation output: {seq: {dets, embs}} (results.py:26x)."""

    @property
    def total_dets(self) -> int:
        return sum(s["dets"] for s in self.values())

    @property
    def total_embs(self) -> int:
        return sum(s["embs"] for s in self.values())

    def summary(self) -> str:
        return (
            f"{self.total_dets} detections / {self.total_embs} embeddings "
            f"across {len(self)} sequences"
        )


class TuneResult(WorkflowResult):
    """Best tuning trial: params + metrics + score (results.py:3xx)."""

    _fields = ("score", "params")

    def summary(self) -> str:
        m = self.get("metrics", {})
        parts = [f"score {self.get('score', float('nan')):.4f}"]
        if "HOTA" in m:
            parts.append(f"HOTA {100 * m['HOTA']:.2f}")
        return "  ".join(parts)


class ExportResult(WorkflowResult):
    """{target: {path, max_dev?}} from run_export (results.py:4xx)."""

    def summary(self) -> str:
        return ", ".join(
            f"{t}->{info['path']}" for t, info in self.items()
        )


class TrackRunResult(WorkflowResult):
    """Live-tracking run: frames tracked + optional MOT txt path."""

    _fields = ("n_frames", "save_txt")

    @property
    def results(self):
        return self["results"]

    def __len__(self):
        return len(self["results"])


class TuneTrialResult(WorkflowResult):
    """One tuning trial: params + metrics + score (reference
    engine/workflows/results.py:232)."""

    _fields = ("index", "score")

    @property
    def config(self) -> dict:
        return self["params"]

    @property
    def ok(self) -> bool:
        return self.get("error") is None

    def summary(self) -> str:
        m = self.get("metrics", {})
        parts = [f"trial {self.get('index', '?')}",
                 f"score {self.get('score', float('nan')):.4f}"]
        if "HOTA" in m:
            parts.append(f"HOTA {100 * m['HOTA']:.2f}")
        if self.get("error"):
            parts.append(f"error: {self['error']}")
        return "  ".join(parts)


class TrainResult(WorkflowResult):
    """ReID training run: final metrics + checkpoint path + history
    (reference reid/training/trainer.py:77)."""

    _fields = ("steps", "final_loss", "weights_path")

    @property
    def history(self) -> list:
        return self["history"]

    def summary(self) -> str:
        return (
            f"{self.get('steps', 0)} steps  "
            f"final loss {self.get('final_loss', float('nan')):.4f}  "
            f"weights {self.get('weights_path')}"
        )


class ResearchResult(WorkflowResult):
    """Research-loop run: baseline + best candidate + counts (reference
    engine/research/models.py:118)."""

    _fields = ("n_evaluated", "n_failed")

    @property
    def best(self):
        return self.get("best")

    @property
    def baseline_summary(self) -> dict:
        return (self.get("baseline") or {}).get("metrics", {})

    @property
    def best_summary(self) -> dict:
        return (self.best or {}).get("metrics", {})

    @property
    def delta_summary(self) -> dict:
        base, best = self.baseline_summary, self.best_summary
        return {
            k: float(best[k]) - float(base[k])
            for k in best
            if k in base and isinstance(best[k], (int, float))
        }

    def summary(self) -> str:
        parts = [
            f"{self.get('n_evaluated', 0)} candidates "
            f"({self.get('n_failed', 0)} failed)"
        ]
        d = self.delta_summary
        if "HOTA" in d:
            parts.append(f"dHOTA {100 * d['HOTA']:+.2f}")
        return "  ".join(parts)
