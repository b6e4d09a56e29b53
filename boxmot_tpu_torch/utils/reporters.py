"""A copy of ``boxmot_tpu/utils/reporters.py``.

Per-mode workflow reporters over the :mod:`rich_ui` core.

Role mirror of the reference's rich workflow subsystem
(boxmot/utils/rich/reporters/{track,eval,generate,tune,export,
research}.py + workflow/{steps,fields,reporting}.py): every CLI mode
opens a live panel showing compact per-subsystem summary cards, the
pipeline step list, and progress bars; on completion it renders
mode-specific summary tables (metrics, trials, artifacts).

Everything degrades to plain log lines when ``rich`` is missing or
stdout is not a TTY (same policy as rich_ui), so headless runs and CI
never depend on terminal rendering.
"""

from __future__ import annotations

from .rich_ui import WorkflowProgress, rich_available, want_rich

# ── Atomic step labels (steps.py:20-32 role) ────────────────────────────

SETUP = "set up"
GENERATE = "generate caches"
TRACK = "run tracker"
POSTPROCESS = "postprocess"
EVALUATE = "evaluate"
OPTIMIZE = "optimize trials"
EXPORT = "export"
PREPARE = "prepare workspace"
BASELINE = "baseline eval"
PROPOSE = "propose + score candidates"
BEST = "best candidate"

TRACK_STEPS = [SETUP, TRACK]
GENERATE_STEPS = [SETUP, GENERATE]
EXPORT_STEPS = [SETUP, EXPORT]
TUNE_STEPS = [SETUP, OPTIMIZE]
RESEARCH_STEPS = [PREPARE, BASELINE, PROPOSE, BEST]


def eval_steps(*, postprocess: bool = False, generate: bool = False) -> list[str]:
    """Eval pipeline steps, optional stages included only when enabled
    (steps.py:59-67 role)."""
    labels = [SETUP]
    if generate:
        labels.append(GENERATE)
    labels.append(TRACK)
    if postprocess:
        labels.append(POSTPROCESS)
    labels.append(EVALUATE)
    return labels


# ── Field helpers (fields.py role) ──────────────────────────────────────


def compact_model_name(value) -> str:
    """Basename of a path-like model id, common weight suffixes stripped."""
    if isinstance(value, (list, tuple)):
        value = value[0] if value else ""
    name = str(value).replace("\\", "/").rstrip("/").rsplit("/", 1)[-1]
    for suffix in (".pt", ".pth", ".msgpack", ".tflite", ".npz"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def bool_glyph(value) -> str:
    return "✓" if bool(value) else "✗"


def card(title: str, items: list[tuple[str, object]]):
    """One summary card: drops None/empty values, keeps insertion order."""
    kept = [(k, v) for k, v in items if v not in (None, "", [], ())]
    return (title, kept) if kept else None


def _cards_renderable(cards: list):
    from rich.columns import Columns
    from rich.panel import Panel
    from rich.table import Table

    panels = []
    for title, items in cards:
        grid = Table.grid(padding=(0, 1))
        grid.add_column(style="cyan", no_wrap=True)
        grid.add_column(style="default")
        for k, v in items:
            grid.add_row(str(k), str(v))
        panels.append(Panel(grid, title=title, border_style="grey50"))
    return Columns(panels)


# ── Reporter base (workflow/reporting.py role) ──────────────────────────


class WorkflowReporter:
    """Open a live workflow panel for one CLI mode.

    Subclasses define ``title``, ``steps`` and ``fields()``; ``start()``
    returns a :class:`WorkflowProgress` whose panel carries the summary
    cards above the step list.  Use the returned object exactly like a
    bare WorkflowProgress (context manager, start_step/finish_step/
    advance)."""

    title = "boxmot-tpu"
    steps: list[str] = [SETUP]

    def __init__(self, **args):
        self.args = args

    def fields(self) -> list:
        return []

    def start(self, force_rich: bool | None = None, console=None) -> WorkflowProgress:
        cards = [c for c in self.fields() if c is not None]
        wp = WorkflowProgress(
            list(self.steps), title=self.title, force_rich=force_rich,
            console=console,
        )
        if cards and rich_available():
            wp.header = _cards_renderable(cards)
        elif cards:
            from .logging import LOGGER

            for title, items in cards:
                LOGGER.info(
                    "%s: %s", title,
                    "  ".join(f"{k}={v}" for k, v in items),
                )
        return wp


class TrackReporter(WorkflowReporter):
    """reporters/track.py:103-110 role: tracker/detector/reid/source cards."""

    title = "boxmot-tpu track"
    steps = TRACK_STEPS

    def fields(self):
        a = self.args
        return [
            card("Tracker", [
                ("Name", a.get("tracker")),
                ("ReID", bool_glyph(a["reid_weights"]) if a.get("reid_weights") else None),
            ]),
            card("Detector", [
                ("Model", compact_model_name(a["detector"]) if a.get("detector") else "public det.txt"),
            ]),
            card("Source", [("Input", a.get("source"))]),
            card("Output", [
                ("Save txt", bool_glyph(a.get("save_txt"))),
                ("Save video", bool_glyph(a.get("save_video"))),
            ]),
        ]


class EvalReporter(WorkflowReporter):
    """reporters/eval.py role: dataset/tracker/replay cards + metric table."""

    title = "boxmot-tpu eval"

    def __init__(self, **args):
        super().__init__(**args)
        self.steps = eval_steps(postprocess=bool(args.get("postprocessing")))

    def fields(self):
        a = self.args
        return [
            card("Dataset", [
                ("Benchmark", a.get("benchmark")),
                ("Split", a.get("data")),
            ]),
            card("Tracker", [
                ("Spec", a.get("tracker")),
                ("Tuned", a.get("tuned")),
                ("Postprocess", a.get("postprocessing")),
            ]),
            card("Replay", [
                ("Detector", a.get("detector")),
                ("ReID cache", a.get("reid")),
                ("Workers", a.get("n_workers") if (a.get("n_workers") or 1) > 1 else None),
            ]),
        ]


class GenerateReporter(WorkflowReporter):
    title = "boxmot-tpu generate"
    steps = GENERATE_STEPS

    def fields(self):
        a = self.args
        return [
            card("Dataset", [("Split", a.get("data"))]),
            card("Detector", [
                ("Model", compact_model_name(a["detector"]) if a.get("detector") else None),
            ]),
            card("ReID", [
                ("Model", compact_model_name(a["reid_weights"]) if a.get("reid_weights") else None),
                ("Preprocess", a.get("preprocess")),
                ("Batch", a.get("batch_size") or "whole-frame"),
            ]),
            card("Cache", [("Root", a.get("cache_root"))]),
        ]


class TuneReporter(WorkflowReporter):
    """reporters/tune.py role: live trial feed + saved-artifact table."""

    title = "boxmot-tpu tune"
    steps = TUNE_STEPS

    def fields(self):
        a = self.args
        return [
            card("Search", [
                ("Tracker", a.get("tracker")),
                ("Backend", a.get("backend")),
                ("Trials", a.get("n_trials")),
                ("Seed", a.get("seed")),
            ]),
            card("Dataset", [("Split", a.get("data"))]),
            card("Artifacts", [("Work dir", a.get("work_dir"))]),
        ]


class ExportReporter(WorkflowReporter):
    title = "boxmot-tpu export"
    steps = EXPORT_STEPS

    def fields(self):
        a = self.args
        return [
            card("Model", [
                ("Name", a.get("model")),
                ("Weights", compact_model_name(a["weights"]) if a.get("weights") else None),
                ("Crop", a.get("imgsz")),
            ]),
            card("Targets", [
                ("Formats", a.get("include")),
                ("Int8", bool_glyph(a.get("int8"))),
                ("Verify", bool_glyph(a.get("do_verify"))),
            ]),
            card("Output", [("Dir", a.get("out_dir"))]),
        ]


class ResearchReporter(WorkflowReporter):
    title = "boxmot-tpu research"
    steps = RESEARCH_STEPS

    def fields(self):
        a = self.args
        return [
            card("Search", [
                ("Tracker", a.get("tracker")),
                ("Candidates", a.get("n_candidates")),
                ("Mode", "source-edit" if a.get("edit_source") else "config"),
            ]),
            card("Dataset", [("Split", a.get("data"))]),
        ]


# ── Mode summary renderers ──────────────────────────────────────────────


def artifacts_table(artifacts: dict[str, object], title: str = "Saved artifacts",
                    console=None):
    """Artifact-path table (reference build_tune_artifacts_renderable role)."""
    if not rich_available() or console is None:
        from .logging import LOGGER

        for k, v in artifacts.items():
            LOGGER.info("%s: %s", k, v)
        return None
    from rich.table import Table

    table = Table.grid(padding=(0, 1))
    table.add_column(style="cyan", no_wrap=True)
    table.add_column()
    for k, v in artifacts.items():
        table.add_row(str(k), str(v))
    from rich.panel import Panel

    panel = Panel(table, title=title, border_style="grey50")
    console.print(panel)
    return panel


class TrialFeed:
    """Live tune-trial feed: keeps the best-so-far trial and renders the
    last N trials as a table (reference tune reporter's trials view).

    Works headless: without rich each trial logs one line."""

    def __init__(self, metric: str = "HOTA", keep: int = 10):
        self.metric = metric
        self.keep = keep
        self.rows: list[dict] = []
        self.best: dict | None = None

    def record(self, trial: dict) -> None:
        self.rows.append(trial)
        if trial.get("error") is None and (
            self.best is None or trial["score"] > self.best["score"]
        ):
            self.best = trial

    def renderable(self):
        from rich.table import Table

        table = Table(title=f"trials ({len(self.rows)})")
        for col in ("#", "score", self.metric, "time", "params"):
            table.add_column(col, justify="right" if col != "params" else "left")
        start = max(0, len(self.rows) - self.keep)
        for i, t in enumerate(self.rows[start:], start=start):
            is_best = self.best is not None and t is self.best
            style = "green" if is_best else ("red" if t.get("error") else None)
            score = "failed" if t.get("error") else f"{t['score']:.4f}"
            metric = t.get("metrics", {}).get(self.metric)
            table.add_row(
                str(i), score,
                f"{100 * metric:.2f}" if metric is not None else "—",
                f"{t.get('seconds', 0):.1f}s",
                " ".join(f"{k}={v}" for k, v in t.get("params", {}).items()),
                style=style,
            )
        return table

    def log_line(self, trial: dict) -> str:
        i = len(self.rows) - 1
        if trial.get("error"):
            return f"trial {i}: failed ({trial['error'][:60]})"
        mark = " *best*" if trial is self.best else ""
        return f"trial {i}: score {trial['score']:.4f}{mark}"


__all__ = [
    "EVALUATE", "EXPORT", "GENERATE", "OPTIMIZE", "POSTPROCESS", "SETUP",
    "TRACK", "PREPARE", "BASELINE", "PROPOSE", "BEST",
    "TRACK_STEPS", "GENERATE_STEPS", "EXPORT_STEPS", "TUNE_STEPS",
    "RESEARCH_STEPS", "eval_steps",
    "compact_model_name", "bool_glyph", "card",
    "WorkflowReporter", "TrackReporter", "EvalReporter", "GenerateReporter",
    "TuneReporter", "ExportReporter", "ResearchReporter",
    "artifacts_table", "TrialFeed", "want_rich",
]
