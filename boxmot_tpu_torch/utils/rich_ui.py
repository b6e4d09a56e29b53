"""A copy of ``boxmot_tpu/utils/rich_ui.py``.

Rich live workflow UI: pipeline steps, sequence progress, reporters.

Role mirror of boxmot/utils/rich/ (~3.5k LoC: PipelineTracker step state
machine at workflow/pipeline.py:65, WorkflowProgress live panel at
core/ui.py:572, per-mode reporters).  Compact equivalent on the `rich`
package, degrading to plain log lines when rich is missing or stdout is
not a TTY, so headless/CI runs never depend on it.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

from .logging import LOGGER

_STATE_GLYPH = {
    "pending": ("○", "grey50"),
    "running": ("◐", "yellow"),
    "done": ("●", "green"),
    "failed": ("✖", "red"),
    "skipped": ("◌", "grey50"),
}


def rich_available() -> bool:
    try:
        import rich  # noqa: F401

        return True
    except ImportError:
        return False


def want_rich(force: bool | None = None) -> bool:
    if force is not None:
        return force and rich_available()
    return rich_available() and sys.stdout.isatty()


@dataclass
class Step:
    name: str
    state: str = "pending"
    started: float | None = None
    finished: float | None = None
    detail: str = ""

    @property
    def seconds(self) -> float:
        if self.started is None:
            return 0.0
        return (self.finished or time.perf_counter()) - self.started


class PipelineTracker:
    """Ordered workflow steps with a pending→running→done/failed/skipped
    state machine (pipeline.py:65 parity).  Works headless; rendering is
    a separate concern (see WorkflowProgress / render_pipeline)."""

    def __init__(self, steps: list[str]):
        self.steps = [Step(s) for s in steps]
        self._by_name = {s.name: s for s in self.steps}

    def __getitem__(self, name: str) -> Step:
        return self._by_name[name]

    def start(self, name: str, detail: str = "") -> None:
        step = self._by_name[name]
        step.state = "running"
        step.started = time.perf_counter()
        step.detail = detail

    def finish(self, name: str, state: str = "done", detail: str | None = None) -> None:
        if state not in ("done", "failed", "skipped"):
            raise ValueError(f"invalid terminal state {state!r}")
        step = self._by_name[name]
        step.state = state
        step.finished = time.perf_counter()
        if detail is not None:
            step.detail = detail

    @property
    def current(self) -> Step | None:
        for s in self.steps:
            if s.state == "running":
                return s
        return None

    def summary_rows(self) -> list[dict]:
        return [
            {
                "step": s.name,
                "state": s.state,
                "seconds": round(s.seconds, 2),
                "detail": s.detail,
            }
            for s in self.steps
        ]


def render_pipeline(tracker: PipelineTracker, console=None):
    """Render the step list as a rich table (or log lines without rich)."""
    if not rich_available():
        for row in tracker.summary_rows():
            LOGGER.info("%-10s %-24s %6.2fs %s", row["state"], row["step"],
                        row["seconds"], row["detail"])
        return None
    from rich.table import Table
    from rich.text import Text

    table = Table(show_header=False, box=None, padding=(0, 1))
    for s in tracker.steps:
        glyph, color = _STATE_GLYPH[s.state]
        line = Text(f"{glyph} {s.name}", style=color)
        extra = f"{s.seconds:.1f}s" if s.started else ""
        if s.detail:
            extra = f"{extra}  {s.detail}" if extra else s.detail
        table.add_row(line, Text(extra, style="grey50"))
    if console is not None:
        console.print(table)
    return table


class WorkflowProgress:
    """Live panel: pipeline steps above a per-sequence progress bar.

    Use as a context manager; ``advance(seq, done, total)`` updates the
    bar.  Falls back to occasional log lines when rich is off.
    """

    def __init__(self, steps: list[str], title: str = "boxmot-tpu",
                 force_rich: bool | None = None, console=None):
        self.pipeline = PipelineTracker(steps)
        self.title = title
        self.header = None  # optional renderable above the steps (summary cards)
        self.extra = None   # optional renderable below the bars (e.g. TrialFeed)
        self._console = console
        self._use_rich = want_rich(force_rich)
        self._live = None
        self._progress = None
        self._tasks: dict[str, object] = {}
        self._last_log = 0.0

    def _build_panel(self):
        from rich.console import Group
        from rich.panel import Panel

        parts = [p for p in (self.header, render_pipeline(self.pipeline),
                             self._progress, self.extra) if p is not None]
        return Panel(Group(*parts), title=self.title)

    def __enter__(self):
        if self._use_rich:
            from rich.live import Live
            from rich.progress import (BarColumn, Progress, TextColumn,
                                       TimeElapsedColumn)

            self._progress = Progress(
                TextColumn("[progress.description]{task.description}"),
                BarColumn(),
                TextColumn("{task.completed}/{task.total}"),
                TimeElapsedColumn(),
            )
            self._panel = self._build_panel
            self._live = Live(self._panel(), refresh_per_second=4,
                              console=self._console)
            self._live.__enter__()
        return self

    def __exit__(self, *exc):
        if exc and exc[0] is not None:
            # mark the in-flight step failed so the final frame is honest
            cur = self.pipeline.current
            if cur is not None:
                self.pipeline.finish(cur.name, "failed")
        if self._live is not None:
            self._live.update(self._panel())
            self._live.__exit__(*exc)

    def _refresh(self):
        if self._live is not None:
            self._live.update(self._panel())

    refresh = _refresh  # public: re-render after mutating header/extra

    def start_step(self, name: str, detail: str = ""):
        self.pipeline.start(name, detail)
        if not self._use_rich:
            LOGGER.info("step %s started %s", name, detail)
        self._refresh()

    def finish_step(self, name: str, state: str = "done", detail: str | None = None):
        self.pipeline.finish(name, state, detail)
        if not self._use_rich:
            LOGGER.info("step %s %s", name, state)
        self._refresh()

    def advance(self, seq: str, done: int, total: int):
        if self._progress is not None:
            if seq not in self._tasks:
                self._tasks[seq] = self._progress.add_task(seq, total=total)
            self._progress.update(self._tasks[seq], completed=done, total=total)
            self._refresh()
        else:
            now = time.perf_counter()
            if now - self._last_log > 5.0 or done == total:
                LOGGER.info("%s: %d/%d", seq, done, total)
                self._last_log = now


def metrics_table(results: dict[str, dict], metrics=("HOTA", "MOTA", "IDF1"),
                  title: str = "results", console=None):
    """Per-tracker (or per-sequence) metric table reporter."""

    from .fmt import as_percent as pct

    if not rich_available():
        for name, m in results.items():
            LOGGER.info("%s  %s", name,
                        "  ".join(f"{k}={pct(m.get(k, 0)):.2f}" for k in metrics))
        return None
    from rich.table import Table

    table = Table(title=title)
    table.add_column("name")
    for m in metrics:
        table.add_column(m, justify="right")
    for name, vals in results.items():
        table.add_row(name, *(f"{pct(vals.get(k, 0.0)):.2f}" for k in metrics))
    if console is not None:
        console.print(table)
    return table
