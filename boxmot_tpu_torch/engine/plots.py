"""A copy of ``boxmot_tpu/engine/plots.py``.

Metric plots: per-tracker radar and bar charts, FPS-vs-metric scatter.

Role mirror of boxmot/engine/eval/plots.py:7-217 (MetricsPlotter radar +
FPS/metric charts).  Static matplotlib output (Agg).

Color discipline: categorical hues come from a CVD-validated palette in
FIXED slot order (identity follows the tracker, never its rank); at most
eight series are drawn — extra trackers fold into the bar chart, which
uses a single hue because the axis already carries identity.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.fmt import as_percent as _as_pct  # shared with rich_ui

# Validated categorical palette (light surface), fixed slot order.
CATEGORICAL = (
    "#2a78d6",  # blue
    "#eb6834",  # orange
    "#1baf7a",  # aqua
    "#eda100",  # yellow
    "#e87ba4",  # magenta
    "#008300",  # green
    "#4a3aa7",  # violet
    "#e34948",  # red
)
_INK = "#1a1a19"
_MUTED = "#6e6d66"
_GRID = "#c3c2b7"

DEFAULT_METRICS = ("HOTA", "MOTA", "IDF1", "DetA", "AssA_mean")
_LABELS = {"AssA_mean": "AssA"}


def _agg_plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_metric_radar(
    results: dict[str, dict],
    out_path: str | Path,
    metrics: tuple[str, ...] = DEFAULT_METRICS,
    max_series: int = 8,
) -> Path:
    """One polygon per tracker over the metric axes.

    ``results`` maps tracker name -> metric dict (run_eval "combined").
    Series beyond ``max_series`` (ranked by the first metric) are dropped
    with a caption note rather than assigned unvalidated colors.
    """
    plt = _agg_plt()
    ranked = sorted(
        results.items(), key=lambda kv: kv[1].get(metrics[0], 0.0), reverse=True
    )
    shown, folded = ranked[:max_series], ranked[max_series:]

    labels = [_LABELS.get(m, m) for m in metrics]
    angles = np.linspace(0, 2 * np.pi, len(metrics), endpoint=False).tolist()
    angles += angles[:1]

    fig, ax = plt.subplots(figsize=(7, 6), subplot_kw={"projection": "polar"})
    for (name, m), color in zip(shown, CATEGORICAL):
        vals = [_as_pct(float(m.get(k, 0.0))) for k in metrics]
        vals += vals[:1]
        ax.plot(angles, vals, color=color, linewidth=2, label=name)
        ax.fill(angles, vals, color=color, alpha=0.06)
    ax.set_xticks(angles[:-1])
    ax.set_xticklabels(labels, color=_INK)
    ax.set_ylim(0, 100)
    ax.tick_params(axis="y", labelcolor=_MUTED, labelsize=8)
    ax.grid(color=_GRID, linewidth=0.6)
    ax.spines["polar"].set_color(_GRID)
    ax.legend(loc="upper right", bbox_to_anchor=(1.32, 1.1), frameon=False,
              labelcolor=_INK)
    title = "Tracking metrics"
    if folded:
        title += f"  (top {max_series}; {len(folded)} more in bar chart)"
    ax.set_title(title, color=_INK, pad=24)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_metric_bars(
    results: dict[str, dict],
    out_path: str | Path,
    metric: str = "HOTA",
) -> Path:
    """Horizontal bars of one metric across all trackers, sorted.

    Single hue: the y-axis carries identity, so color stays constant
    (magnitude lives in length, not color).
    """
    plt = _agg_plt()
    ranked = sorted(
        results.items(), key=lambda kv: kv[1].get(metric, 0.0), reverse=True
    )
    names = [k for k, _ in ranked]
    vals = [_as_pct(float(m.get(metric, 0.0))) for _, m in ranked]

    fig, ax = plt.subplots(figsize=(7, 0.5 * len(names) + 1.2))
    y = np.arange(len(names))[::-1]
    ax.barh(y, vals, height=0.62, color=CATEGORICAL[0])
    for yi, v in zip(y, vals):
        ax.text(v + 0.6, yi, f"{v:.2f}", va="center", color=_INK, fontsize=9)
    ax.set_yticks(y)
    ax.set_yticklabels(names, color=_INK)
    ax.set_xlim(0, max(vals + [1.0]) * 1.12)
    ax.set_xlabel(_LABELS.get(metric, metric), color=_INK)
    ax.tick_params(colors=_MUTED)
    for side in ("top", "right", "left"):
        ax.spines[side].set_visible(False)
    ax.spines["bottom"].set_color(_GRID)
    ax.xaxis.grid(color=_GRID, linewidth=0.6)
    ax.set_axisbelow(True)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_fps_metric(
    results: dict[str, dict],
    out_path: str | Path,
    metric: str = "HOTA",
    fps_key: str = "fps",
) -> Path:
    """Throughput/quality tradeoff: one labeled point per tracker.

    One series of points; identity comes from direct labels, so a single
    hue suffices (plot_fps_metrics parity, eval/plots.py:127).
    """
    plt = _agg_plt()
    fig, ax = plt.subplots(figsize=(7, 5))
    for name, m in sorted(results.items()):
        fps = float(m.get(fps_key, 0.0))
        val = _as_pct(float(m.get(metric, 0.0)))
        ax.scatter(fps, val, s=64, color=CATEGORICAL[0], zorder=3)
        ax.annotate(name, (fps, val), textcoords="offset points",
                    xytext=(7, 4), color=_INK, fontsize=9)
    ax.set_xlabel("FPS", color=_INK)
    ax.set_ylabel(_LABELS.get(metric, metric), color=_INK)
    ax.tick_params(colors=_MUTED)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("bottom", "left"):
        ax.spines[side].set_color(_GRID)
    ax.grid(color=_GRID, linewidth=0.6)
    ax.set_axisbelow(True)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_eval_summary(
    results: dict[str, dict], out_dir: str | Path, metric: str = "HOTA"
) -> list[Path]:
    """Radar + bar chart for an eval sweep; returns written paths."""
    out_dir = Path(out_dir)
    return [
        plot_metric_radar(results, out_dir / "metrics_radar.png"),
        plot_metric_bars(results, out_dir / f"{metric.lower()}_bars.png", metric),
    ]
