"""Per-stage timing accumulators (a copy of boxmot_tpu/utils/timing.py).

Mirror of boxmot/utils/timing.py:78-494 TimingStats: per-frame
accumulators for detector phases (pre/proc/post), staged ReID times,
tracker update and plotting, with FPS breakdown rows for display.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager

from boxmot_tpu_torch.utils.spans import span

LAST = 64


class TimingStats:
    """Host seconds and counts by stage, and each stage's last ``LAST``
    seconds.

    The clock is the host's.  A stage that launches work on the card returns
    before the card has done it, so its time is the enqueue, and the device
    time lands in whichever later stage waits.  ``timeit`` also opens a span
    of ``utils/spans.py`` named by its key: under ``torch.profiler`` the stage
    is a range of the trace with its kernels linked to it, which gives its
    device time.  After the profiler stops, ``spans.table()`` gives each
    span's count, host and self ms and stream ms over that session.
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.last = defaultdict(lambda: deque(maxlen=LAST))
        self._lock = threading.Lock()

    @contextmanager
    def timeit(self, key: str):
        """Host seconds of the block under ``key``, the block in ``span(key)``."""
        t0 = time.perf_counter()
        try:
            with span(key):
                yield
        finally:
            self.add(key, time.perf_counter() - t0)

    def add(self, key: str, seconds: float):
        with self._lock:
            self.totals[key] += seconds
            self.counts[key] += 1
            self.last[key].append(seconds)

    # reference-compatible helpers (timing.py:328-340)
    def add_detector_phase_time(self, phase: str, seconds: float):
        self.add(f"det_{phase}", seconds)

    def add_reid_phase_time(self, phase: str, seconds: float):
        self.add(f"reid_{phase}", seconds)

    def add_track_time(self, seconds: float):
        self.add("track", seconds)

    def mean_ms(self, key: str) -> float:
        n = self.counts.get(key, 0)
        return 1000.0 * self.totals[key] / n if n else 0.0

    def fps(self, key: str) -> float:
        ms = self.mean_ms(key)
        return 1000.0 / ms if ms > 0 else 0.0

    def rows(self):
        """Display rows (build_timing_display_rows, timing.py:162)."""
        out = []
        for key in sorted(self.totals):
            out.append(
                {
                    "stage": key,
                    "mean_ms": round(self.mean_ms(key), 3),
                    "fps": round(self.fps(key), 1),
                    "count": self.counts[key],
                    "total_s": round(self.totals[key], 3),
                }
            )
        return out

    def summary(self) -> str:
        lines = [f"{'stage':<16}{'mean ms':>10}{'fps':>10}{'count':>8}"]
        for r in self.rows():
            lines.append(
                f"{r['stage']:<16}{r['mean_ms']:>10.3f}{r['fps']:>10.1f}{r['count']:>8}"
            )
        return "\n".join(lines)


# Always on: the host seconds of the stages of the port's requests
# (``engine/replay.py``: ``replay.pack``, ``replay.upload``, ``replay.drain``
# a call).
CALLS = TimingStats()


class TimedTracker:
    """Wrap a tracker so update() feeds TimingStats (wrap_tracker_reid,
    timing.py:473)."""

    def __init__(self, tracker, stats: TimingStats | None = None):
        self.tracker = tracker
        self.stats = stats or TimingStats()

    def update(self, *args, **kwargs):
        with self.stats.timeit("track"):
            return self.tracker.update(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.tracker, name)
