"""Spans and counters of the port's own layers, on the profiler's clock.

``span(name)`` marks a stretch of host code.  Unless a ``torch.profiler`` is
recording (an operator's, or the one a traced benchmark run starts) it costs
one check and returns a shared no-op.  While one records, the span enters
``torch.profiler.record_function(name)``, so the range lands in the trace
with the kernels launched inside it linked to it, and keeps a ``Record``: its
name, start and end on ``time.time_ns()`` (the clock of the profiler's own
events, so records and a device trace merge without conversion), its parent
span and, where CUDA is initialised, a pair of timing events on the current
stream.  Their elapsed time is the span's stream time: the span's work, and
any time the stream waited for the host to enqueue it.  A span is kept only
if the profiler still records when it closes, as the trace keeps it.
Nothing here waits for the card: ``table`` resolves the events once the
work is done.

The store holds one profiler session: the first span a thread opens once it
has seen the profiler off and then on starts it afresh, so ``records()`` and
``table()`` read the last session, as its trace does.  Past ``CAP`` records
a session's rest are counted as ``spans.dropped``.  ``count(name, n)`` adds
to an always-on counter (the host times of a request's stages go to
``utils/timing.py::CALLS``).  Parent stacks are per thread; the store takes
a lock.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

CAP = 1 << 16
_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_RECORDS: list = []
_COUNTS: collections.Counter = collections.Counter()


class Record:
    __slots__ = ("name", "parent", "start_ns", "end_ns", "child_ns", "events", "stream_ms")

    def __init__(self, name, parent):
        self.name, self.parent = name, parent
        self.start_ns = self.end_ns = self.child_ns = 0
        self.events = self.stream_ms = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def self_ms(self) -> float:
        return (self.end_ns - self.start_ns - self.child_ns) / 1e6


class _Local(threading.local):
    def __init__(self):
        self.stack: list = []  # the open records, innermost last
        self.off = False  # the profiler was off at this thread's last span


_LOCAL = _Local()


class _Span:
    __slots__ = ("rf", "rec")

    def __init__(self, name: str):
        local = _LOCAL
        if local.off:  # a new profiler session
            local.off = False
            with _LOCK:
                _RECORDS.clear()
        self.rf = torch.profiler.record_function(name)
        self.rec = Record(name, local.stack[-1] if local.stack else None)

    def __enter__(self):
        self.rf.__enter__()
        rec = self.rec
        if torch.cuda.is_initialized():
            rec.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        _LOCAL.stack.append(rec)
        rec.start_ns = time.time_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.end_ns = time.time_ns()
        if rec.events:
            rec.events[1].record()
        _LOCAL.stack.pop()
        self.rf.__exit__(*exc)
        if not torch.autograd._profiler_enabled():
            return
        if rec.parent is not None:
            rec.parent.child_ns += rec.end_ns - rec.start_ns
        with _LOCK:
            if len(_RECORDS) < CAP:
                _RECORDS.append(rec)
            else:
                _COUNTS["spans.dropped"] += 1


def span(name: str):
    """A range ``name`` while a profiler records; else a shared no-op."""
    if not torch.autograd._profiler_enabled():
        _LOCAL.off = True
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[name] += int(n)


def records() -> list:
    """The kept records, their stream time resolved (the work must be done)."""
    with _LOCK:
        recs = list(_RECORDS)
    for rec in recs:
        if rec.events is not None:
            start, end = rec.events
            end.synchronize()
            rec.stream_ms, rec.events = start.elapsed_time(end), None
    return recs


def table() -> dict:
    """name -> count, host_ms, self_ms and stream_ms (None without CUDA)."""
    out: dict = {}
    for rec in records():
        row = out.setdefault(rec.name, {"count": 0, "host_ms": 0.0, "self_ms": 0.0,
                                        "stream_ms": None})
        row["count"] += 1
        row["host_ms"] += rec.host_ms
        row["self_ms"] += rec.self_ms
        if rec.stream_ms is not None:
            row["stream_ms"] = (row["stream_ms"] or 0.0) + rec.stream_ms
    return out


def counts() -> dict:
    with _LOCK:
        return dict(_COUNTS)


def reset() -> None:
    with _LOCK:
        _RECORDS.clear()
        _COUNTS.clear()
