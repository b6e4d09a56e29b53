"""Event hooks and crash-proof progress callbacks (a copy of
boxmot_tpu/utils/callbacks.py).

Role mirror of the reference's boxmot/utils/callbacks.py (safe progress
wrappers) plus the per-event callback registry that the reference's
Detector class carries inline (boxmot/detectors/detector.py:112-119).
A raised callback must never take down a tracking run: wrappers swallow
and debug-log exceptions.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable

from .logging import LOGGER as logger

ProgressFn = Callable[[str], None]
SeqProgressFn = Callable[[str, int, int], None]


def safe_progress_callback(fn: ProgressFn | None) -> ProgressFn | None:
    """Wrap a `(message)` progress callback so it can never raise."""
    if fn is None:
        return None

    def wrapped(message: str) -> None:
        try:
            fn(message)
        except Exception:
            logger.debug("progress callback raised; suppressed", exc_info=True)

    return wrapped


def safe_seq_progress_callback(fn: SeqProgressFn | None) -> SeqProgressFn | None:
    """Wrap a `(seq_name, current, total)` callback so it can never raise."""
    if fn is None:
        return None

    def wrapped(seq_name: str, current: int, total: int) -> None:
        try:
            fn(seq_name, current, total)
        except Exception:
            logger.debug("sequence progress callback raised; suppressed", exc_info=True)

    return wrapped


class CallbackRegistry:
    """Named-event hook table: ``add(event, fn)`` then ``fire(event, ctx)``.

    Exceptions inside hooks are suppressed (logged at debug) so user
    hooks cannot abort the pipeline mid-sequence.
    """

    def __init__(self) -> None:
        self._hooks: dict[str, list[Callable[..., None]]] = defaultdict(list)

    def add(self, event: str, fn: Callable[..., None]) -> None:
        self._hooks[event].append(fn)

    def remove(self, event: str, fn: Callable[..., None]) -> None:
        try:
            self._hooks[event].remove(fn)
        except ValueError:
            pass

    def fire(self, event: str, *args: Any, **kwargs: Any) -> None:
        for fn in self._hooks.get(event, ()):
            try:
                fn(*args, **kwargs)
            except Exception:
                logger.debug("callback for %r raised; suppressed", event, exc_info=True)

    def events(self) -> list[str]:
        return [k for k, v in self._hooks.items() if v]
