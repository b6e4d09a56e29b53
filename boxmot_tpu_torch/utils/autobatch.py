"""Batch autotuning with OOM backoff (a copy of boxmot_tpu/utils/autobatch.py).

Counterpart of the reference's detector batch autotune
(boxmot/engine/tracking/inference.py:332-388): work is processed in
batches; a device out-of-memory error halves the batch size and retries,
and the discovered safe size sticks for the rest of the run.  On the card
an OOM surfaces as ``torch.OutOfMemoryError`` (the JAX package looks for
XLA's RESOURCE_EXHAUSTED in the message, which is still recognized).
"""

from __future__ import annotations

import numpy as np


def is_oom_error(exc: BaseException) -> bool:
    import torch

    if isinstance(exc, torch.OutOfMemoryError):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return any(
        marker in text
        for marker in (
            "RESOURCE_EXHAUSTED",
            "Out of memory",
            "out of memory",
            "OOM",
            "Resource exhausted",
        )
    )


class AutoBatcher:
    """Carries the adaptive batch size across calls.

    >>> ab = AutoBatcher(batch_size=128)
    >>> feats = ab.map(lambda chunk: model(chunk), crops)
    """

    def __init__(self, batch_size: int = 16, auto: bool = True, min_batch: int = 1):
        self.batch_size = max(int(batch_size), min_batch)
        self.auto = auto
        self.min_batch = min_batch

    def map(self, fn, items):
        """Apply fn to items in batches; concatenate results on axis 0.

        On OOM the batch halves (retrying the same span) until min_batch;
        a failure at min_batch propagates.
        """
        n = len(items)
        if n == 0:
            return fn(items)
        outs = []
        start = 0
        while start < n:
            stop = min(start + self.batch_size, n)
            try:
                outs.append(fn(items[start:stop]))
            except Exception as exc:  # noqa: BLE001 - OOM filter below
                if not (self.auto and is_oom_error(exc)) or (
                    self.batch_size <= self.min_batch
                ):
                    raise
                self.batch_size = max(self.batch_size // 2, self.min_batch)
                continue
            start = stop
        if len(outs) == 1:
            return outs[0]
        return np.concatenate([np.asarray(o) for o in outs], axis=0)
