"""Host ms of a frame-loop iteration of the replay, as the program's own span
``replay.step`` (``boxmot_tpu_torch/utils/spans.py``) reads it: the mean
over the steps it recorded, which are those of the traced slice (a step is
kept only when the profiler records from its start to its end)."""

import importlib


def read(s):
    try:
        spans = importlib.import_module("boxmot_tpu_torch.utils.spans")
    except ImportError:
        return None
    row = spans.table().get("replay.step")
    return None if not row else row["host_ms"] / row["count"]
