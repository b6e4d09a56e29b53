"""Host ms of a replay call's one device-to-host copy: the program's
always-on timing ``replay.drain`` (``boxmot_tpu_torch/utils/timing.py::
CALLS``), the wait for the call's queued steps and the copy, median of the
calls after the process's first (of the last ones the program keeps)."""

import importlib
import statistics


def read(s):
    try:
        calls = importlib.import_module("boxmot_tpu_torch.utils.timing").CALLS
    except (ImportError, AttributeError):
        return None
    drain = calls.last.get("replay.drain")
    if not drain:
        return None
    ms = [1e3 * v for v in drain]
    if calls.counts.get("replay.drain") == len(ms):
        ms = ms[1:]
    return statistics.median(ms) if ms else None
