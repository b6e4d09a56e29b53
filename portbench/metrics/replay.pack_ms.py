"""Host ms a replay call spends packing its sequences into buckets and
uploading them: the program's always-on timings ``replay.pack`` and
``replay.upload`` (``boxmot_tpu_torch/utils/timing.py::CALLS``), summed a
call, median of the calls after the process's first (of the last ones the
program keeps)."""

import importlib
import statistics


def read(s):
    try:
        calls = importlib.import_module("boxmot_tpu_torch.utils.timing").CALLS
    except (ImportError, AttributeError):
        return None
    pack, upload = calls.last.get("replay.pack"), calls.last.get("replay.upload")
    if not pack or not upload:
        return None
    ms = [1e3 * (a + b) for a, b in zip(pack, upload)]
    if calls.counts.get("replay.pack") == len(ms):
        ms = ms[1:]
    return statistics.median(ms) if ms else None
