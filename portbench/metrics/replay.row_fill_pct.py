"""Share of the packed detection slots that hold a detection, %: the
program's counters ``replay.rows_valid`` (rows given) over
``replay.rows_packed`` (sequences x frame bucket x row bucket), over every
call of the run.  The rest is padding every step computes on."""

import importlib


def read(s):
    try:
        spans = importlib.import_module("boxmot_tpu_torch.utils.spans")
    except ImportError:
        return None
    got = spans.counts()
    packed = got.get("replay.rows_packed")
    return None if not packed else 100.0 * got.get("replay.rows_valid", 0) / packed
