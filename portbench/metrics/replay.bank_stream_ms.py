"""Ms a step that HybridSORT's long-term bank holds the card's stream: the
stream time (a pair of CUDA events each) of the program's spans
``hybridsort.bank_read`` and ``hybridsort.bank_write``, summed, over the
steps recorded (the count of ``hybridsort.predict``, the step's first
pass).  Stream time is the bank's device time while the card runs behind the
host, and includes the card's waits for the host's enqueue where it does
not: it cannot read below the host ms of those spans."""

import importlib


def read(s):
    try:
        spans = importlib.import_module("boxmot_tpu_torch.utils.spans")
    except ImportError:
        return None
    table = spans.table()
    steps = table.get("hybridsort.predict", {}).get("count")
    bank = [table[n]["stream_ms"] for n in ("hybridsort.bank_read", "hybridsort.bank_write")
            if n in table and table[n]["stream_ms"] is not None]
    return None if not steps or not bank else sum(bank) / steps
