"""The readers of the program's own spans and counters
(``boxmot_tpu_torch/utils/spans.py``): each against a store filled by hand,
None on an empty one; and on a card (skipped without one) the replay with
tracing on waits for the card nowhere in the call but its one copy, and the
bank's stream time agrees with the device time the trace links to the same
spans."""

import pytest
import torch

from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.replay import replay_sequences_outputs
from boxmot_tpu_torch.utils import spans, timing
from portbench import gen, harness, trace
from portbench.tests.conftest import REPLAY, ROOT, small_cell

READERS = ("replay.step_host_ms", "replay.bank_stream_ms", "replay.pack_ms", "replay.drain_ms",
           "replay.row_fill_pct")
BANK = ("hybridsort.bank_read", "hybridsort.bank_write")
SEED = 2**31 + 421


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    spans.reset()
    monkeypatch.setattr(timing, "CALLS", timing.TimingStats())
    yield
    spans.reset()


def _record(name, ms, stream_ms=None):
    rec = spans.Record(name, None)
    rec.end_ns, rec.stream_ms = int(ms * 1e6), stream_ms
    spans._RECORDS.append(rec)


def _timing(name, count, last_ms):
    """``count`` calls of ``name`` in ``CALLS``, the last of them ``last_ms``."""
    for _ in range(count - len(last_ms)):
        timing.CALLS.add(name, 1.0)
    for ms in last_ms:
        timing.CALLS.add(name, ms / 1e3)


def read(name):
    return harness.load_reader(ROOT, name)(None)


def test_readers_find_nothing_in_an_empty_store():
    assert {name: read(name) for name in READERS} == dict.fromkeys(READERS)


def test_readers_of_a_store_filled_by_hand():
    for ms in (10.0, 20.0, 30.0):
        _record("replay.step", ms)
    for _ in range(2):
        _record("hybridsort.predict", 1.0, 0.5)
        _record("hybridsort.bank_read", 6.0, 5.0)
        _record("hybridsort.bank_write", 2.0, 1.0)
        _record("hybridsort.bank_write", 2.0, 1.5)
    _timing("replay.pack", 3, [900.0, 100.0, 120.0])
    _timing("replay.upload", 3, [10.0, 5.0, 7.0])
    _timing("replay.drain", 4, [500.0, 40.0, 50.0, 60.0])
    spans.count("replay.rows_valid", 600)
    spans.count("replay.rows_packed", 1000)
    got = {name: read(name) for name in READERS}
    assert got == pytest.approx({"replay.step_host_ms": 20.0, "replay.bank_stream_ms": 7.5,
                                 "replay.pack_ms": 116.0, "replay.drain_ms": 50.0,
                                 "replay.row_fill_pct": 60.0})


def test_per_call_readers_keep_every_kept_call_once_the_first_is_gone():
    # 70 calls: the program keeps the last 64, and the first is not among them
    _timing("replay.pack", 70, [100.0] * 63 + [400.0])
    _timing("replay.upload", 70, [1.0] * 64)
    _timing("replay.drain", 70, [40.0] * 32 + [60.0] * 32)
    assert read("replay.pack_ms") == pytest.approx(101.0)
    assert read("replay.drain_ms") == pytest.approx(50.0)


@pytest.mark.cuda
def test_traced_replay_never_waits_and_bank_stream_time_matches_the_trace(card):
    cell = small_cell(REPLAY)
    params = dict(cell.config["tracker"]["params"], longterm_bank_length=270)
    cfg = build_replay_config(cell.config["tracker"]["name"], **params)
    cell.traffic["params"].update(sequences=16, frames=24)
    seqs = gen.make(cell.traffic, SEED)
    replay_sequences_outputs(cfg, seqs, device=card)  # kernels built, allocator warm
    spans.reset()
    cut = trace.Slice()
    cut.start()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay_sequences_outputs(cfg, seqs, device=card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    summary = cut.stop(BANK, units=24)
    table = spans.table()
    assert table["hybridsort.predict"]["count"] == 24 and table["replay.step"]["count"] == 24
    linked_ms = sum(summary.ranges[n]["device_s"] for n in BANK) * 1e3 / 24
    reading = harness.load_reader(ROOT, "replay.bank_stream_ms")(summary)
    assert linked_ms > 0 and abs(reading - linked_ms) <= 0.1 * linked_ms, (reading, linked_ms)
