"""``boxmot_tpu_torch.utils.spans``: off it costs a check and records
nothing; under ``torch.profiler`` its spans nest, share the profiler's clock,
hold one profiler session and cover the replay path and HybridSORT's passes
without changing a bit of the replay's output; its counters count the packed
rows, and ``utils/timing.py::CALLS`` times each call's stages."""

from __future__ import annotations

import sys
import threading

import numpy as np
import pytest
import torch

from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.replay import replay_sequences_outputs
from boxmot_tpu_torch.utils import spans, timing

PASSES = ("hybridsort.predict", "hybridsort.pass1", "hybridsort.byte", "hybridsort.final",
          "hybridsort.oru", "hybridsort.update", "hybridsort.births")
S, F, D, FEAT = 2, 8, 8, 16


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _clean():
    spans.reset()
    yield
    spans.reset()


def _seqs():
    rng = np.random.default_rng(7)
    seqs = []
    for _ in range(S):
        base = rng.uniform(50, 400, (D, 2))
        dets, embs = [], []
        for f in range(F):
            n = int(rng.integers(3, D + 1))
            xy = base[:n] + 4.0 * f
            boxes = np.concatenate([xy, xy + rng.uniform(30, 60, (n, 2))], 1)
            conf = rng.uniform(0.05, 0.95, (n, 1))
            dets.append(np.concatenate([boxes, conf, np.zeros((n, 1))], 1).astype(np.float32))
            embs.append(rng.normal(size=(n, FEAT)).astype(np.float32))
        seqs.append({"dets": dets, "embs": embs})
    return seqs


def _replay(seqs):
    cfg = build_replay_config("hybridsort", capacity=16, feat_dim=FEAT, longterm_bank_length=4,
                              with_reid=True, with_longterm_reid=True, use_byte=True)
    return replay_sequences_outputs(cfg, seqs, device="cpu")


def test_off_span_is_one_shared_noop(monkeypatch):
    def boom(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(spans.torch.profiler, "record_function", boom)
    assert spans.span("a") is spans.span("b")
    stats = timing.TimingStats()
    for _ in range(timing.LAST + 1):
        with spans.span("a"), stats.timeit("t"):
            spans.count("n", 3)
    assert spans.records() == [] and spans.table() == {}
    assert spans.counts() == {"n": 3 * (timing.LAST + 1)}
    assert stats.counts["t"] == timing.LAST + 1 and len(stats.last["t"]) == timing.LAST


def test_nested_spans_share_the_profiler_clock():
    with _profile() as prof:
        with spans.span("warm"):
            pass
        with spans.span("req"):
            with spans.span("outer"):
                with spans.span("inner.a"):
                    torch.ones(64).sum()
                with spans.span("inner.b"):
                    torch.ones(64).sum()
        with spans.span("alone"):
            pass
    recs = {r.name: r for r in spans.records()}
    outer, a, b = recs["outer"], recs["inner.a"], recs["inner.b"]
    assert a.parent is outer and b.parent is outer and outer.parent is recs["req"]
    assert recs["req"].parent is None and recs["alone"].parent is None
    assert outer.self_ms == pytest.approx(outer.host_ms - a.host_ms - b.host_ms, abs=1e-9)
    row = spans.table()["outer"]
    assert row["count"] == 1 and row["self_ms"] == pytest.approx(outer.self_ms)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for name in ("req", "outer", "inner.a", "inner.b", "alone"):
        evt, rec = events[name], recs[name]
        assert abs(evt.start_ns() - rec.start_ns) < 100_000, name
        assert abs(evt.end_ns() - rec.end_ns) < 100_000, name


def test_span_closed_after_the_profiler_stops_is_not_kept():
    prof = _profile()
    prof.__enter__()
    with spans.span("open"):
        with spans.span("kept"):
            pass
        prof.__exit__(None, None, None)
    assert [r.name for r in spans.records()] == ["kept"]


def test_a_new_profiler_session_starts_a_fresh_store():
    for names in (("first", "first.child"), ("second",)):
        with _profile():
            for name in names:
                with spans.span(name):
                    pass
        with spans.span("between"):  # the profiler is seen off
            pass
        assert [r.name for r in spans.records()] == list(names)


def test_threads_keep_their_own_parents(monkeypatch):
    # a profiler records the thread that started it: every thread is made to
    # see one, so that the threads' spans interleave
    monkeypatch.setattr(spans.torch.autograd, "_profiler_enabled", lambda: True)

    def work(k):
        for _ in range(50):
            with spans.span(f"t{k}"):
                with spans.span(f"t{k}.child"):
                    spans.count("hits")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert spans.counts()["hits"] == 400
    children = [r for r in spans.records() if r.name.endswith(".child")]
    assert len(children) == 400
    assert all(r.parent is not None and r.name == r.parent.name + ".child" for r in children)


@pytest.fixture(scope="module")
def replays():
    """The same replay untraced, then traced: what each gave and what the
    store held after them."""
    seqs = _seqs()
    spans.reset()
    before = dict(timing.CALLS.counts)
    plain = _replay(seqs)
    counts = spans.counts()
    with _profile():
        traced = _replay(seqs)
    calls = {k: v - before.get(k, 0) for k, v in timing.CALLS.counts.items()}
    return {"seqs": seqs, "plain": plain, "traced": traced, "counts": counts,
            "records": spans.records(), "calls": calls}


def test_replay_spans_cover_each_pass_once_a_step(replays):
    recs = replays["records"]
    names = [r.name for r in recs]
    assert names.count("replay.step") == F
    for name in (*PASSES, "hybridsort.bank_read"):
        assert names.count(name) == F, name
    assert names.count("hybridsort.bank_write") == 2 * F
    assert {r.parent.name for r in recs if r.name in PASSES} == {"replay.step"}
    for stage in ("replay.pack", "replay.upload", "replay.drain"):
        assert names.count(stage) == 1, stage
    assert {r.parent for r in recs if r.name.startswith("replay.")} == {None}


def test_replay_outputs_equal_with_tracing_on(replays):
    for (o0, m0), (o1, m1) in zip(replays["plain"], replays["traced"]):
        np.testing.assert_array_equal(o0, o1)
        np.testing.assert_array_equal(m0, m1)


def test_replay_counts_rows(replays):
    counts = replays["counts"]
    assert counts["replay.rows_valid"] == sum(len(d) for s in replays["seqs"] for d in s["dets"])
    assert counts["replay.rows_packed"] == S * 64 * D  # the smallest frame bucket
    assert all(replays["calls"][k] == 2 for k in ("replay.pack", "replay.upload", "replay.drain"))
