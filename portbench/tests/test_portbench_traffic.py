"""The traffic generator: the same seed gives the same traffic, and the
replay mix puts every sequence into one (frames, rows) bucket."""

import numpy as np

from portbench import gen, harness
from portbench.reference import replay as ref
from portbench.tests.conftest import LIVE, REPLAY, ROOT, small_cell


def _traffic(name):
    return harness.Cell(ROOT, harness.load_json(ROOT / "BENCHMARK.json"), name).traffic


def test_live_frames_repeat_for_a_seed():
    t = small_cell(LIVE).traffic
    a, b, c = (gen.make(t, s) for s in (2**31 + 5, 2**31 + 5, 7))
    assert len(a) == t["params"]["pool_frames"]
    assert all(f.shape == (720, 1280, 3) and f.dtype == np.uint8 for f in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_replay_sequences_repeat_for_a_seed():
    t = small_cell(REPLAY).traffic
    a, b, c = (gen.make(t, s) for s in (2**31 + 5, 2**31 + 5, 7))
    for x, y in zip(a, b):
        assert all(np.array_equal(p, q) for p, q in zip(x["dets"], y["dets"]))
        assert all(np.array_equal(p, q) for p, q in zip(x["embs"], y["embs"]))
        assert np.array_equal(x["warps"], y["warps"])
    assert not np.array_equal(a[0]["dets"][0], c[0]["dets"][0])


def test_replay_mix_is_one_bucket_of_all_sequences():
    """All 45 sequences fall into the (256, 32) bucket of the port's replay,
    so one call runs them as one batch, S = 45."""
    from boxmot_tpu_torch.engine.replay import DET_BUCKETS, FRAME_BUCKETS, _bucket

    t = _traffic(REPLAY)
    p = t["params"]
    keys = set()
    for seed in (3, 2**31 + 11):
        seqs = gen.make(t, seed)
        assert len(seqs) == p["sequences"] == 45
        for s in seqs:
            rows = max(len(d) for d in s["dets"])
            keys.add((_bucket(len(s["dets"]), FRAME_BUCKETS), _bucket(rows, DET_BUCKETS)))
            assert rows <= p["max_rows"]
            assert all(e.shape == (len(d), p["feat_dim"]) for d, e in zip(s["dets"], s["embs"]))
            assert np.allclose([np.linalg.norm(e, axis=1) for e in s["embs"][:3]][0], 1.0,
                               atol=1e-5)
        assert ref.pack(seqs, p["feat_dim"])[0].shape[:3] == (45, 256, 32)
    assert keys == {(256, 32)}
