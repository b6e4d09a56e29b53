"""The port's own copies of the JAX package's host modules against the originals.

The port keeps copies of the dataset readers, the MOT row writer, the
result type, the per-class id allocator and the HOTA/CLEAR/Identity metric
stack, so that it imports nothing of ``boxmot_tpu``.  Here the same inputs
go through each copy and its original, and the outputs must be identical:
every metric, to the bit, on MOT17-mini and on mmot-mini.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from boxmot_tpu.data import cache as jcache
from boxmot_tpu.data import mmot as jmmot
from boxmot_tpu.data import mot as jmot
from boxmot_tpu.engine import mot_io as jmot_io
from boxmot_tpu.engine import results as jresults
from boxmot_tpu.engine.metrics import mot_metrics as jmetrics
from boxmot_tpu.trackers import per_class_ids as jids
from boxmot_tpu.trackers import track_results as jtr
from boxmot_tpu_torch.data import cache as tcache
from boxmot_tpu_torch.data import mmot as tmmot
from boxmot_tpu_torch.data import mot as tmot
from boxmot_tpu_torch.engine import mot_io as tmot_io
from boxmot_tpu_torch.engine import results as tresults
from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.eval_obb import corner_rows, mmot_obb_dets
from boxmot_tpu_torch.engine.metrics import mot_metrics as tmetrics
from boxmot_tpu_torch.engine.replay import replay_sequences_batched, replay_sequences_outputs
from boxmot_tpu_torch.trackers import per_class_ids as tids
from boxmot_tpu_torch.trackers import track_results as ttr

ASSETS = Path(__file__).resolve().parent.parent / "assets"
MOT17 = ASSETS / "MOT17-mini" / "train"
MMOT = ASSETS / "mmot-mini" / "train"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def assert_identical(got, want, path="result"):
    """Nested dicts, lists and arrays equal to the bit, keys and types too."""
    assert type(got) is type(want), f"{path}: {type(got)} vs {type(want)}"
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_identical(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_identical(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want or (got != got and want != want), f"{path}: {got} vs {want}"


@pytest.fixture(scope="module")
def mot17_rows():
    """The port's ByteTrack MOT rows on MOT17-mini (CPU), per sequence."""
    seqs = list(tmot.MOTDataset(MOT17))
    rows = replay_sequences_batched(build_replay_config("bytetrack"),
                                    [{"dets": s.dets_per_frame()} for s in seqs], device="cpu")
    return seqs, rows


def test_aabb_metric_stack_equals_jax(mot17_rows):
    seqs, rows = mot17_rows
    data = {m: {s.name: m.preprocess_sequence(s.gt(), r.astype(np.float64), s.seq_length)
                for s, r in zip(seqs, rows)} for m in (tmetrics, jmetrics)}
    for name in data[jmetrics]:
        got, want = data[tmetrics][name], data[jmetrics][name]
        assert_identical(vars(got), vars(want), name)
    got, want = (m.evaluate_sequences(data[m]) for m in (tmetrics, jmetrics))
    assert_identical(got, want)
    assert 0.5 < got["combined"]["HOTA"] < 0.8
    # the result type, as the evals return it
    res = tresults.ValidationResult(got)
    ref = jresults.ValidationResult(want)
    assert (res.hota, res.mota, res.idf1, res.summary()) == (ref.hota, ref.mota, ref.idf1,
                                                             ref.summary())


@pytest.mark.parametrize("per_class", [True, False], ids=["per-class", "all-classes"])
def test_obb_metric_stack_equals_jax(per_class, tmp_path):
    cfg = build_replay_config("bytetrack", is_obb=True)
    dets = mmot_obb_dets(MMOT)
    outputs = replay_sequences_outputs(cfg, [{"dets": d} for d in dets.values()], device="cpu")
    lengths = {s.name: s.seq_length for s in tmmot.MmotDataset(MMOT)}
    for name, (outs, masks) in zip(dets, outputs):
        rows = corner_rows(outs, masks)
        assert len(rows) > 20
        np.savetxt(tmp_path / f"{name}.txt", rows, delimiter=",", fmt="%.10g")
    classes = sorted({c for s in tmmot.MmotDataset(MMOT) for c in s.classes()})
    assert len(classes) > 1
    for cls_id in classes if per_class else [None]:
        got, want = (m.evaluate_obb_results(MMOT / "mot", tmp_path, seq_lengths=lengths,
                                            cls_id=cls_id) for m in (tmetrics, jmetrics))
        assert_identical(got, want, f"class {cls_id}")


def test_obb_to_corners_equals_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 1000, (50, 2)), rng.uniform(0, 80, (50, 2)),
                        rng.uniform(-np.pi, np.pi, (50, 1))], axis=1).astype(np.float32)
    x[:3, 2] = 0.0  # clamped at 1e-4
    assert_identical(tmetrics.obb_to_corners(x), jmetrics.obb_to_corners(x))


def test_mot_dataset_equals_jax():
    got, want = list(tmot.MOTDataset(MOT17)), list(jmot.MOTDataset(MOT17))
    assert [s.name for s in got] == [s.name for s in want] and len(got) == 2
    for g, w in zip(got, want):
        assert (g.seq_length, vars(g.info)) == (w.seq_length, vars(w.info))
        assert_identical(g.gt(), w.gt())
        assert_identical(g.dets_per_frame(), w.dets_per_frame())
    names = [got[1].name]
    assert [s.name for s in tmot.MOTDataset(MOT17, names=names)] == names


def test_mmot_dataset_equals_jax():
    got, want = list(tmmot.MmotDataset(MMOT)), list(jmmot.MmotDataset(MMOT))
    assert [s.name for s in got] == [s.name for s in want] and len(got) == 2
    for g, w in zip(got, want):
        assert (g.seq_length, g.classes()) == (w.seq_length, w.classes())
        assert_identical(g.gt, w.gt)
        assert_identical(g.gt_as_obb_dets(), w.gt_as_obb_dets())
    with pytest.raises(FileNotFoundError):
        tmmot.MmotDataset(MOT17)


def test_det_cache_and_mot_io_equal_jax(tmp_path, mot17_rows):
    assert tcache.det_cache_path(tmp_path, "d", "s") == jcache.det_cache_path(tmp_path, "d", "s")
    rng = np.random.default_rng(1)
    path = tcache.det_cache_path(tmp_path, "det", "seq")
    with jcache.AppendableNpyWriter(path, 7) as w:
        for f in (1, 2, 4):
            w.append(np.concatenate([np.full((5, 1), f), rng.uniform(0, 100, (5, 6))], axis=1))
    assert_identical(tcache.load_cached_dets_per_frame(path, 5),
                     jcache.load_cached_dets_per_frame(path, 5))
    out = rng.uniform(0, 500, (7, 8)).astype(np.float32)
    for rows in (out, out[:0]):
        assert_identical(tmot_io.convert_to_mot_format(rows, 3),
                         jmot_io.convert_to_mot_format(rows, 3))
    rows = mot17_rows[1][0]
    tmot_io.write_mot_results(tmp_path / "a" / "t.txt", rows)
    jmot_io.write_mot_results(tmp_path / "b" / "t.txt", rows)
    assert (tmp_path / "a" / "t.txt").read_bytes() == (tmp_path / "b" / "t.txt").read_bytes()


def test_id_allocator_and_track_results_equal_jax():
    got, want = tids.GlobalIdAllocator(), jids.GlobalIdAllocator()
    ids = np.array([1_000_001, 3, 2_000_001, 1_000_001, 7], np.float32)
    for a in (got, want):
        a.observe_created(1_000_001, 1_000_003)
        a.observe_created(1, 4)
    assert_identical(got.remap(ids), want.remap(ids))
    rng = np.random.default_rng(2)
    for cols in (8, 9):
        data = rng.uniform(0, 100, (4, cols)).astype(np.float32)
        g, w = ttr.TrackResults(data), jtr.TrackResults(data)
        for attr in ("xyxy", "xywh", "xywha", "id", "conf", "cls", "det_ind"):
            assert_identical(getattr(g, attr), getattr(w, attr), attr)
        assert (g.is_obb, g.to_json(), g.to_csv()) == (w.is_obb, w.to_json(), w.to_csv())
