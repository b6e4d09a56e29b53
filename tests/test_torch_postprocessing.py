"""The port's postprocessing (host copies of ``boxmot_tpu/postprocessing``)
against the JAX package's, and ``run_eval``'s ``postprocessing`` chain.

GSI, GBRC, GTA and ``linear_interpolation`` take the same seeded MOT rows
(and, for GTA, per-frame embeddings looked up by ``det_ind``) in both
packages and must give the same rows to the bit; the registry and file
chains must agree; ``run_eval(..., postprocessing=...)`` on the CPU must
give the JAX ``run_eval``'s metrics within 1e-4, with GSI on MOT17-mini and
with "gbrc,gta" over the seeded embedding caches of ``chip_smoke.reid_caches``.
"""

from __future__ import annotations

import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from boxmot_tpu import postprocessing as jpp
from boxmot_tpu.engine.eval import run_eval as jax_run_eval
from boxmot_tpu.postprocessing import gta as jgta
from boxmot_tpu.postprocessing.gsi import linear_interpolation as jax_linear
from boxmot_tpu_torch import postprocessing as tpp
from boxmot_tpu_torch.engine.eval import run_eval
from boxmot_tpu_torch.postprocessing import gta as tgta
from boxmot_tpu_torch.postprocessing.gsi import linear_interpolation
from tests.test_pinned_metrics import ROOTS

ATOL = 1e-4
METRICS = ("HOTA", "MOTA", "IDF1")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _one_jax_device(monkeypatch):
    """The JAX reference replays its sequences on one CPU device: the suite's
    eight virtual devices would shard them, which gives the same rows and
    compiles several times slower."""
    import jax

    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda backend=None: real(backend)[:1])


def seeded_scene(seed=0, n_frames=60, feat_dim=16):
    """MOT rows [frame, id, x, y, w, h, conf, cls, det_ind] and per-frame
    embeddings: track 1 one identity with dropped frames; track 2 two
    identities (a switch at frame 31); tracks 3 and 4 fragments of one
    identity (frames 1-25 and 32-60); every row's embedding is its
    identity's vector plus noise, at the row's ``det_ind`` in its frame; a
    few rows point past their frame's embeddings."""
    rng = np.random.default_rng(seed)
    bases = rng.normal(size=(5, feat_dim))
    spans = [(1, 0, range(1, n_frames + 1)), (2, 1, range(1, 31)), (2, 2, range(31, n_frames + 1)),
             (3, 3, range(1, 26)), (4, 3, range(32, n_frames + 1))]
    per_frame = {f: [] for f in range(1, n_frames + 1)}
    for tid, ident, frames in spans:
        x0, y0, vx, vy = rng.uniform(50, 800), rng.uniform(50, 400), *rng.normal(0, 3, 2)
        for f in frames:
            if tid == 1 and rng.random() < 0.15:
                continue  # a gap that GSI / GBRC interpolate
            box = [x0 + vx * f + rng.normal(0, 2), y0 + vy * f + rng.normal(0, 2),
                   40 + rng.normal(0, 1), 90 + rng.normal(0, 1)]
            per_frame[f].append((tid, box, float(rng.uniform(0.3, 1.0)),
                                 bases[ident] + rng.normal(0, 0.2, feat_dim)))
    rows, embs = [], []
    for f in range(1, n_frames + 1):
        frame_embs = []
        for tid, box, conf, emb in per_frame[f]:
            det_ind = len(frame_embs) if rng.random() > 0.05 else 99  # 99: no embedding
            if det_ind != 99:
                frame_embs.append(emb)
            rows.append([f, tid, *box, conf, 0, det_ind])
        embs.append(np.asarray(frame_embs, np.float32).reshape(-1, feat_dim))
    return np.asarray(rows, np.float64), embs


@pytest.mark.parametrize("interval", [3, 20])
def test_linear_interpolation_equals_jax(interval):
    rows, _ = seeded_scene(1)
    got, want = linear_interpolation(rows, interval), jax_linear(rows, interval)
    assert len(got) > len(rows) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kw", [("gsi", {}), ("gsi", {"interval": 5, "tau": 4}),
                                     ("gbrc", {}), ("gbrc", {"interval": 8})])
def test_smoothers_equal_jax(name, kw):
    rows, _ = seeded_scene(2)
    got = tpp.create_postprocessor(name, **kw)(rows)
    want = jpp.create_postprocessor(name, **kw)(rows)
    assert got.shape == want.shape and len(got) > len(rows)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"len_thres": 20, "min_samples": 5},
                                {"len_thres": 20, "min_samples": 5, "use_connect": False},
                                {"use_split": False, "merge_dist_thres": 0.6}])
def test_gta_equals_jax(kw):
    """Split (a mixed track) and connect (fragments of one identity) by
    DBSCAN and merged average cosine distances, the embeddings found by
    ``det_ind``; rows whose ``det_ind`` has no embedding are dropped."""
    rows, embs = seeded_scene(3)
    got = tpp.create_postprocessor("gta", **kw)(rows, embs_per_frame=embs)
    want = jpp.create_postprocessor("gta", **kw)(rows, embs_per_frame=embs)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert set(got[:, 1].astype(int)) != {1, 2, 3, 4}  # a split or a connect took place
    # no embeddings: the rows come back untouched, in both packages
    assert tpp.create_postprocessor("gta")(rows) is rows
    assert jpp.create_postprocessor("gta")(rows) is rows


def test_gta_pieces_equal_jax():
    rows, embs = seeded_scene(4)
    got, want = tgta.build_tracklets(rows, embs), jgta.build_tracklets(rows, embs)
    assert list(got) == list(want)
    for tid in want:
        g, w = got[tid], want[tid]
        assert (g.times, g.scores, g.bboxes, g.classes) == (w.times, w.scores, w.bboxes, w.classes)
        np.testing.assert_array_equal(np.stack(g.features), np.stack(w.features))
    feats = np.concatenate([np.stack(t.features) for t in want.values()])
    np.testing.assert_equal(tgta.detect_id_switch(feats, min_samples=5),
                            jgta.detect_id_switch(feats, min_samples=5))
    assert tgta.get_spatial_constraints(got, 1.0) == jgta.get_spatial_constraints(want, 1.0)
    np.testing.assert_array_equal(tgta.tracklets_to_rows(got), jgta.tracklets_to_rows(want))


def test_registry_and_chains_equal_jax(tmp_path):
    """The registry's names, classes and errors, and ``apply_chain`` /
    ``run`` over a folder of MOT files, as in the JAX package."""
    assert tpp.supported_postprocessors() == jpp.supported_postprocessors() == ("gbrc", "gsi", "gta")
    for name in ("gsi", "GBRC", " gta "):
        t, j = tpp.create_postprocessor(name), jpp.create_postprocessor(name)
        assert type(t).__name__ == type(j).__name__ and vars(t) == vars(j)
        assert inspect.getmodule(t).__name__.startswith("boxmot_tpu_torch.")
    for pkg in (tpp, jpp):
        with pytest.raises(ValueError, match="unknown postprocessor"):
            pkg.create_postprocessor("nosuch")
    rows, embs = seeded_scene(5)
    rows[:, 8] = np.where(rows[:, 8] == 99, -1, rows[:, 8])
    from boxmot_tpu.postprocessing.registry import apply_chain as jax_chain
    from boxmot_tpu_torch.postprocessing.registry import apply_chain

    for chain, gta_cls, folder in ((apply_chain, tgta.GTAPostprocessor, "port"),
                                   (jax_chain, jgta.GTAPostprocessor, "jax")):
        (tmp_path / folder).mkdir()
        for k in range(2):
            np.savetxt(tmp_path / folder / f"s{k}.txt", rows[rows[:, 1] != k + 1],
                       fmt="%d,%d,%d,%d,%d,%d,%.6f,%d,%d")
        (tmp_path / folder / "empty.txt").write_text("")
        chain("gsi,gbrc", tmp_path / folder)
        gta_cls(emb_source=lambda _seq: embs, len_thres=20, min_samples=5).run(tmp_path / folder)
    for name in ("s0.txt", "s1.txt", "empty.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    with pytest.raises(ValueError, match="emb_source"):
        tpp.create_postprocessor("gta").run(tmp_path / "port")


def _metrics(res):
    return {k: float(res["combined"][k]) for k in METRICS}


def _assert_close(got, want):
    for k in METRICS:
        assert abs(got[k] - want[k]) <= ATOL, (k, got, want)


def _rows(out_dir: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(out_dir.glob("*.txt"))}


def test_run_eval_gsi_equals_jax(tmp_path):
    """GSI over ByteTrack's rows on MOT17-mini: the JAX metrics, the same
    MOT files, the same ``progress`` calls, and a change from the plain
    eval; ``n_workers`` is accepted."""
    calls = {"port": [], "jax": []}
    got = run_eval(ROOTS["mot17_mini"], "bytetrack", device="cpu", postprocessing="gsi",
                   output_dir=tmp_path / "port", n_workers=2,
                   progress=lambda *a: calls["port"].append(a))
    want = jax_run_eval(ROOTS["mot17_mini"], "bytetrack", postprocessing="gsi",
                        output_dir=tmp_path / "jax", n_workers=2,
                        progress=lambda *a: calls["jax"].append(a))
    _assert_close(_metrics(got), _metrics(want))
    assert calls["port"] == calls["jax"] == [("MOT17-02-FRCNN", 1, 2), ("MOT17-04-FRCNN", 2, 2)]
    assert _rows(tmp_path / "port") == _rows(tmp_path / "jax")
    plain = run_eval(ROOTS["mot17_mini"], "bytetrack", device="cpu")
    assert _metrics(plain) != _metrics(got)


def test_run_eval_gbrc_gta_on_cached_embeddings_equals_jax(tmp_path):
    """BoT-SORT on synth-long from the seeded detection and embedding caches
    with "gbrc,gta": GTA reads each row's embedding through ``det_ind``
    (after the ``min_det_conf`` filter, which drops rows of the caches);
    the JAX metrics and MOT files, which GTA wrote (its rows carry no
    ``det_ind``)."""
    root = chip_smoke.reid_caches(tmp_path / "cache")
    kw = dict(cache_root=root, detector=chip_smoke.REID_DETECTOR, reid=chip_smoke.REID,
              min_det_conf=0.3, postprocessing="gbrc,gta")
    got = run_eval(ROOTS["synth_long"], "botsort", device="cpu", output_dir=tmp_path / "port",
                   **kw)
    want = jax_run_eval(ROOTS["synth_long"], "botsort", output_dir=tmp_path / "jax", **kw)
    _assert_close(_metrics(got), _metrics(want))
    rows = _rows(tmp_path / "port")
    assert rows == _rows(tmp_path / "jax")
    written = np.loadtxt(tmp_path / "port" / "SYNTH-01.txt", delimiter=",", ndmin=2)
    assert len(written) > 1000 and (written[:, 8] == -1).all()
