"""The port's cache writer, frame cache and the host side of cache
generation (``data/cache.py::AppendableNpyWriter``, ``data/frame_cache.py``,
``engine/generate.py``) against the JAX package's, on the CPU, with no
model: MOT17-mini's public detections and a box-derived embedding
(caches byte-equal, also resumed from a cut cache), the frame cache's three
tiers, ``frame_group`` with ``batch_size`` (Queue C item 3: a warning, then
the JAX package's caches), the embeddings-only fill over a named
detector's cache, and a detector of oriented boxes.
``tests/test_torch_generate.py`` holds the caches the models write.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest

from boxmot_tpu.data import cache as jcache
from boxmot_tpu.data import frame_cache as jframe_cache
from boxmot_tpu.detectors.base import Detections as JaxDetections
from boxmot_tpu.engine import generate as jgenerate
from boxmot_tpu_torch.data import cache as tcache
from boxmot_tpu_torch.data import frame_cache as tframe_cache
from boxmot_tpu_torch.detectors.base import Detections
from boxmot_tpu_torch.engine import generate as tgenerate
from boxmot_tpu_torch.engine.results import GenerateResult
from tests.test_torch_generate import FIXTURE, SEQ, FakeReID, npy_files


def test_writer_equals_jax(tmp_path):
    """The same rows, and a resumed run, give byte-equal files; a cache of
    another width raises in both."""
    rng = np.random.default_rng(0)
    rows = [rng.normal(size=(n, 5)).astype(np.float32) for n in (3, 0, 4, 1)]
    for mod, name in ((jcache, "jax"), (tcache, "port")):
        with mod.AppendableNpyWriter(tmp_path / f"{name}.npy", 5) as w:
            for r in rows:
                w.append(r)
        with mod.AppendableNpyWriter(tmp_path / f"{name}_resumed.npy", 5) as w:
            w.append(rows[0])
        with mod.AppendableNpyWriter(tmp_path / f"{name}_resumed.npy", 5) as w:
            assert w.rows == 3
            for r in rows[1:]:
                w.append(r)
        with pytest.raises(ValueError, match="expected"):
            mod.AppendableNpyWriter(tmp_path / f"{name}.npy", 6)
    files = {p.name: p.read_bytes() for p in tmp_path.glob("*.npy")}
    assert files["port.npy"] == files["jax.npy"] == files["port_resumed.npy"] == \
        files["jax_resumed.npy"]
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), np.concatenate(rows))


def test_frame_cache_equals_jax(tmp_path):
    """``read_frame`` (JPEG through PIL as BGR, ``.npy`` frames) and each of
    ``FrameCache``'s tiers give the JAX package's bytes."""
    paths = sorted((FIXTURE / SEQ / "img1").glob("*.jpg"))[:2]
    gray = np.random.default_rng(1).integers(0, 256, (40, 60), dtype=np.uint8)
    np.save(tmp_path / "gray.npy", gray)
    np.save(tmp_path / "rgba.npy", np.random.default_rng(2).integers(0, 256, (40, 60, 4),
                                                                      dtype=np.uint8))
    paths += [tmp_path / "gray.npy", tmp_path / "rgba.npy"]
    for p in paths:
        np.testing.assert_array_equal(tframe_cache.read_frame(p), jframe_cache.read_frame(p))
    huge = 1 << 60
    for kw, mode in (({}, "decoded"), ({"budget_fraction": 1.0, "min_free_bytes": 0,
                                        "n_peers": huge}, "none")):
        tc = tframe_cache.FrameCache(paths, **kw)
        jc = jframe_cache.FrameCache(paths, **kw)
        assert tc.mode == jc.mode == mode and tc.cached_bytes == jc.cached_bytes
        for p in paths:
            np.testing.assert_array_equal(tc.read_image(p), jc.read_image(p))
    # the raw tier: bytes in RAM, decoded on access (budget between the two sizes)
    disk = sum(p.stat().st_size for p in paths)
    avail = tframe_cache.available_ram_bytes()
    kw = {"budget_fraction": 1.0, "min_free_bytes": 0, "n_peers": max(1, avail // (2 * disk))}
    with tframe_cache.FrameCache(paths, **kw) as tc:
        jc = jframe_cache.FrameCache(paths, **kw)
        assert tc.mode == jc.mode == "raw" and tc.cached_bytes == jc.cached_bytes == disk
        for p in paths:
            np.testing.assert_array_equal(tc.read_image(p), jc.read_image(p))
    assert tc.mode == "none" and not tc.active


def test_public_caches_byte_equal(tmp_path):
    """MOT17-mini's public detections and a box-derived embedding (with the
    AutoBatcher), written by both packages, then resumed from a cut cache."""
    for mod, name in ((jgenerate, "jax"), (tgenerate, "port")):
        stats = mod.run_generate(FIXTURE, tmp_path / name, reid_model=FakeReID(), batch_size=3)
        assert stats == {"MOT17-02-FRCNN": {"dets": 51, "embs": 51, "masks": 0},
                         "MOT17-04-FRCNN": {"dets": 205, "embs": 205, "masks": 0}}
    assert isinstance(stats, GenerateResult) and stats.total_dets == 256
    want = npy_files(tmp_path / "jax")
    assert npy_files(tmp_path / "port") == want and len(want) == 4
    # cut mid-frame, then resumed: the same bytes
    for rel, cols in (("public/dets/MOT17-04-FRCNN.npy", 7),
                      ("public/embs/fake_reid/resize/MOT17-04-FRCNN.npy", 9)):
        full = np.load(tmp_path / "port" / rel)
        with tcache.AppendableNpyWriter(tmp_path / "cut" / rel, cols) as w:
            w.append(full[:37])
    tgenerate.run_generate(FIXTURE, tmp_path / "cut", reid_model=FakeReID())
    assert npy_files(tmp_path / "cut") == want


def test_embeddings_only_fill_keeps_a_named_cache(tmp_path):
    """A named detector's det cache with fewer rows than det.txt: the JAX
    fill appends det.txt rows to it; the port reads it as it is."""

    class TwoBoxes:
        def __call__(self, img):
            b = np.array([[10, 10, 60, 90], [100, 40, 170, 140]], np.float32)
            return Detections(xyxy=b, conf=np.array([0.9, 0.8], np.float32),
                              cls=np.zeros(2, np.float32))

    for mod, name in ((jgenerate, "jax"), (tgenerate, "port")):
        mod.run_generate(FIXTURE, tmp_path / name, detector="two", detector_model=TwoBoxes())
        stats = mod.run_generate(FIXTURE, tmp_path / name, detector="two",
                                 reid_model=FakeReID())
        rows = np.load(tcache.det_cache_path(tmp_path / name, "two", SEQ))
        if name == "jax":
            assert len(rows) > 8 and stats[SEQ]["dets"] == 51  # det.txt rows appended
        else:
            assert len(rows) == 8 and stats[SEQ]["dets"] == stats[SEQ]["embs"] == 8


def test_frame_group_with_batch_size_warns(tmp_path):
    """Queue C item 3: frame_group with batch_size warns, then writes the
    JAX package's caches (which ignores the grouping without a word)."""
    jgenerate.run_generate(FIXTURE, tmp_path / "jax", reid_model=FakeReID(), batch_size=4,
                           frame_group=4)
    with pytest.warns(UserWarning, match="frame_group=4 is ignored when batch_size is set"):
        tgenerate.run_generate(FIXTURE, tmp_path / "port", reid_model=FakeReID(), batch_size=4,
                               frame_group=4)
    assert npy_files(tmp_path / "port") == npy_files(tmp_path / "jax")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # either alone: no warning
        tgenerate.run_generate(FIXTURE, tmp_path / "a", reid_model=FakeReID(), frame_group=4)
        tgenerate.run_generate(FIXTURE, tmp_path / "b", reid_model=FakeReID(), batch_size=4)


def test_oriented_detections_raise_before_writing(tmp_path):
    """An OBB detector: the port raises naming the cause and writes nothing;
    the JAX writer raises in its reshape (2 boxes: 16 values) or writes
    garbled rows (7 boxes: 56 values, 8 rows of 7)."""

    def obb(n, package):
        xywha = np.tile(np.array([[50, 60, 20, 40, 0.3]], np.float32), (n, 1))
        cls = (package.Detections if hasattr(package, "Detections") else package)
        return lambda img: cls(xyxy=np.zeros((n, 4), np.float32), conf=np.full(n, 0.9,
                               np.float32), cls=np.zeros(n, np.float32), is_obb=True,
                               xywha=xywha)

    with pytest.raises(ValueError, match="oriented boxes"):
        tgenerate.run_generate(FIXTURE, tmp_path / "port", detector="obb",
                               detector_model=obb(2, Detections))
    assert not list((tmp_path / "port").rglob("*.npy"))
    with pytest.raises(ValueError, match="reshape"):
        jgenerate.run_generate(FIXTURE, tmp_path / "jax2", detector="obb",
                               detector_model=obb(2, JaxDetections))
    jgenerate.run_generate(FIXTURE, tmp_path / "jax7", detector="obb",
                           detector_model=obb(7, JaxDetections))
    rows = np.load(jcache.det_cache_path(tmp_path / "jax7", "obb", SEQ))
    assert rows.shape == (32, 7) and not (rows[:, 0] == np.repeat(np.arange(1, 5), 8)).all()


def test_run_generate_defaults_to_the_card(tmp_path):
    """``device`` (ECC's) defaults to "cuda"; without a card the default
    raises and never falls back to the CPU."""
    import inspect

    import torch

    import boxmot_tpu_torch

    assert boxmot_tpu_torch.run_generate is tgenerate.run_generate
    assert inspect.signature(tgenerate.run_generate).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tgenerate.run_generate(FIXTURE, tmp_path, cmc_method="ecc")
