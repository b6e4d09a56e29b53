"""The port's own copies of the JAX package's host modules against the originals.

The port keeps copies of the dataset readers, the caches' loaders (the
segmentation mask cache among them), the MOT row writer, the result type,
the per-class id allocator, the HOTA/CLEAR/Identity metric stack and the
host tracker sam2mot, so that it imports nothing of ``boxmot_tpu``.  Here the same inputs
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


def test_emb_and_warp_caches_equal_jax(tmp_path):
    """The copied embedding and warp cache paths and loaders: the same files
    give the same per-frame arrays (frames without rows, frames out of range
    and an empty cache included)."""
    rng = np.random.default_rng(4)
    for args in (("root", "det", "osnet", "SEQ-1"), ("r", "d", "clip", "S", "crop")):
        assert tcache.emb_cache_path(*args) == jcache.emb_cache_path(*args)
    assert tcache.warp_cache_path("root", "ecc", "SEQ-1") == jcache.warp_cache_path("root", "ecc", "SEQ-1")
    emb_rows = np.concatenate([np.repeat([1, 3, 3, 6], [2, 1, 3, 1])[:, None],
                               rng.normal(size=(7, 16))], axis=1).astype(np.float32)
    warp_rows = np.concatenate([np.array([[2], [5], [9], [0]]),
                                rng.normal(size=(4, 6))], axis=1).astype(np.float32)
    for name, rows in (("embs", emb_rows), ("warps", warp_rows),
                       ("empty", np.zeros((0, 7), np.float32))):
        np.save(tmp_path / f"{name}.npy", rows)
    for name in ("embs", "empty"):
        want = jcache.load_cached_embs_per_frame(tmp_path / f"{name}.npy", 7)
        got = tcache.load_cached_embs_per_frame(tmp_path / f"{name}.npy", 7)
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    for name in ("warps", "empty"):
        want = jcache.load_cached_warps_per_frame(tmp_path / f"{name}.npy", 6)
        got = tcache.load_cached_warps_per_frame(tmp_path / f"{name}.npy", 6)
        assert got.dtype == want.dtype and got.shape == (6, 2, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["sof", "orb", "sift"])
def test_host_cmc_copies_equal_jax(name):
    """The copied host CMC estimators (SOF on its OpenCV path where cv2 is
    installed, ORB, SIFT with a working contrast threshold) give the JAX
    copies' warps on frames cropped from a textured scene 5 px right and 3 px
    down of each other; the numpy SOF path is held in tests/test_torch_cmc.py."""
    pytest.importorskip("cv2")
    from scipy.ndimage import gaussian_filter

    from boxmot_tpu.motion import cmc as jcmc
    from boxmot_tpu_torch.motion import cmc as tcmc

    rng = np.random.default_rng(5)
    scene = gaussian_filter(rng.uniform(0, 255, (900, 1300)), 4.0)
    scene = ((scene - scene.min()) / np.ptp(scene) * 255).astype(np.uint8)
    kw = {"contrast_threshold": 0.04} if name == "sift" else {}
    jest, test = jcmc.create_cmc(name, **kw), tcmc.create_cmc(name, **kw)
    dets = np.array([[300, 200, 420, 500]], np.float32)
    moved = 0
    for f in range(4):
        y, x = 40 + 3 * f, 60 + 5 * f
        img = np.ascontiguousarray(np.repeat(scene[y:y + 720, x:x + 1080, None], 3, axis=2))
        want, got = jest.apply(img, dets), test.apply(img, dets)
        np.testing.assert_array_equal(got, want)
        moved += int(np.abs(got[:, 2] - (-5.0, -3.0)).max() < 1.5)  # the camera's step
    assert moved >= 2


def test_mask_cache_equals_jax(tmp_path):
    """The mask cache's path, packing, unpacking and per-frame loading."""
    rng = np.random.default_rng(3)
    masks = rng.uniform(size=(5, 120, 200)) < 0.3
    assert tcache.MASK_SIDE == jcache.MASK_SIDE
    assert tcache.mask_cache_path(tmp_path, "det", "S1") == jcache.mask_cache_path(tmp_path, "det", "S1")
    rows = [m.pack_masks(3, masks) for m in (tcache, jcache)]
    assert_identical(rows[0], rows[1])
    assert_identical(tcache.pack_masks(1, masks[:0]), jcache.pack_masks(1, masks[:0]))
    for hw in ((120, 200), (37, 51)):
        assert_identical(tcache.unpack_masks(rows[0], hw), jcache.unpack_masks(rows[0], hw))
    path = tmp_path / "m.npy"
    np.save(path, np.concatenate([rows[0], jcache.pack_masks(1, masks[:2])]))
    got, want = (m.load_cached_masks_per_frame(path, 4, (120, 200)) for m in (tcache, jcache))
    assert_identical(got, want)
    assert [len(g) for g in got] == [2, 0, 5, 0]


def test_sam2mot_is_a_copy_of_the_original():
    """The port's sam2mot.py is the JAX module below its docstring, but for
    the imports of the port's base and result type and the ``device``
    argument it takes and ignores."""
    import inspect

    from boxmot_tpu.trackers import sam2mot as jsam
    from boxmot_tpu_torch.trackers import sam2mot as tsam

    def body(module):
        src = inspect.getsource(module)
        return src[src.index("from __future__"):].splitlines()

    want = [line.replace("from boxmot_tpu.", "from boxmot_tpu_torch.") for line in body(jsam)]
    got = body(tsam)
    extra = [line for line in got if line not in want]
    assert extra == ["        device=None,",
                     '            device="cpu",  # a host tracker: ``device`` is taken and ignored']
    assert [line for line in got if line not in extra] == want


def test_reid_datasets_is_a_copy_of_the_original():
    """The port's reid/datasets.py is the JAX module below its docstring."""
    import inspect

    from boxmot_tpu.reid import datasets as jds
    from boxmot_tpu_torch.reid import datasets as tds

    def body(module):
        src = inspect.getsource(module)
        return src[src.index("from __future__"):]

    assert body(tds) == body(jds)


def _reid_img(path, seed):
    import cv2

    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    cv2.imwrite(str(path), rng.integers(0, 256, (40, 20, 3), dtype=np.uint8))


def test_reid_datasets_equal_jax(tmp_path):
    """The Market-1501 fixture and synthetic DukeMTMC, CUHK03, VeRi-776 and
    MSMT17 trees index the same items in both packages; P x K batches (the
    sampler, the images, every augmentation) are the same arrays."""
    from boxmot_tpu.reid import datasets as jds
    from boxmot_tpu_torch.reid import datasets as tds

    for pid in (1, 2, 3):
        for cam in (1, 2):
            _reid_img(tmp_path / "DukeMTMC-reID" / "bounding_box_train" / f"{pid:04d}_c{cam}_f1.jpg",
                      pid * cam)
    _reid_img(tmp_path / "DukeMTMC-reID" / "query" / "0001_c1_f2.jpg", 10)
    _reid_img(tmp_path / "DukeMTMC-reID" / "bounding_box_test" / "-1_c2_f3.jpg", 11)
    _reid_img(tmp_path / "cuhk03" / "bounding_box_train" / "0007_c1_1.png", 12)
    _reid_img(tmp_path / "VeRi" / "image_train" / "0005_c002_00030600_0.jpg", 13)
    ms = tmp_path / "MSMT17"
    _reid_img(ms / "train" / "0000" / "0000_000_01_0303morning_0015_0.jpg", 14)
    _reid_img(ms / "test" / "0001" / "0001_000_02_0303morning_0015_0.jpg", 15)
    (ms / "list_train.txt").write_text("0000/0000_000_01_0303morning_0015_0.jpg 0\nbad line x\n")
    (ms / "list_query.txt").write_text("0001/0001_000_02_0303morning_0015_0.jpg 1\n")
    (ms / "list_gallery.txt").write_text("0001/0001_000_02_0303morning_0015_0.jpg 1\n")
    for name, root in (("market1501", ASSETS / "reid-mini"), ("duke", tmp_path),
                       ("cuhk03", tmp_path), ("veri", tmp_path), ("msmt17", ms)):
        got, want = tds.load_dataset(name, root), jds.load_dataset(name, root)
        for split in ("train", "query", "gallery"):
            assert getattr(got, split) == getattr(want, split), (name, split)
        assert got.num_train_pids == want.num_train_pids
    got, want = tds.MSMT17(ms, merged=True), jds.MSMT17(ms, merged=True)
    assert got.train == want.train
    for module in (tds, jds):
        with pytest.raises(ValueError, match="unknown reid dataset"):
            module.load_dataset("imagenet", tmp_path)
        with pytest.raises(FileNotFoundError):
            module.load_dataset("market1501", tmp_path / "none")

    items = tds.load_dataset("duke", tmp_path).train
    aug = {"erase_p": 0.9, "color_jitter": True, "gaussian_blur": True, "grayscale_p": 0.5}
    for step in range(4):
        batches = []
        for module in (tds, jds):
            rng = np.random.default_rng((3, step))
            sampler = module.PKSampler(items, 2, 3, seed=0)
            sampler.rng = rng
            idxs = sampler.sample_batch()
            batches.append((idxs, *module.make_batch(items, idxs, (32, 16), rng=rng,
                                                     aug_kwargs=aug)))
        assert batches[0][0] == batches[1][0]
        assert_identical(batches[0][1], batches[1][1])
        assert_identical(batches[0][2], batches[1][2])
