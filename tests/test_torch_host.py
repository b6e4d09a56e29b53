"""The port's own copies of the JAX package's host modules against the originals.

The port keeps copies of the dataset readers, the caches' loaders (the
segmentation mask cache among them), the MOT row writer, the result types,
the per-class id allocator, the HOTA/CLEAR/Identity metric stack, the
host tracker sam2mot and the ONNX wire format, builder and evaluator, so
that it imports nothing of ``boxmot_tpu``.  Here the same inputs
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

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "assets"
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


@pytest.fixture(scope="module")
def mmot_rows():
    """ByteTrack OBB's corner rows of each mmot-mini sequence, replayed once
    for both cases below."""
    cfg = build_replay_config("bytetrack", is_obb=True)
    dets = mmot_obb_dets(MMOT)
    outputs = replay_sequences_outputs(cfg, [{"dets": d} for d in dets.values()], device="cpu")
    return {name: corner_rows(outs, masks) for name, (outs, masks) in zip(dets, outputs)}


@pytest.mark.parametrize("per_class", [True, False], ids=["per-class", "all-classes"])
def test_obb_metric_stack_equals_jax(per_class, tmp_path, mmot_rows):
    lengths = {s.name: s.seq_length for s in tmmot.MmotDataset(MMOT)}
    for name, rows in mmot_rows.items():
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


def test_export_result_is_a_copy_of_the_original():
    import inspect

    assert inspect.getsource(tresults.ExportResult) == inspect.getsource(jresults.ExportResult)
    info = {"onnx": {"path": Path("m.onnx"), "max_dev": 1e-6}, "checkpoint": {"path": "m.msgpack"}}
    got, want = tresults.ExportResult(info), jresults.ExportResult(info)
    assert got == want and got.summary() == want.summary() and got.onnx == want.onnx


def seeded_graph(builder_cls, rng):
    """A graph over most of the evaluator's ops, with seeded initializers and
    every attribute kind."""
    b = builder_cls("seeded")
    b.add_input("x", [2, 3, 8, 6], np.float32)
    w = b.constant(rng.normal(0, 0.3, (4, 3, 3, 3)).astype(np.float32), "w")
    bias = b.constant(rng.normal(0, 0.1, 4).astype(np.float32), "b")
    y = b.node("Conv", ["x", w, bias], strides=[1, 1], pads=[1, 1, 1, 1], dilations=[1, 1],
               group=1)
    y = b.node("Max", [y, b.constant(np.float32(0.0))])
    m = b.node("MaxPool", [y], kernel_shape=[2, 2], strides=[2, 2], pads=[0, 0, 0, 0])
    a = b.node("AveragePool", [y], kernel_shape=[2, 2], strides=[2, 2], pads=[0, 0, 0, 0],
               count_include_pad=1)
    y = b.node("Add", [m, b.node("Mul", [a, b.constant(np.float32(0.5))])])
    mean = b.node("ReduceMean", [y], axes=[2, 3], keepdims=1)
    y = b.node("Sub", [y, mean])
    y = b.node("Erf", [b.node("Div", [y, b.node("Sqrt", [b.constant(np.float32(2.0))])])])
    y = b.node("Transpose", [y], perm=[0, 2, 3, 1])
    y = b.node("Reshape", [y, b.constant(np.array([2, 48], np.int64))])
    y = b.node("Slice", [y, *(b.constant(np.array(v, np.int64)) for v in ([0], [40], [1], [1]))])
    dense = b.constant(rng.normal(0, 0.2, (40, 5)).astype(np.float32), "dense")
    y = b.node("MatMul", [y, dense])
    e = b.node("Exp", [b.node("Sub", [y, b.node("ReduceMax", [y], axes=[1], keepdims=1)])])
    y = b.node("Div", [e, b.node("ReduceSum", [e, b.constant(np.array([1], np.int64))],
                                 keepdims=1)])
    y = b.node("Concat", [y, b.node("Sigmoid", [y])], axis=1)
    y = b.node("Gather", [y, b.constant(np.array([3, 0, 9], np.int64))], axis=1)
    y = b.node("Pad", [y, b.constant(np.array([0, 1, 0, 2], np.int64)),
                       b.constant(np.float32(-1.0))])
    b.node("Identity", [y], outputs=["y"], note="seeded", scale=0.25)
    b.add_output("y", [2, 6], np.float32)
    return b


def test_onnxlite_copies_encode_and_run_as_jax():
    """The copied builder (and the port's ``Builder``, which joins its parts
    once) writes the JAX GraphBuilder's bytes for a seeded graph; the copied
    evaluator runs it to the JAX evaluator's outputs, to the bit."""
    from boxmot_tpu.onnxlite import builder as jbuilder
    from boxmot_tpu.onnxlite import runtime as jruntime
    from boxmot_tpu_torch.onnxlite import builder as tbuilder
    from boxmot_tpu_torch.onnxlite import runtime as truntime
    from boxmot_tpu_torch.onnxlite.export import Builder

    blobs = [seeded_graph(cls, np.random.default_rng(4)).serialize()
             for cls in (jbuilder.GraphBuilder, tbuilder.GraphBuilder, Builder)]
    assert blobs[0] == blobs[1] == blobs[2]
    x = np.random.default_rng(5).normal(size=(2, 3, 8, 6)).astype(np.float32)
    got, want = truntime.run_onnx(blobs[1], [x])[0], jruntime.run_onnx(blobs[0], [x])[0]
    assert got.shape == (2, 6) and np.isfinite(got).all()
    assert_identical(got, want)
    nodes, inits, ins, outs = truntime.decode_model(blobs[1])
    assert nodes[-1].attrs == {"note": "seeded", "scale": 0.25} and (ins, outs) == (["x"], ["y"])


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


# -- the front door's host copies: config data, postprocessing, calibration,
# -- data makers, reporters, plots, the visualization mixin

JAX_PKG, PORT_PKG = REPO / "boxmot_tpu", REPO / "boxmot_tpu_torch"
CONFIG_YAMLS = sorted(p.relative_to(JAX_PKG / "configs")
                      for p in (JAX_PKG / "configs").rglob("*.yaml"))
COPIED_MODULES = ("motion/calibration.py", "postprocessing/__init__.py", "postprocessing/base.py",
                  "postprocessing/gsi.py", "postprocessing/gbrc.py", "postprocessing/gta.py",
                  "postprocessing/registry.py", "data/synth.py", "data/mot17_parquet.py",
                  "utils/fmt.py", "utils/reporters.py", "utils/rich_ui.py", "engine/plots.py",
                  "trackers/visualization.py", "configs/benchmark.py", "onnxlite/proto.py",
                  "onnxlite/builder.py", "onnxlite/runtime.py", "data/mot.py",
                  "trackers/per_class_ids.py", "engine/mot_io.py", "engine/results.py")


def _below_docstring(path: Path) -> str:
    import ast

    src = path.read_text()
    doc = ast.parse(src).body[0]
    return "".join(src.splitlines(keepends=True)[doc.end_lineno:])


def test_every_config_yaml_is_copied():
    port = sorted(p.relative_to(PORT_PKG / "configs") for p in (PORT_PKG / "configs").rglob("*.yaml"))
    assert port == CONFIG_YAMLS and len(port) == 31


@pytest.mark.parametrize("rel", CONFIG_YAMLS, ids=[str(p) for p in CONFIG_YAMLS])
def test_config_yaml_loads_equal_to_jax(rel):
    """Each tracker spec, tuned overlay, benchmark, training recipe and the
    modes load equal to the JAX file, and read through the port's readers
    as through the JAX ones."""
    import yaml

    from boxmot_tpu import configs as jcfg
    from boxmot_tpu.configs import benchmark as jbench
    from boxmot_tpu_torch import configs as tcfg
    from boxmot_tpu_torch.configs import benchmark as tbench

    with open(PORT_PKG / "configs" / rel) as f, open(JAX_PKG / "configs" / rel) as g:
        assert yaml.safe_load(f) == yaml.safe_load(g)
    name, kind = rel.stem, rel.parts[0]
    if kind == "trackers" and len(rel.parts) == 2:
        assert tcfg.load_tracker_config(name) == jcfg.load_tracker_config(name)
        assert tcfg.flatten_specs(tcfg.load_tracker_config(name)) == jcfg.flatten_specs(
            jcfg.load_tracker_config(name))
        assert tcfg.get_tracker_defaults(name) == jcfg.get_tracker_defaults(name)
        assert tcfg.get_tracker_config_path(name) == PORT_PKG / "configs" / rel
    elif kind == "trackers":
        assert tcfg.load_tuned_config(name) == jcfg.load_tuned_config(name)
    elif kind == "benchmarks":
        assert tbench.load_benchmark(name) == jbench.load_benchmark(name)
        cfg = tbench.load_benchmark(name)
        assert tbench.resolve_split_dir(cfg) == jbench.resolve_split_dir(cfg)
    elif kind == "training":
        values = tcfg.load_training_recipe(name)
        assert values == jcfg.load_training_recipe(name)
        assert tcfg.train_config_kwargs_from_recipe(values) == \
            jcfg.train_config_kwargs_from_recipe(values)
    else:
        for mode in ("track", "generate", "eval", "tune", "research", "train", "shared"):
            assert tcfg.get_mode_defaults(mode) == jcfg.get_mode_defaults(mode)
        payload = {"tracker": "ocsort", "new_key": 1}
        assert vars(tcfg.build_mode_namespace("eval", payload, ["tracker"])) == vars(
            jcfg.build_mode_namespace("eval", payload, ["tracker"]))


def test_config_readers_agree_with_jax_on_names_and_errors():
    from boxmot_tpu import configs as jcfg
    from boxmot_tpu.configs import benchmark as jbench
    from boxmot_tpu_torch import configs as tcfg
    from boxmot_tpu_torch.configs import benchmark as tbench

    assert tcfg.available_tuned_configs() == jcfg.available_tuned_configs()
    assert tcfg.list_training_recipes() == jcfg.list_training_recipes()
    assert tbench.available_benchmarks() == jbench.available_benchmarks()
    assert tbench.resolve_split_dir(tbench.load_benchmark("mot17-mini")) == MOT17
    for fn, arg, err in ((tcfg.load_tuned_config, "bytetrack_x_y", ValueError),
                         (tcfg.load_training_recipe, "nosuch", ValueError),
                         (tcfg.get_mode_defaults, "nosuch", ValueError),
                         (tcfg.get_tracker_config_path, "nosuch", FileNotFoundError),
                         (tbench.load_benchmark, "nosuch", ValueError)):
        with pytest.raises(err):
            fn(arg)
    with pytest.raises(ValueError, match="unknown training-recipe key"):
        tcfg.train_config_kwargs_from_recipe({"nosuch": 1})
    for values in ({"batch_size": 64, "k_instances": 8}, {"batch_size": 64}):
        assert tcfg.train_config_kwargs_from_recipe(values) == \
            jcfg.train_config_kwargs_from_recipe(values)


@pytest.mark.parametrize("rel", COPIED_MODULES)
def test_host_module_is_a_copy_of_the_original(rel):
    """Below its docstring each copy is the JAX module's text, with the
    package's name in its imports (and the registry's module paths)."""
    import re

    want = re.sub(r"\bboxmot_tpu\.", "boxmot_tpu_torch.", _below_docstring(JAX_PKG / rel))
    assert _below_docstring(PORT_PKG / rel) == want
    assert (PORT_PKG / rel).read_text().startswith(f'"""A copy of ``boxmot_tpu/{rel}``.')


def test_synth_write_sequence_writes_the_same_bytes(tmp_path):
    from boxmot_tpu.data import synth as jsynth
    from boxmot_tpu_torch.data import synth as tsynth

    for kw in ({}, {"name": "SYNTH-02"}):
        sc_t, sc_j = tsynth.mot17_scale_scenario(seed=3, n_frames=30), \
            jsynth.mot17_scale_scenario(seed=3, n_frames=30)
        a = tsynth.write_sequence(tmp_path / "port", scenario=sc_t, **kw)
        b = jsynth.write_sequence(tmp_path / "jax", scenario=sc_j, **kw)
        for rel in ("seqinfo.ini", "gt/gt.txt", "det/det.txt"):
            assert (a / rel).read_bytes() == (b / rel).read_bytes()
    a = tsynth.write_sequence(tmp_path / "port", name="LIFE")
    b = jsynth.write_sequence(tmp_path / "jax", name="LIFE")
    assert (a / "gt" / "gt.txt").read_bytes() == (b / "gt" / "gt.txt").read_bytes()


def test_mot17_parquet_equals_jax(tmp_path):
    pytest.importorskip("pyarrow")
    from boxmot_tpu.data import mot17_parquet as jpq
    from boxmot_tpu_torch.data import mot17_parquet as tpq
    from tests.test_mot17_parquet import _make_snapshot

    snap = _make_snapshot(tmp_path / "snap")
    assert [tpq.ablation_start(n) for n in (10, 600)] == [jpq.ablation_start(n) for n in (10, 600)]
    for split in ("train", "ablation"):
        a = tpq.setup_mot17_from_parquet(tmp_path / "port", split=split, parquet_root=snap,
                                         cache_root=tmp_path / "port_cache")
        b = jpq.setup_mot17_from_parquet(tmp_path / "jax", split=split, parquet_root=snap,
                                         cache_root=tmp_path / "jax_cache")
        files = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
        assert files == sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file()) and files
        for rel in files:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    caches = sorted(p.relative_to(tmp_path / "jax_cache")
                    for p in (tmp_path / "jax_cache").rglob("*.npy"))
    assert caches
    for rel in caches:
        np.testing.assert_array_equal(np.load(tmp_path / "port_cache" / rel),
                                      np.load(tmp_path / "jax_cache" / rel))


def test_reporters_rich_ui_fmt_and_misc_equal_jax(tmp_path):
    import io

    from rich.console import Console

    from boxmot_tpu.utils import fmt as jfmt
    from boxmot_tpu.utils import misc as jmisc
    from boxmot_tpu.utils import reporters as jrep
    from boxmot_tpu.utils import rich_ui as jui
    from boxmot_tpu_torch.utils import fmt as tfmt
    from boxmot_tpu_torch.utils import misc as tmisc
    from boxmot_tpu_torch.utils import reporters as trep
    from boxmot_tpu_torch.utils import rich_ui as tui

    assert [tfmt.as_percent(v) for v in (0.5, -1.2, 64.9)] == \
        [jfmt.as_percent(v) for v in (0.5, -1.2, 64.9)]
    args = dict(benchmark="mot17-mini", data=str(MOT17), tracker="ocsort", tuned=None,
                postprocessing="gsi", detector="public", reid="osnet_x0_25", n_workers=1)

    def drive(rep, ui):
        out = io.StringIO()
        console = Console(file=out, width=100, force_terminal=False, color_system=None)
        with rep.EvalReporter(**args).start(True, console=console) as wp:
            for step in (rep.SETUP, rep.TRACK):
                wp.start_step(step)
                wp.advance("sequences", 1, 2)
                wp.finish_step(step)
        ui.metrics_table({"A": {"HOTA": 0.5, "MOTA": -0.2, "IDF1": 0.7}}, title="t",
                         console=console)
        feed = rep.TrialFeed()
        feed.record({"index": 0, "score": 0.5, "metrics": {"HOTA": 0.5}, "params": {"a": 1}})
        return (out.getvalue(), rep.EvalReporter(**args).fields(), rep.eval_steps(postprocess=True),
                feed.log_line(feed.rows[0]), rep.compact_model_name("x/osnet_x0_25.pt"))

    got, want = drive(trep, tui), drive(jrep, jui)
    assert got[1:] == want[1:]
    # the live progress redraws by wall time; its final frame and the table match
    assert got[0].splitlines()[-8:] == want[0].splitlines()[-8:]
    for mod in (tmisc, jmisc):
        for _ in range(2):
            mod.increment_path(tmp_path / mod.__name__ / "exp", mkdir=True)
        (tmp_path / mod.__name__ / "f.txt").write_text("x")
    assert tmisc.increment_path(tmp_path / tmisc.__name__ / "exp").name == \
        jmisc.increment_path(tmp_path / jmisc.__name__ / "exp").name == "exp3"
    assert tmisc.increment_path(tmp_path / tmisc.__name__ / "f.txt").name == "f2.txt"
    assert [tmisc.parse_imgsz(v) for v in (640, "640", "384,640", (1, 2), None)] == \
        [jmisc.parse_imgsz(v) for v in (640, "640", "384,640", (1, 2), None)]
    assert tmisc.select_device("cpu") == torch.device("cpu")
    info = tmisc.get_system_info()
    assert info["torch"] == torch.__version__ and info["n_devices"] == torch.cuda.device_count()
    if not torch.cuda.is_available():
        for spec in ("", "cuda", "0", "cuda:1"):
            with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
                tmisc.select_device(spec)


def test_plots_equal_jax(tmp_path):
    pytest.importorskip("matplotlib")
    from boxmot_tpu.engine import plots as jplots
    from boxmot_tpu_torch.engine import plots as tplots

    results = {"bytetrack": {"HOTA": 0.64, "MOTA": 0.49, "IDF1": 0.66, "AssA": 0.7, "DetA": 0.6},
               "ocsort": {"HOTA": 0.65, "MOTA": 0.48, "IDF1": 0.65, "AssA": 0.71, "DetA": 0.59}}
    a = tplots.plot_eval_summary(results, tmp_path / "port")
    b = jplots.plot_eval_summary(results, tmp_path / "jax")
    assert [p.name for p in a] == [p.name for p in b]
    for p, q in zip(a, b):
        assert p.read_bytes() == q.read_bytes()
    fps = {name: {**m, "fps": 900.0 - 200 * k} for k, (name, m) in enumerate(results.items())}
    assert tplots.plot_fps_metric(fps, tmp_path / "p.png").read_bytes() == \
        jplots.plot_fps_metric(fps, tmp_path / "j.png").read_bytes()


def test_replay_sequence_frame_offset_equals_jax():
    from boxmot_tpu.engine import replay as jreplay
    from boxmot_tpu.engine.eval import build_replay_config as jax_config
    from boxmot_tpu_torch.engine import replay as treplay

    dets = list(tmot.MOTSequence(MOT17 / "MOT17-02-FRCNN").dets_per_frame())
    for offset in (0, 7):
        got = treplay.replay_sequence(build_replay_config("bytetrack"), dets, frame_offset=offset,
                                      device="cpu")
        want = jreplay.replay_sequence(jax_config("bytetrack"), dets, frame_offset=offset)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got[:, [0, 1, 7, 8]], want[:, [0, 1, 7, 8]])
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        assert got[:, 0].min() == offset + 1


@pytest.mark.parametrize("tracker,per_class", [
    ("bytetrack", False), ("bytetrack", True), ("sfsort", False), ("ocsort", False),
    ("botsort", False), ("strongsort", False), ("occluboost", False)])
def test_live_display_rows_and_plots_equal_jax(tracker, per_class):
    """The visualization mixin on the live shells: the lost slots' predicted
    rows (``show_kf_preds``; per-class banks renumber their ids), the display
    history and the drawn frames equal the JAX shell's."""
    import boxmot_tpu
    import boxmot_tpu_torch

    seq = tmot.MOTSequence(MOT17 / "MOT17-04-FRCNN")
    img = np.zeros((1080, 1920, 3), np.uint8)
    kw = {"per_class": per_class, **({"min_conf": 0.1} if tracker == "strongsort" else {})}
    j = boxmot_tpu.create_tracker(tracker, **kw)
    t = boxmot_tpu_torch.create_tracker(tracker, device="cpu", **kw)
    lost = 0
    for f, d in enumerate(seq.dets_per_frame()):
        d = d[: max(2, len(d) // (1 + f % 3))]  # tracks go lost and come back
        np.testing.assert_array_equal(np.asarray(t.update(d, img))[:, 4],
                                      np.asarray(j.update(d, img))[:, 4])
        a, b = t._lost_display_rows, j._lost_display_rows
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x[:, 4:], y[:, 4:])
            np.testing.assert_allclose(x, y, atol=1e-3, rtol=0)
        lost += sum(len(x) for x in a)
    assert t.max_obs == j.max_obs and list(t._display_history) == list(j._display_history)
    for trajectories in (False, True):
        np.testing.assert_array_equal(
            t.plot_results(img.copy(), trajectories, show_kf_preds=True),
            j.plot_results(img.copy(), trajectories, show_kf_preds=True))
    assert lost > 0 or tracker == "strongsort"  # StrongSORT's tentative tracks just die
