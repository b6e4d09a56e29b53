"""The port's public surface against the JAX package's, by name.

Both packages are walked with ``ast``; the JAX package is never imported.
For every module of ``boxmot_tpu/`` the walk takes its public top-level
functions and classes, its UPPER_CASE constants, every public method and
property of its public classes and, in a package ``__init__``, every name
it exports (its imports, the keys of its lazy maps and its ``__all__``).
The port's module of the same path must define each: a top-level name as
an attribute of the imported module (lazy exports included), a class member
as an attribute of the class, a dataclass field, or an attribute that a
method of the class or of a base assigns on ``self``.

``ALLOWED`` holds the JAX names that have no counterpart of that name, each
with its reason and, where there is one, the port's counterpart: JAX-only
idioms (Pallas kernels, a jit wrapper, optax transformation builders and
their pytree masks, Flax's ``init``, a JAX function's graph), and a name
that JAX itself cannot resolve.  Nothing is on it because it is unported.
(``jax.sharding``'s ``Mesh``, ``NamedSharding`` and ``P``, which
``parallel/replay.py`` imports, are not the module's own names; the port's
mesh is a tuple of devices, ``parallel/replay.py::sequence_mesh``.)

The values of the names this walk asked for are held against JAX's on
seeded numpy inputs: ids, assignments and masks exactly, floats within
1e-6 (absolute; the rotated intersections' areas relative to the largest).
"""

from __future__ import annotations

import ast
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "boxmot_tpu"
PORT_PKG = REPO / "boxmot_tpu_torch"

ALLOWED = {
    ("ops/pallas_kernels.py", "*"): "a Pallas TPU kernel; counterpart kernel K1, "
                                     "csrc/iou_cost.cu through ops/fused_iou_cost.py",
    ("ops/pallas_rotated_iou.py", "*"): "a Pallas TPU kernel; counterpart kernel K3, "
                                        "csrc/rotated_iou.cu through ops/rotated_iou.py",
    ("ops/precision.py", "tracker_jit"): "a jax.jit wrapper that raises XLA's matmul "
                                         "precision; counterpart utils/device.py::"
                                         "set_tracker_precision",
    **{("reid/training/optim.py", n): "an optax transformation builder; counterpart "
                                      "reid/training/optim.py::ProfileOptimizer"
       for n in ("build_tx", "build_main_tx", "build_center_tx")},
    **{("reid/training/optim.py", n): "a mask or scale over a Flax pytree for optax; "
                                      "counterpart reid/training/optim.py::lr_scales, "
                                      "window_scales and ProfileOptimizer's decay mask, "
                                      "keyed by Flax paths"
       for n in ("head_mask_tree", "lr_scale_tree", "wd_mask_tree", "window_scale_trees")},
    ("reid/training/clip_prompt.py", "PromptStage.init"): "Flax's init, which returns the "
                                                          "parameters as a pytree; the "
                                                          "port's PromptStage is an "
                                                          "nn.Module that owns them",
    **{(rel, "export_fn_to_onnx"): "translates a JAX function's jaxpr; counterpart "
                                   "onnxlite/export.py::export_module_to_onnx (torch.export)"
       for rel in ("onnxlite/export.py", "onnxlite/__init__.py")},
    ("__init__.py", "get_tracker_config"): "JAX's own export cannot resolve: "
                                           "boxmot_tpu/trackers/zoo.py defines no such "
                                           "function",
}


def _lazy_map_keys(node) -> list:
    """Keys of a module-level dict literal whose values name modules of the
    package (``"boxmot_tpu..."``): a lazy export map."""
    if not isinstance(node, ast.Dict) or not node.keys:
        return []
    if not all(isinstance(v, ast.Constant) and str(v.value).startswith("boxmot_tpu")
               for v in node.values):
        return []
    return [k.value for k in node.keys if isinstance(k, ast.Constant)]


def _public(name: str) -> bool:
    return not name.startswith("_")


def jax_surface(path: Path) -> list[str]:
    """The public names of one JAX module (module docstring)."""
    tree = ast.parse(path.read_text())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            names.append(node.name)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            names.append(node.name)
            names += [f"{node.name}.{m.name}" for m in node.body
                      if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                      and _public(m.name)]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id.isupper() and _public(t.id):
                    names.append(t.id)
                if isinstance(t, ast.Name) and t.id == "__all__" and path.name == "__init__.py":
                    names += [e.value for e in ast.walk(node.value)
                              if isinstance(e, ast.Constant) and isinstance(e.value, str)
                              and _public(e.value)]
            if path.name == "__init__.py":
                names += _lazy_map_keys(node.value)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names += [a.asname or a.name for a in node.names if _public(a.asname or a.name)]
    return sorted(set(names))


def _self_attributes(cls) -> set:
    """Attributes that the methods of ``cls`` and its bases assign on self."""
    out = set()
    for klass in cls.__mro__:
        if not klass.__module__.startswith("boxmot_tpu_torch"):
            continue
        try:
            src = inspect.getsource(klass)
        except (OSError, TypeError):
            continue
        for node in ast.walk(ast.parse(inspect.cleandoc("\n" + src) if src[0] == " " else src)):
            if (isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Store)
                    and isinstance(node.value, ast.Name) and node.value.id == "self"):
                out.add(node.attr)
    return out


def _defines(module, name: str) -> bool:
    if "." not in name:
        return hasattr(module, name)
    cls_name, member = name.split(".", 1)
    cls = getattr(module, cls_name, None)
    if cls is None:
        return False
    return (hasattr(cls, member) or member in getattr(cls, "__dataclass_fields__", {})
            or member in _self_attributes(cls))


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _allowed(rel: str, name: str) -> bool:
    return (rel, "*") in ALLOWED or (rel, name) in ALLOWED


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_defines_the_jax_module_surface(rel):
    names = [n for n in jax_surface(JAX_PKG / rel) if not _allowed(rel, n)]
    if not names:
        return
    port_path = PORT_PKG / rel
    assert port_path.exists(), f"boxmot_tpu_torch/{rel} is missing ({names})"
    mod = rel.removesuffix(".py").removesuffix("/__init__").removesuffix("__init__")
    module = importlib.import_module(
        "boxmot_tpu_torch" + ("." + mod.replace("/", ".") if mod else ""))
    missing = [n for n in names if not _defines(module, n)]
    assert not missing, f"boxmot_tpu_torch/{rel} lacks {missing}"


def test_every_allowed_name_is_in_the_jax_package_and_not_in_the_port():
    """The allow-list names only what JAX has and the port does not."""
    for (rel, name), reason in ALLOWED.items():
        assert reason and (JAX_PKG / rel).exists(), rel
        if name == "*":
            assert not (PORT_PKG / rel).exists(), rel
            continue
        assert name in jax_surface(JAX_PKG / rel), (rel, name)
        if (PORT_PKG / rel).exists():
            mod = rel.removesuffix(".py").removesuffix("__init__").rstrip("/")
            module = importlib.import_module(
                "boxmot_tpu_torch" + ("." + mod.replace("/", ".") if mod else ""))
            assert not _defines(module, name), (rel, name, "is defined: drop it from ALLOWED")


def test_the_walk_sees_the_package_exports():
    top = jax_surface(JAX_PKG / "__init__.py")
    assert {"Boxmot", "TRACKER_REGISTRY", "TrackRunResult", "get_tracker_config"} <= set(top)
    assert {"TRACKER_MAPPING", "get_tracker_class", "StrongSort"} <= set(
        jax_surface(JAX_PKG / "trackers" / "__init__.py"))
    assert {"geometry", "linear_assignment_np", "iou_batch_obb"} <= set(
        jax_surface(JAX_PKG / "ops" / "__init__.py"))
    assert "MOTSequence.fps_mask" in jax_surface(JAX_PKG / "data" / "mot.py")


# -- the values of the names the walk asked for ---------------------------


def _np(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def _boxes(rng, n, obb=False):
    if obb:
        return np.column_stack([rng.uniform(0, 60, (n, 2)), rng.uniform(4, 30, (n, 2)),
                                rng.uniform(-3, 3, n)]).astype(np.float32)
    xy = rng.uniform(0, 100, (n, 2))
    return np.column_stack([xy, xy + rng.uniform(2, 50, (n, 2))]).astype(np.float32)


def test_geometry_converters_equal_jax():
    import jax.numpy as jnp

    from boxmot_tpu.ops import geometry as jgeo
    from boxmot_tpu_torch.ops import geometry as tgeo

    x = _boxes(np.random.default_rng(0), 16)
    for name in ("tlwh2xyah", "tlwh2xyxy", "xywh2tlwh", "xyxy2tlwh"):
        got = getattr(tgeo, name)(torch.from_numpy(x))
        np.testing.assert_allclose(_np(got), np.asarray(getattr(jgeo, name)(jnp.asarray(x))),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_obb_iou_and_intersection_equal_jax():
    import jax
    import jax.numpy as jnp

    from boxmot_tpu.ops import rotated_iou as jrot
    from boxmot_tpu_torch.ops import iou as tiou
    from boxmot_tpu_torch.ops import rotated_iou as trot

    rng = np.random.default_rng(1)
    a, b = _boxes(rng, 7, obb=True), _boxes(rng, 11, obb=True)
    # one jitted program for both (eager, JAX's clip dispatches for 10 s)
    want_iou, want = jax.jit(lambda x, y: (jrot.iou_batch_obb(x, y),
                                           jrot.rect_intersection_area(x, y)))(
        jnp.asarray(a), jnp.asarray(b))
    iou = trot.iou_batch_obb(a, b, device="cpu")
    assert tiou.iou_batch_obb is trot.iou_batch_obb and int((iou > 0).sum()) > 5
    np.testing.assert_allclose(_np(iou), np.asarray(want_iou), rtol=0, atol=1e-6)
    got, want = _np(trot.rect_intersection_area(a, b, device="cpu")), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * want.max())


@pytest.mark.parametrize("shape", [(5, 7), (12, 3), (0, 4), (30, 30)])
def test_linear_assignments_equal_jax(shape, monkeypatch):
    from boxmot_tpu.ops import lap as jlap
    from boxmot_tpu_torch import native as tnative
    from boxmot_tpu_torch.ops import lap as tlap

    cost = np.random.default_rng(sum(shape)).uniform(0, 1, shape).astype(np.float32)
    for got, want in ((tlap.linear_assignment(cost, 0.8, device="cpu"),
                       jlap.linear_assignment(cost, 0.8)),
                      (tlap.linear_assignment_np(cost, 0.8), jlap.linear_assignment_np(cost, 0.8))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert tnative.native_available()
    monkeypatch.setattr(tnative, "native_available", lambda: False)  # the scipy path
    for g, w in zip(tlap.linear_assignment_np(cost, 0.8), jlap.linear_assignment_np(cost, 0.8)):
        np.testing.assert_array_equal(g, w)


def test_crops_equal_jax():
    import jax.numpy as jnp

    from boxmot_tpu.ops import crops as jcrops
    from boxmot_tpu_torch.ops import crops as tcrops

    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (40, 50, 3)).astype(np.float32)
    aabb = np.array([[3, 4, 30, 38], [10, 2, 49, 20], [-5, 30, 20, 60]], np.float32)
    obb = _boxes(rng, 3, obb=True)
    for fn, boxes in (("crop_resize_aabb", aabb), ("crop_resize_obb", obb)):
        got = getattr(tcrops, fn)(img, boxes, (16, 8), device="cpu")
        want = np.asarray(getattr(jcrops, fn)(jnp.asarray(img), jnp.asarray(boxes), (16, 8)))
        assert tuple(got.shape) == want.shape == (3, 16, 8, 3)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6, err_msg=fn)


def test_fps_mask_and_mot_results_equal_jax(tmp_path):
    from boxmot_tpu.data import mot as jmot
    from boxmot_tpu.engine import mot_io as jio
    from boxmot_tpu_torch.data import mot as tmot
    from boxmot_tpu_torch.engine import mot_io as tio

    frames = np.random.default_rng(3).integers(1, 90, 200)
    for orig, target in ((30, 10), (25, 30), (30, 7)):
        np.testing.assert_array_equal(tmot.compute_fps_mask(frames, orig, target),
                                      jmot.compute_fps_mask(frames, orig, target))
    root = REPO / "assets" / "MOT17-mini" / "train"
    port_seq, jax_seq = tmot.MOTDataset(root).sequences[0], jmot.MOTDataset(root).sequences[0]
    rows = port_seq.gt()
    np.testing.assert_array_equal(port_seq.fps_mask(rows, 10), jax_seq.fps_mask(rows, 10))
    tio.write_mot_results(tmp_path / "a.txt", rows[:, :9].astype(np.float32))
    for path in (tmp_path / "a.txt", tmp_path / "missing.txt"):
        np.testing.assert_array_equal(tio.read_mot_results(path), jio.read_mot_results(path))


def test_native_helpers_equal_jax(tmp_path):
    from boxmot_tpu import native as jnative
    from boxmot_tpu_torch import native as tnative

    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(2, 3)).astype(np.float32)
    mot = rng.uniform(0, 9, (4, 9))
    for mod, d in ((tnative, tmp_path / "port"), (jnative, tmp_path / "jax")):
        d.mkdir()
        mod.write_npy(d / "x.npy", a)
        mod.append_npy(d / "x.npy", b)
        assert mod.write_mot_native(d / "mot.txt", mot) is True
    assert (tmp_path / "port" / "x.npy").read_bytes() == (tmp_path / "jax" / "x.npy").read_bytes()
    np.testing.assert_array_equal(tnative.read_npy(tmp_path / "jax" / "x.npy"),
                                  np.concatenate([a, b]))
    assert (tmp_path / "port" / "mot.txt").read_bytes() == \
        (tmp_path / "jax" / "mot.txt").read_bytes()
    rows = np.column_stack([rng.integers(0, 6, 20), _boxes(rng, 20), rng.uniform(0, 1, (20, 2))])
    np.testing.assert_array_equal(tnative.pack_frames_native(rows, 6, 8),
                                  jnative.pack_frames_native(rows, 6, 8))
    cost = rng.uniform(0, 1, (9, 6))
    np.testing.assert_array_equal(tnative.lapjv_native(cost, 0.7), jnative.lapjv_native(cost, 0.7))


def test_scan_replay_equals_jax():
    import jax.numpy as jnp

    from boxmot_tpu.engine import replay as jreplay
    from boxmot_tpu.trackers.bytetrack import ByteTrackConfig as JConfig
    from boxmot_tpu_torch.engine import replay as treplay
    from boxmot_tpu_torch.trackers.bytetrack import ByteTrackConfig

    rng = np.random.default_rng(5)
    boxes, step = _boxes(rng, 6), rng.uniform(-2, 2, (6, 4)).astype(np.float32)
    dets = [np.column_stack([boxes + f * step, rng.uniform(0.7, 1, 6), np.zeros(6)]).astype(
        np.float32) for f in range(12)]
    packed, _ = jreplay.pack_frames(dets)
    state = treplay.init_state(ByteTrackConfig(), device="cpu")
    state, outs, masks = treplay.scan_replay(ByteTrackConfig(), state, packed)
    _, jouts, jmasks = jreplay.scan_replay(JConfig(), jreplay.init_state(JConfig()),
                                           jnp.asarray(packed))
    np.testing.assert_array_equal(_np(masks), np.asarray(jmasks))
    m = _np(masks)
    np.testing.assert_allclose(_np(outs)[m], np.asarray(jouts)[m], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(_np(outs)[m][:, 4:], np.asarray(jouts)[m][:, 4:])
    assert m.sum() > 20


def test_registries_and_constants_equal_jax():
    from boxmot_tpu.models import osnet as josnet
    from boxmot_tpu.motion import kalman as jkalman
    from boxmot_tpu.reid.training import losses as jlosses
    from boxmot_tpu.trackers import ocsort as jocsort
    from boxmot_tpu.trackers import zoo as jzoo
    from boxmot_tpu_torch import trackers as ttrackers
    from boxmot_tpu_torch.models import osnet as tosnet
    from boxmot_tpu_torch.motion import kalman as tkalman
    from boxmot_tpu_torch.ops import iou as tiou
    from boxmot_tpu_torch.reid import MODEL_FACTORY
    from boxmot_tpu_torch.reid import core as tcore
    from boxmot_tpu_torch.reid.training import losses as tlosses

    assert ttrackers.TRACKER_REGISTRY is ttrackers.TRACKER_MAPPING
    assert {k: v.replace("boxmot_tpu_torch.", "boxmot_tpu.")
            for k, v in ttrackers.TRACKER_MAPPING.items()} == jzoo.TRACKER_MAPPING
    for name in jzoo.TRACKER_MAPPING:
        cls = ttrackers.get_tracker_class(name)
        assert cls is getattr(ttrackers, cls.__name__)
        assert f"boxmot_tpu.{cls.__module__.split('.', 1)[1]}.{cls.__name__}" == \
            jzoo.TRACKER_MAPPING[name]
    with pytest.raises(ValueError, match="Unknown tracker 'nope'"):
        ttrackers.get_tracker_class("nope")
    assert list(MODEL_FACTORY) == list(tcore.MODEL_NAMES)
    assert MODEL_FACTORY["osnet_x0_25"]().feature_dim == 512
    assert tcore.CROP_BUCKETS == (1, 8, 16, 32, 64, 128, 256)
    assert set(tlosses.LOSS_REGISTRY) == set(jlosses.LOSS_REGISTRY)
    assert {k: v.__name__ for k, v in tlosses.HEAD_REGISTRY.items()} == {
        k: v.__name__ for k, v in jlosses.HEAD_REGISTRY.items()}
    assert set(tiou.ASSO_FUNCS) == {"iou", "iou_obb", "hmiou", "giou", "ciou", "diou"}
    assert tosnet.OS_BLOCKS == josnet.OS_BLOCKS
    from boxmot_tpu_torch.trackers import ocsort as tocsort

    assert tocsort.MAX_ORU == jocsort.MAX_ORU
    for make in ("make_xyah_layout", "make_xywh_layout", "make_xysr_layout",
                 "make_xyhr_layout", "make_xyscr_layout"):
        np.testing.assert_array_equal(_np(getattr(tkalman, make)().F),
                                      np.asarray(getattr(jkalman, make)().F))


def test_package_exports_and_result_types_resolve():
    """Every export of the port's package ``__init__``s resolves (a
    subprocess in ``tests/test_torch_eval.py`` resolves them without JAX),
    and ``TrackRunResult`` behaves as JAX's."""
    import boxmot_tpu_torch as port
    from boxmot_tpu.engine import results as jresults

    for pkg in (port, importlib.import_module("boxmot_tpu_torch.trackers"),
                importlib.import_module("boxmot_tpu_torch.ops"),
                importlib.import_module("boxmot_tpu_torch.reid")):
        for name in pkg.__all__:
            assert getattr(pkg, name) is not None, (pkg.__name__, name)
    got = port.TrackRunResult({"results": [1, 2], "n_frames": 2, "save_txt": None})
    want = jresults.TrackRunResult({"results": [1, 2], "n_frames": 2, "save_txt": None})
    assert (len(got), got.n_frames, got.results, got.summary()) == (
        len(want), want.n_frames, want.results, want.summary())


def _seeded(sd: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=tuple(v.shape)).astype(np.float32) for k, v in sd.items()
            if "num_batches_tracked" not in k}


@pytest.mark.parametrize("name", ["osnet_x0_25", "osnet_ain_x0_25", "osnet_ibn_x1_0"])
def test_osnet_converters_equal_jax(name):
    import jax

    from boxmot_tpu.models import convert as jconvert
    from boxmot_tpu_torch.models import convert as tconvert
    from boxmot_tpu_torch.models.osnet import build_osnet

    sd = _seeded(build_osnet(name).state_dict(), 6)
    if name.startswith("osnet_ain"):
        got, want = tconvert.convert_osnet_ain(sd), jconvert.convert_osnet_ain(sd)
        back = (tconvert.export_osnet_ain_state_dict(want),
                jconvert.export_osnet_ain_state_dict(want))
    else:
        ibn = "ibn" in name
        got, want = tconvert.convert_osnet(sd, ibn=ibn), jconvert.convert_osnet(sd, ibn=ibn)
        back = (tconvert.export_osnet_state_dict(want, ibn=ibn),
                jconvert.export_osnet_state_dict(want, ibn=ibn))
    flat = jax.tree_util.tree_flatten_with_path
    assert [p for p, _ in flat(got)[0]] == [p for p, _ in flat(want)[0]]
    for (p, g), (_, w) in zip(flat(got)[0], flat(want)[0]):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(p))
    assert back[0].keys() == back[1].keys()
    for k in back[1]:
        np.testing.assert_array_equal(back[0][k], back[1][k], err_msg=k)
    with pytest.raises(ValueError, match="every torchreid OSNet"):
        tconvert.convert_osnet(sd, blocks=(1, 1, 1))


def test_yolox_converters_equal_jax():
    import jax

    from boxmot_tpu.models import yolox as jyolox
    from boxmot_tpu_torch.models import yolox as tyolox

    sd = _seeded(tyolox.build_yolox("yolox_nano").state_dict(), 7)
    got, want = tyolox.convert_yolox(sd, "yolox_nano"), jyolox.convert_yolox(sd, "yolox_nano")
    flat = jax.tree_util.tree_flatten_with_path
    assert [p for p, _ in flat(got)[0]] == [p for p, _ in flat(want)[0]]
    for (p, g), (_, w) in zip(flat(got)[0], flat(want)[0]):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(p))
    back, jback = tyolox.export_yolox(want, "yolox_nano"), jyolox.export_yolox(want, "yolox_nano")
    assert back.keys() == jback.keys()
    for k in jback:
        np.testing.assert_array_equal(back[k], jback[k], err_msg=k)
