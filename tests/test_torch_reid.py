"""The port's ReID (``models/osnet.py``, ``models/convert.py``, ``reid/``)
against the JAX package's, on the CPU.

Weights are random Flax variables made from a seed with numpy (the tree's
shapes come from ``jax.eval_shape`` of the Flax ``init``, so no JAX
initializer runs), carried into the port by ``osnet_state_dict_from_flax``
or written as a torchreid-format ``.pth`` by ``torch.save`` of the JAX
``export_osnet_state_dict``.  Crops are 64 x 32 (the facade's ``crop_hw``).
Tolerances:

* OSNet, ``osnet_x0_25``, ``osnet_ain_x0_25`` and ``osnet_ibn_x1_0``:
  L2-normalized features within 1e-4 (float32 convolutions summed in
  another order; instance norms' variances computed another way);
* the facades built from one checkpoint, fp32: 1e-4; ``half=True`` (bf16
  weights and crops in both, rounded at other places; 256 x 128 crops):
  cosine >= 0.99 row by row;
* a crop's feature alone and in a batch (other batch sizes may take other
  convolution algorithms): 1e-5.
"""

from __future__ import annotations

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxmot_tpu.models.convert import export_osnet_state_dict
from boxmot_tpu.models.osnet import build_osnet as jax_build_osnet
from boxmot_tpu.reid import core as jcore
from boxmot_tpu_torch.models import convert as tconvert
from boxmot_tpu_torch.models.osnet import OSNET_VARIANTS, build_osnet
from boxmot_tpu_torch.reid import ReID, create_reid
from boxmot_tpu_torch.reid import core as tcore
from chip_smoke import reid_checkpoint

HW = (64, 32)
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def flax_variables(name: str, seed: int) -> dict:
    """Seeded random Flax variables of OSNet ``name`` as nested dicts of
    float32 numpy arrays: He-scaled kernels, scales and running variances in
    [0.5, 1.5], small biases and running means."""
    shapes = jax.eval_shape(jax_build_osnet(name).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *HW, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        key, shape = path[-1].key, leaf.shape
        if key == "kernel":
            return rng.normal(0, math.sqrt(2.0 / np.prod(shape[:-1])), shape)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        return rng.normal(0, 0.1, shape)  # bias, mean

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), dict(tree))


def frame(seed=0, h=120, w=200):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def boxes(seed=1, n=6, h=120, w=200):
    rng = np.random.default_rng(seed)
    x1, y1 = rng.uniform(-10, w - 20, n), rng.uniform(-10, h - 30, n)
    return np.stack([x1, y1, x1 + rng.uniform(8, 60, n), y1 + rng.uniform(16, 100, n)],
                    1).astype(np.float32)


def unit(a):
    return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A torchreid-format osnet_x0_25 checkpoint (tensors, with the
    classifier and the batch norms' counters a trained one carries)."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_osnet_state_dict(flax_variables("osnet_x0_25", 7)).items()}
    rng = np.random.default_rng(8)
    sd["classifier.weight"] = torch.from_numpy(rng.normal(size=(10, 512)).astype(np.float32))
    sd["classifier.bias"] = torch.zeros(10)
    for k in [k for k in sd if k.endswith("running_mean")]:
        sd[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(100)
    path = tmp_path_factory.mktemp("reid") / "osnet_x0_25_seeded.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}, "epoch": 3}, path)
    return path


@pytest.fixture(scope="module")
def facades(checkpoint):
    """(JAX ReID, port ReID on the CPU) built from one checkpoint."""
    return (jcore.ReID(weights=checkpoint, crop_hw=HW),
            ReID(weights=checkpoint, device="cpu", crop_hw=HW))


@pytest.mark.parametrize("name", ["osnet_x0_25", "osnet_ain_x0_25", "osnet_ibn_x1_0"])
def test_osnet_equals_flax(name):
    variables = flax_variables(name, seed=len(name))
    x = np.random.default_rng(2).uniform(-2, 2, (3, *HW, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jax_build_osnet(name).apply)(variables, jnp.asarray(x)))
    model = build_osnet(name).eval()
    tconvert.load_weights(model, tconvert.osnet_state_dict_from_flax(variables, name))
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert got.shape == want.shape == (3, 512)
    np.testing.assert_allclose(unit(got), unit(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", sorted(OSNET_VARIANTS))
def test_state_dict_names_are_torchreids(name):
    """Every variant's module keys are the keys the JAX exporters write, so a
    torchreid checkpoint loads by name."""
    keys = {k for k in build_osnet(name).state_dict() if "num_batches_tracked" not in k}
    ain = name.startswith("osnet_ain")
    assert ("pool2.0.conv.weight" in keys) == ain and ("conv2.2.0.conv.weight" in keys) != ain
    assert ("conv2.0.conv2.1.layers.0.conv1.weight" in keys) == ain
    assert ("conv2.0.conv2b.1.bn.running_var" in keys) != ain
    assert ("conv2.0.IN.weight" in keys) == (ain or name.startswith("osnet_ibn"))
    assert {"fc.0.weight", "fc.1.running_mean", "conv5.conv.weight"} <= keys


def test_torchreid_checkpoint_loads_in_both(checkpoint, facades):
    jax_reid, reid = facades
    img, b = frame(), boxes()
    want = jax_reid.get_features(b, img)
    got = reid.get_features(b, img)
    assert got.shape == want.shape == (len(b), 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the weights are the file's, to the bit
    sd = torch.load(checkpoint, weights_only=True)["state_dict"]
    for k, v in reid.model.state_dict().items():
        if "num_batches_tracked" not in k:
            assert torch.equal(v, sd[f"module.{k}"]), k


def test_checkpoint_key_rules(checkpoint):
    sd = torch.load(checkpoint, weights_only=True)["state_dict"]
    plain = {k.removeprefix("module."): v for k, v in sd.items()}
    loaded = tconvert.convert_checkpoint({f"model.{k}": v for k, v in plain.items()},
                                         "osnet_x0_25")
    assert "classifier.weight" not in loaded and not any("num_batches" in k for k in loaded)
    with pytest.raises(ValueError, match="unmapped"):
        tconvert.convert_checkpoint({**plain, "conv9.weight": torch.zeros(1)}, "osnet_x0_25")
    with pytest.raises(ValueError, match="lacks"):
        tconvert.convert_checkpoint({k: v for k, v in plain.items() if k != "fc.0.bias"},
                                    "osnet_x0_25")
    # only OSNet and CLIP checkpoints convert, as in the JAX package (an OSNet
    # checkpoint read as CLIP lacks the image projection: the JAX error)
    for name in ("resnet50", "vit_tiny", "csl_tinyvit_7m"):
        with pytest.raises(ValueError, match=f"no checkpoint converter for '{name}'"):
            tconvert.convert_checkpoint(plain, name)
    with pytest.raises(ValueError, match="only ViT CLIP checkpoints"):
        tconvert.convert_checkpoint(plain, "clip")


def test_get_features_contract(facades):
    _, reid = facades
    img, b = frame(3), boxes(4, n=5)
    f = reid.get_features(b, img)
    assert f.shape == (5, 512) and f.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(f, axis=1), 1.0, atol=1e-5)
    assert reid.get_features(np.zeros((0, 4), np.float32), img).shape == (0, 512)
    assert reid.get_features([], img).shape == (0, 512)
    assert reid(b, img).shape == (5, 512)
    # a crop's feature alone equals its feature in the batch
    np.testing.assert_allclose(reid.get_features(b[2:3], img), f[2:3], rtol=0, atol=1e-5)


def test_more_than_256_crops_are_chunked(facades):
    _, reid = facades
    img = frame(5)
    b = np.tile(boxes(6, n=10), (30, 1))  # 300 crops: a chunk of 256 and one of 44
    f = reid.get_features(b, img)
    assert f.shape == (300, 512)
    np.testing.assert_allclose(f[250:260], f[:10], rtol=0, atol=1e-5)  # the same boxes, either chunk
    np.testing.assert_allclose(f[290:], f[:10], rtol=0, atol=1e-5)


def test_obb_features_equal_jax(facades):
    jax_reid, reid = facades
    img = frame(9)
    rng = np.random.default_rng(10)
    b = np.stack([rng.uniform(20, 180, 5), rng.uniform(20, 100, 5), rng.uniform(8, 40, 5),
                  rng.uniform(16, 60, 5), rng.uniform(-np.pi, np.pi, 5)], 1).astype(np.float32)
    np.testing.assert_allclose(reid.get_features(b, img), jax_reid.get_features(b, img), rtol=0,
                               atol=ATOL)


def test_get_features_multi_equals_per_frame(facades):
    _, reid = facades
    imgs = [frame(11), frame(12), frame(13)]
    bs = [boxes(14, n=4), np.zeros((0, 4), np.float32), boxes(15, n=7)]
    multi = reid.get_features_multi(bs, imgs)
    assert [m.shape for m in multi] == [(4, 512), (0, 512), (7, 512)]
    for m, b, img in zip(multi, bs, imgs):
        np.testing.assert_allclose(m, reid.get_features(b, img), rtol=0, atol=1e-5)
    assert reid.get_features_multi([], []) == []
    with pytest.raises(ValueError, match="frames"):
        reid.get_features_multi(bs, imgs[:2])


def test_mixed_box_kinds_raise_where_jax_promotes(facades):
    """A frame group mixing 4- and 5-column boxes: the JAX package reads the
    4-column frame's xyxy rows as xywha (other features than the frame's
    own, silently); the port refuses the group."""
    jax_reid, reid = facades
    imgs = [frame(16), frame(17)]
    b4 = boxes(18, n=3)
    b5 = np.concatenate([b4[:, :2] + 10, b4[:, 2:4] - b4[:, :2], np.full((3, 1), 0.2,
                                                                         np.float32)], 1)
    promoted = jax_reid.get_features_multi([b4, b5], imgs)[0]
    assert not np.allclose(promoted, jax_reid.get_features(b4, imgs[0]), atol=1e-3)
    with pytest.raises(ValueError, match="mix"):
        reid.get_features_multi([b4, b5], imgs)


def test_half_against_jax_half(tmp_path):
    """bf16 at the facade's 256 x 128 crops, on a checkpoint whose features
    vary with the crop (its convolutions' batch norms calibrated on crops,
    ``chip_smoke.reid_checkpoint``: with arbitrary statistics every crop's
    feature nearly coincides and any cosine passes; at 64 x 32 crops bf16
    drifts to a cosine of about 0.985 from fp32 in both packages)."""
    weights = reid_checkpoint(tmp_path, "osnet_x0_25", seed=3)
    img, b = frame(19), boxes(20, n=6)
    full = ReID(weights=weights, device="cpu").get_features(b, img)
    assert (1.0 - full @ full.T).max() > 0.05  # the crops' features differ
    want = jcore.ReID(weights=weights, half=True).get_features(b, img)
    reid = ReID(weights=weights, device="cpu", half=True)
    assert reid.model.conv1.conv.weight.dtype == torch.bfloat16
    got = reid.get_features(b, img)
    assert got.dtype == np.float32
    cos = (unit(got) * unit(want)).sum(axis=1)
    assert cos.min() >= 0.99, cos


STEMS = ["osnet_x0_25_msmt17.pt", "osnet_ain_x1_0_dukemtmcreid.pth", "clip_market1501.pt",
         "lmbn_n_cuhk03_d.pt", "mobilenetv2_x1_4_msmt17.pt", "resnet50_fc512_msmt17.pt",
         "weights/OSNET_IBN_X1_0_MSMT17.PT", "vit_tiny_parts3.pth", "csl_tinyvit_11m_lmbn.pt"]


def test_infer_model_name_equals_jax():
    assert list(tcore.MODEL_NAMES) == list(jcore.MODEL_FACTORY)
    for name in [*jcore.MODEL_FACTORY, *STEMS, None]:
        assert tcore.infer_model_name(name) == jcore.infer_model_name(name), name
    for fn in (tcore.infer_model_name, jcore.infer_model_name):
        with pytest.raises(ValueError, match="cannot infer"):
            fn("yolox_s.pt")


def test_unported_backbones_and_runtimes_raise(tmp_path, monkeypatch):
    # every backbone of the JAX MODEL_FACTORY builds (tests/test_torch_{backbones,vit,
    # csl_tinyvit,clip}.py hold them to JAX), ViT, CSL-TinyViT and CLIP among them;
    # the runtimes that item 22 once refused are dispatched by suffix as in JAX
    # (tests/test_torch_{export,tflite,native_reid}.py drive them)
    for name in ("resnet50", "lmbn_n", "hacnn", "mobilenetv2"):
        assert ReID(model_name=name, device="cpu").model_name == name
    assert create_reid("mlfn_market1501.pt", device="cpu").model_name == "mlfn"
    img, b = frame(21), boxes(22, n=3)
    for name, dim in (("clip", 1280), ("vit_tiny", 512), ("csl_tinyvit_7m", 1536),
                      ("csl_tinyvit_lmbn", 3584)):
        f = ReID(model_name=name, device="cpu", crop_hw=HW).get_features(b, img)
        assert f.shape == (3, dim) and np.isfinite(f).all(), name
    reid = create_reid("vit_nano_market1501.pt", device="cpu", crop_hw=HW)
    assert reid.model_name == "vit_nano" and reid.get_features(b, img).shape == (3, 192)
    saved = tmp_path / "savedmodel"
    saved.mkdir()
    (saved / "saved_model.pb").write_bytes(b"")
    native = tmp_path / "native"
    native.mkdir()
    (native / "manifest.txt").write_text("")
    from boxmot_tpu_torch.native import reid as native_reid
    from boxmot_tpu_torch.reid import backends as tbackends

    seen = []
    for cls in ("TFLiteReID", "SavedModelReID"):
        monkeypatch.setattr(tbackends, cls, lambda p, _c=cls, **kw: seen.append((_c, p, kw)))
    monkeypatch.setattr(native_reid, "CppReID", lambda p, **kw: seen.append(("CppReID", p, kw)))
    for weights in ("osnet_x0_25.tflite", saved, native, native / "manifest.txt"):
        create_reid(weights, device="cpu", half=True)
    assert [(c, Path(p)) for c, p, _ in seen] == [
        ("TFLiteReID", Path("osnet_x0_25.tflite")), ("SavedModelReID", saved),
        ("CppReID", native / "manifest.txt"), ("CppReID", native / "manifest.txt")]
    assert seen[0][2] == seen[1][2] == {"device": "cpu"} and seen[2][2] == {}
    # as in JAX, a .msgpack that does not exist gives the name's seeded model
    for reid in (ReID(weights="osnet_x0_25.msgpack", device="cpu"),
                 create_reid("osnet_x0_25.msgpack", device="cpu")):
        assert all(torch.equal(x, y) for x, y in zip(
            reid.model.state_dict().values(),
            ReID(model_name="osnet_x0_25", device="cpu").model.state_dict().values()))


def test_create_reid_and_defaults(checkpoint):
    reid = create_reid(device="cpu")
    assert reid.model_name == "osnet_x0_25" and reid.feature_dim == 512
    assert reid.device == torch.device("cpu") and reid.crop_hw == (256, 128)
    # without weights the initialization is seeded: the same model every time
    again = create_reid("osnet_x0_25", device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(reid.model.state_dict().values(),
                                                 again.model.state_dict().values()))
    assert create_reid(checkpoint, device="cpu").model_name == "osnet_x0_25"
    import inspect

    assert inspect.signature(ReID).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            ReID()
