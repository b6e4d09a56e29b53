"""The port's native ReID glue (``boxmot_tpu_torch/native/reid.py``) against
the JAX package's, on the CPU.

The C++ OSNet and LMBN of ``native/cpp`` are host code, built once by cmake
into the repo's ``native/cpp/build/`` for both packages.  Weights are seeded
Flax variables carried into the port (``tests/test_torch_export.py``'s
helpers).  Tolerances: ``manifest.txt`` and ``weights.bin`` written from the
port's model are byte-equal to JAX's from the carried variables; the port's
``CppReID`` and JAX's agree to the bit on one manifest; the native features
are within 5e-3 of the port's forward (``tests/test_native_reid.py``'s
tolerance, at the manifest's 64 x 32 crop; cosine > 0.999); ``create_reid``
dispatches a manifest or its directory; ``run_generate`` takes a
``CppReID`` and writes JAX's embedding cache, to the bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from boxmot_tpu.native import reid as jnative_reid
from boxmot_tpu_torch.native import reid as tnative_reid
from boxmot_tpu_torch.reid import ReID, create_reid
from tests.test_torch_export import HW, carried

BOXES = np.array([[20, 30, 120, 200], [100, 50, 200, 230], [0, 0, 50, 80]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def _img(seed=0, hw=(240, 320)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), np.uint8)


@pytest.mark.parametrize("name", ["osnet_x0_25", "osnet_ain_x0_25", "lmbn_n"])
def test_native_export_and_features_equal_jax(name, tmp_path):
    _, variables, model = carried(name, seed=3)
    manifest = tnative_reid.export_native_reid(name, model, tmp_path / "port", crop_hw=HW)
    jmanifest = jnative_reid.export_native_reid(name, variables, tmp_path / "jax", crop_hw=HW)
    for f in ("manifest.txt", "weights.bin"):
        assert (manifest.parent / f).read_bytes() == (jmanifest.parent / f).read_bytes(), f
    # the same manifest from the port's Flax variables (the other accepted input)
    again = tnative_reid.export_native_reid(
        name, {"params": variables["params"], "batch_stats": variables["batch_stats"]},
        tmp_path / "tree", crop_hw=HW)
    assert again.read_bytes() == manifest.read_bytes()

    cpp, jcpp = tnative_reid.CppReID(manifest), jnative_reid.CppReID(manifest)
    assert cpp.feature_dim == jcpp.feature_dim == model.feature_dim
    img = _img(seed=len(name))
    got = cpp.get_features(BOXES, img)
    np.testing.assert_array_equal(got, jcpp.get_features(BOXES, img))
    reid = ReID(model_name=name, device="cpu", crop_hw=HW)
    reid.model.load_state_dict(model.state_dict())
    want = reid.get_features(BOXES, img)
    assert got.shape == want.shape == (3, model.feature_dim)
    assert np.sum(got * want, axis=1).min() > 0.999
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)


def test_dispatch_empty_and_refusals(tmp_path):
    _, _, model = carried("osnet_x0_25")
    manifest = tnative_reid.export_native_reid("osnet_x0_25", model, tmp_path / "m", crop_hw=HW)
    for target in (tmp_path / "m", manifest):
        backend = create_reid(target, device="cpu")
        assert isinstance(backend, tnative_reid.CppReID) and backend.feature_dim == 512
    assert backend.get_features(np.empty((0, 4), np.float32), _img()).shape == (0, 512)
    with pytest.raises(RuntimeError):
        tnative_reid.CppReID(tmp_path / "nope" / "manifest.txt")
    with pytest.raises(ValueError, match="OSNet and LMBN"):
        tnative_reid.export_native_reid("resnet50", {}, tmp_path / "r")


def test_generate_caches_with_native_reid(tmp_path):
    """``run_generate`` takes the native backend as its ``reid`` (the JAX
    test's synthetic sequence) and writes the embedding cache JAX's
    ``run_generate`` writes with JAX's ``CppReID``."""
    from PIL import Image

    from boxmot_tpu.engine.generate import run_generate as jax_run_generate
    from boxmot_tpu_torch.engine.generate import run_generate

    seq = tmp_path / "data" / "SYN-01"
    (seq / "img1").mkdir(parents=True)
    (seq / "det").mkdir()
    rng = np.random.default_rng(0)
    for f in range(1, 4):
        Image.fromarray(rng.integers(0, 256, (64, 96, 3), np.uint8)).save(
            seq / "img1" / f"{f:06d}.jpg")
    rows = [row for f in range(1, 4)
            for row in (f"{f},-1,10,8,30,40,0.9\n", f"{f},-1,50,12,28,44,0.8\n")]
    (seq / "det" / "det.txt").write_text("".join(rows))
    (seq / "seqinfo.ini").write_text(
        "[Sequence]\nname=SYN-01\nimDir=img1\nframeRate=30\n"
        "seqLength=3\nimWidth=96\nimHeight=64\nimExt=.jpg\n")
    _, _, model = carried("osnet_x0_25", seed=5)
    manifest = tnative_reid.export_native_reid("osnet_x0_25", model, tmp_path / "m", crop_hw=HW)
    caches = {}
    for tag, gen, cls in (("port", run_generate, tnative_reid.CppReID),
                          ("jax", jax_run_generate, jnative_reid.CppReID)):
        kw = {"device": "cpu"} if tag == "port" else {}
        stats = gen(tmp_path / "data", tmp_path / tag, reid_model=cls(manifest),
                    reid_name="osnet_native", frame_cache=False, **kw)
        assert stats["SYN-01"]["dets"] == stats["SYN-01"]["embs"] == 6
        caches[tag] = np.load(tmp_path / tag / "public" / "embs" / "osnet_native" / "resize" /
                              "SYN-01.npy")
    assert caches["port"].shape == (6, 1 + 512)
    np.testing.assert_array_equal(caches["port"], caches["jax"])
    np.testing.assert_allclose(np.linalg.norm(caches["port"][:, 1:], axis=1), 1.0, atol=1e-4)
