"""The port's ReID backbones beyond OSNet (``models/{backbones,lmbn,mlfn,
cspreid,hacnn}.py``) against the JAX package's Flax models, on the CPU.

Weights are random Flax variables made from a seed with numpy (the tree's
shapes from ``jax.eval_shape`` of the Flax ``init``): LeCun-scaled kernels,
norm scales and batch-norm running variances in [0.5, 1.5], small biases
and running means, so that every batch norm's statistics are exercised by
the conversion (``models/convert.py::backbone_state_dict_from_flax``).
Crops are the JAX tests' sizes (``tests/test_reid.py``): 64 x 32 for
ResNet, MobileNetV2 and MLFN, 128 x 64 for LMBN and CSPReID, 160 x 64 for
HACNN.  Tolerance: outputs within 1e-4 of the largest absolute output
(float32 convolutions summed in another order).  The branched models
(LMBN, LMBN-AIN, HACNN), whose JAX compiles take about 10 s each, are held
in ``tests/test_torch_backbones_branched.py``.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxmot_tpu.models import convert as jconvert
from boxmot_tpu.reid import core as jcore
from boxmot_tpu_torch.models import convert as tconvert
from boxmot_tpu_torch.reid import ReID, create_reid
from boxmot_tpu_torch.reid import core as tcore

RTOL = 1e-4
PORTED = ("resnet50", "resnet101", "mobilenetv2_x1_0", "mobilenetv2_x1_4", "lmbn_n", "lmbn_ain_n",
          "mlfn", "cspreid_n", "hacnn")
BRANCHED = ("lmbn_n", "lmbn_ain_n", "hacnn")
HW = {"lmbn_n": (128, 64), "lmbn_ain_n": (128, 64), "cspreid_n": (128, 64), "hacnn": (160, 64)}


def crop_hw(name):
    return HW.get(name, (64, 32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def flax_variables(model, hw, seed: int) -> dict:
    """Seeded random Flax variables of ``model`` as nested dicts of float32
    numpy arrays."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        key, shape = path[-1].key, leaf.shape
        if key == "kernel":
            return rng.normal(0, math.sqrt(1.0 / np.prod(shape[:-1])), shape)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        return rng.normal(0, 0.1, shape)  # bias, mean

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), dict(tree))


def assert_equals_flax(name):
    """One JAX compile: the port's forward of ``name`` with the carried
    variables against Flax's on the same seeded crops."""
    hw = crop_hw(name)
    jmodel = jcore.MODEL_FACTORY[name]()
    variables = flax_variables(jmodel, hw, seed=len(name))
    x = np.random.default_rng(2).uniform(-2, 2, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    model = tcore.build_model(name).eval()
    model.load_state_dict(tconvert.backbone_state_dict_from_flax(variables, name))
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert got.shape == want.shape == (2, jmodel.feature_dim) == (2, model.feature_dim)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("name", [n for n in PORTED if n not in BRANCHED])
def test_backbone_equals_flax(name):
    assert_equals_flax(name)


def test_family_converters_name_their_models():
    """``backbone_state_dict_from_flax`` builds the named model's state dict
    key for key, and a variable the model lacks (or a missing one) raises."""
    jmodel = jcore.MODEL_FACTORY["cspreid_n"]()
    variables = flax_variables(jmodel, (128, 64), seed=1)
    sd = tconvert.backbone_state_dict_from_flax(variables, "cspreid_n")
    assert {k: v.shape for k, v in sd.items()} == {
        k: v.shape for k, v in tcore.build_model("cspreid_n").state_dict().items()}
    # the BNNecks' batch norms have no bias in Flax: 0 in the port
    assert not sd["bn_global.bn.bias"].any() and sd["bn_global.bn.running_var"].min() >= 0.5
    extra = {**variables, "params": {**variables["params"], "extra": {"kernel": np.zeros(
        (1, 1, 2, 2), np.float32)}}}
    with pytest.raises(ValueError, match="unmapped"):
        tconvert.backbone_state_dict_from_flax(extra, "cspreid_n")
    fewer = {**variables, "params": {k: v for k, v in variables["params"].items()
                                     if k != "stem0"}}
    with pytest.raises(ValueError, match="lack"):
        tconvert.backbone_state_dict_from_flax(fewer, "cspreid_n")


@pytest.mark.parametrize("name", [*PORTED, "mobilenetv2"])
def test_facade_builds_the_ported_names(name):
    """``ReID`` and ``create_reid`` build each name with seeded weights (the
    same model every time), its JAX feature width, unit rows."""
    hw = crop_hw(name)
    reid = ReID(model_name=name, device="cpu", crop_hw=hw)
    again = create_reid(f"{name}_market1501", device="cpu", crop_hw=hw, model_name=name)
    assert all(torch.equal(a, b) for a, b in zip(reid.model.state_dict().values(),
                                                 again.model.state_dict().values()))
    assert reid.feature_dim == jcore.MODEL_FACTORY[name]().feature_dim
    img = np.random.default_rng(3).integers(0, 256, (120, 200, 3), dtype=np.uint8)
    boxes = np.array([[10, 5, 60, 100], [100, 20, 150, 110], [-5, 40, 30, 130]], np.float32)
    f = reid.get_features(boxes, img)
    assert f.shape == (3, reid.feature_dim) and np.isfinite(f).all()
    np.testing.assert_allclose(np.linalg.norm(f, axis=1), 1.0, atol=1e-5)
    assert not np.allclose(f[0], f[1])


def test_infer_model_name_and_converter_errors_equal_jax():
    for name in [*PORTED, "mobilenetv2", "resnet50_msmt17.pt", "lmbn_ain_n_duke.pth",
                 "hacnn_market.pt", "mobilenetv2_x1_4_dukemtmcreid.pt"]:
        assert tcore.infer_model_name(name) == jcore.infer_model_name(name), name
    for name in PORTED:
        for fn in (tconvert.convert_checkpoint, jconvert.convert_checkpoint):
            with pytest.raises(ValueError, match=f"no checkpoint converter for '{name}'"):
                fn({}, name)


def test_hacnn_needs_160_by_64():
    """HACNN asserts its input size, in both packages; the facade's default
    crop_hw (256, 128) therefore fails at the first call, as in JAX."""
    model = tcore.build_model("hacnn").eval()
    with pytest.raises(AssertionError, match="160x64"):
        model(torch.zeros(1, 3, 96, 64))
    img = np.zeros((120, 200, 3), np.uint8)
    boxes = np.array([[10, 5, 60, 100]], np.float32)
    with pytest.raises(AssertionError, match="160x64"):
        ReID(model_name="hacnn", device="cpu").get_features(boxes, img)
    assert ReID(model_name="hacnn", device="cpu", crop_hw=(160, 64)).get_features(
        boxes, img).shape == (1, 1024)
