"""The port's YOLOX (``models/yolox.py``, the YOLOX part of
``models/convert.py``) against the JAX package's, on the CPU.

Weights are random Flax variables made from a seed with numpy (the tree's
shapes come from ``jax.eval_shape`` of the Flax ``init``): He-scaled
kernels (the predictions' eight times larger, so that the logits spread),
scales in [0.5, 1.5], small biases, and batch-norm statistics calibrated on
seeded letterboxed frames by ``chip_smoke.calibrate_batch_norms`` through
the port's model, then written back into the Flax tree, so both packages
run the same weights.  Inputs are standardized letterboxes at (256, 320).

Tolerances: the raw head (N, 5 + C) within atol 1e-4 and rtol 1e-4 (float32
convolutions summed in another order through some 60 layers; the largest
difference seen is about 5e-5); decoded boxes within 2e-2 px plus rtol 1e-4
(a box's half width is ``exp`` of a raw value times the stride, up to
hundreds of pixels, so a raw difference of 5e-5 moves a corner by up to
about 1e-2 px) and scores within 5e-5.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxmot_tpu.models.yolox import build_yolox as jax_build_yolox
from boxmot_tpu.models.yolox import export_yolox
from boxmot_tpu.models.yolox import resolve_yolox_variant as jax_resolve
from boxmot_tpu.models.yolox import yolox_key_spec as jax_key_spec
from boxmot_tpu.ops.nms import yolox_decode as jax_decode
from boxmot_tpu_torch.models import convert as tconvert
from boxmot_tpu_torch.models.yolox import YOLOX_VARIANTS, build_yolox, resolve_yolox_variant
from boxmot_tpu_torch.ops.nms import yolox_decode
from chip_smoke import calibrate_batch_norms, crop_frame, letterboxed_frames

HW = (256, 320)
ATOL = RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def frames(seed: int, n: int, size=(240, 320)):
    """n seeded textured uint8 BGR frames."""
    return [crop_frame(seed + i, size) for i in range(n)]


def flax_yolox_variables(name: str, seed: int, hw=HW, num_classes: int = 1) -> dict:
    """Seeded Flax variables of YOLOX ``name`` as nested dicts of float32
    numpy arrays, with batch norms calibrated on two seeded letterboxes."""
    shapes = jax.eval_shape(jax_build_yolox(name, num_classes).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        key, shape = path[-1].key, leaf.shape
        if key == "kernel":
            gain = 16.0 if "pred" in path[-2].key else 2.0
            return rng.normal(0, math.sqrt(gain / np.prod(shape[:-1])), shape)
        if key == "scale":
            return rng.uniform(0.5, 1.5, shape)
        if key == "mean":
            return np.zeros(shape)
        if key == "var":
            return np.ones(shape)
        return rng.normal(0, 0.1, shape)  # bias

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32), dict(tree))
    model = build_yolox(name, num_classes)
    model.load_state_dict(tconvert.yolox_state_dict_from_flax(variables, name), strict=True)
    calibrate_batch_norms(model, letterboxed_frames(frames(seed + 50, 2), hw))
    sd = model.state_dict()
    for tk, fpath, kind in jax_key_spec(name):
        if kind == "bn":
            node = variables["batch_stats"]
            for p in fpath:
                node = node[p]
            node["mean"] = sd[f"{tk}.running_mean"].numpy().copy()
            node["var"] = sd[f"{tk}.running_var"].numpy().copy()
    return variables


def port_model(variables, name: str) -> torch.nn.Module:
    model = build_yolox(name)
    model.load_state_dict(tconvert.yolox_state_dict_from_flax(variables, name), strict=True)
    return model.eval()


@pytest.fixture(scope="module", params=["yolox_nano", "yolox_s"])
def pair(request):
    """(name, variables, input NHWC, JAX raw head, port raw head)."""
    name = request.param
    variables = flax_yolox_variables(name, seed=3)
    x = letterboxed_frames(frames(20, 1), HW).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jax.jit(jax_build_yolox(name).apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port_model(variables, name)(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    return name, variables, x, want, got


def test_raw_head_matches_jax(pair):
    """The raw head (1, N, 5 + C), anchors in the JAX order (stride 8 first,
    each level row by row): a permutation would show here."""
    name, _, _, want, got = pair
    n = sum((HW[0] // s) * (HW[1] // s) for s in (8, 16, 32))
    assert got.shape == want.shape == (1, n, 6)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=name)
    assert want[0, :, 4].std() > 0.2 and want[0, :, 5].std() > 0.2  # logits spread


def test_decode_matches_jax(pair):
    name, _, _, want, got = pair
    jb, jo, jc = (np.asarray(a) for a in jax_decode(jnp.asarray(want[0]), img_hw=HW))
    tb, to, tc = (a.numpy() for a in yolox_decode(torch.from_numpy(got[0]), img_hw=HW))
    np.testing.assert_allclose(tb, jb, atol=2e-2, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(to * tc[:, 0], jo * jc[:, 0], atol=5e-5, rtol=0, err_msg=name)


def test_checkpoint_file_loads_strict(pair, tmp_path):
    """A yolox torch checkpoint written from the JAX package's
    ``export_yolox`` ({"model": ...}, "model." prefixes, tensors, the batch
    norms' counters) loads into the port with ``strict=True`` and gives the
    head of the carried-across weights; an unknown key raises."""
    name, variables, x, _, got = pair
    sd = {f"model.{k}": torch.from_numpy(np.array(v)) for k, v in
          export_yolox(variables, name).items()}
    sd.update({k.replace(".running_mean", ".num_batches_tracked"): torch.tensor(7)
               for k in sd if k.endswith(".running_mean")})
    path = tmp_path / f"{name}.pth"
    torch.save({"model": sd, "epoch": 3}, path)
    model = build_yolox(name)
    model.load_state_dict(tconvert.load_yolox(str(path), name), strict=True)
    with torch.no_grad():
        again = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_array_equal(again, got)
    sd["model.head.bogus_preds.0.weight"] = torch.zeros((1, 8, 1, 1))
    with pytest.raises(ValueError, match="unmapped"):
        tconvert.load_yolox({"model": sd}, name)
    del sd["model.head.bogus_preds.0.weight"], sd["model.head.obj_preds.2.bias"]
    with pytest.raises(ValueError, match="lacks"):
        tconvert.load_yolox({"model": sd}, name)


@pytest.mark.parametrize("name", sorted(YOLOX_VARIANTS))
def test_module_names_equal_the_key_spec(name):
    """Every variant's modules carry exactly the keys of the JAX
    ``yolox_key_spec`` (the yolox checkpoint's names), nano's depthwise
    ``dconv``/``pconv`` included."""
    keys = set()
    for tk, _, kind in jax_key_spec(name):
        if kind == "bn":
            keys |= {f"{tk}.{k}" for k in ("weight", "bias", "running_mean", "running_var")}
        else:
            keys.add(f"{tk}.weight")
            if "_preds." in tk:
                keys.add(f"{tk}.bias")
    model = build_yolox(name)
    assert {k for k in model.state_dict() if "num_batches_tracked" not in k} == keys
    assert model.backbone.backbone.dark2[0].__class__.__name__ == (
        "DWConv" if YOLOX_VARIANTS[name][2] else "BaseConv")


def test_variant_names_resolve_as_in_jax():
    for name in ("yolox_x_MOT17_ablation", "yolox_s_mot20", "yolox_n", "yolox_l_dancetrack",
                 "yolox_m"):
        assert resolve_yolox_variant(name) == jax_resolve(name)
    with pytest.raises(ValueError, match="unknown YOLOX variant"):
        resolve_yolox_variant("yolox_q")
