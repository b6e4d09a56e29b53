"""The port's ViT backbones (``models/vit.py``) against the JAX package's
Flax models, on the CPU.

Weights are seeded random Flax variables (``test_torch_backbones.
flax_variables``: the tree's shapes from ``jax.eval_shape`` of the Flax
``init``) carried into the port by ``backbone_state_dict_from_flax``; crops
are 64 x 32, so ``vit_tiny*``'s stride-12 grid is 5 x 2 (the part stripes
of ``vit_tiny_parts3`` span 1, 1 and 3 rows: the last takes the rest) and
the omni-scale pooling's 8 strips overlap on 4 rows.  Tolerance: outputs
within 1e-5 of the largest absolute output (float32 products summed in
another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxmot_tpu.models import vit as jvit
from boxmot_tpu.reid import core as jcore
from boxmot_tpu_torch.models import convert as tconvert
from boxmot_tpu_torch.models.vit import patch_grid, strip_pool
from boxmot_tpu_torch.reid import ReID
from boxmot_tpu_torch.reid import core as tcore
from test_torch_backbones import flax_variables

HW = (64, 32)
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("name", tcore.VIT_VARIANTS)
def test_vit_equals_flax(name):
    """One JAX compile: the port's forward with the carried variables against
    Flax's on the same seeded crops."""
    jmodel = jcore.MODEL_FACTORY[name]()
    variables = flax_variables(jmodel, HW, seed=len(name))
    x = np.random.default_rng(2).uniform(-2, 2, (2, *HW, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    model = tcore.build_model(name, HW).eval()
    model.load_state_dict(tconvert.backbone_state_dict_from_flax(variables, name, HW))
    with torch.no_grad():
        got = model(nchw(x)).numpy()
    assert got.shape == want.shape == (2, jmodel.feature_dim) == (2, model.feature_dim)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max())


def test_positional_embedding_is_sized_from_the_crop():
    """Flax sizes ``pos_embed`` from the crop it is initialized on, never from
    ``img_size``: vit_tiny (stride 12) at the facade's 256 x 128 has a 21 x
    10 grid, vit_nano (stride 16) 16 x 8."""
    for name, grid in (("vit_tiny", (21, 10)), ("vit_nano", (16, 8))):
        shapes = jax.eval_shape(jcore.MODEL_FACTORY[name]().init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 256, 128, 3)))
        model = tcore.build_model(name, (256, 128))
        assert model.grid == grid == patch_grid((256, 128), 16, 12 if "tiny" in name else 16)
        assert tuple(model.pos_embed.shape) == shapes["params"]["pos_embed"].shape \
            == (1, grid[0] * grid[1] + 1, 192)


@pytest.mark.parametrize("rows", [4, 5, 7, 16])
def test_strip_pool_boundaries_equal_jax(rows):
    x = np.random.default_rng(rows).normal(size=(2, rows, 3, 8)).astype(np.float32)
    for n in (1, 2, 4, 8):
        want = np.asarray(jvit._strip_pool(jnp.asarray(x), n))
        got = strip_pool(torch.from_numpy(x), n).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["vit_nano_ain_os", "vit_tiny_parts"])
def test_facade_serves_the_vits(name):
    """``ReID`` serves a ViT name at the default 256 x 128 crop (seeded
    weights: the same model twice), unit rows of the JAX width."""
    reid = ReID(model_name=name, device="cpu")
    again = ReID(model_name=name, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(reid.model.state_dict().values(),
                                                 again.model.state_dict().values()))
    img = np.random.default_rng(3).integers(0, 256, (120, 200, 3), dtype=np.uint8)
    boxes = np.array([[10, 5, 60, 100], [100, 20, 150, 110]], np.float32)
    f = reid.get_features(boxes, img)
    assert f.shape == (2, jcore.MODEL_FACTORY[name]().feature_dim) and np.isfinite(f).all()
    np.testing.assert_allclose(np.linalg.norm(f, axis=1), 1.0, atol=1e-5)
