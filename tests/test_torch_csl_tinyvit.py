"""The port's CSL-TinyViT backbones (``models/csl_tinyvit.py``) against the
JAX package's Flax models, on the CPU.

Weights are seeded random Flax variables (``test_torch_backbones.
flax_variables``) carried into the port by ``backbone_state_dict_from_flax``;
crops are 64 x 32.  There the token grids are 8 x 4 (stage 1, window 7), 4 x
2 (stage 2, window 14) and 4 x 2 (stage 3, window 7): every attention
stage pads its grid to the window, so padded tokens take part as keys; the
merge into the last stage (320 / 576 wide) keeps stride 1.  Tolerance:
outputs within 1e-5 of the largest absolute output.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxmot_tpu.models import csl_tinyvit as jcsl
from boxmot_tpu.reid import core as jcore
from boxmot_tpu_torch.models import convert as tconvert
from boxmot_tpu_torch.models.csl_tinyvit import CSL_ALIASES, bias_index_table
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


@pytest.mark.parametrize("name", ["csl_tinyvit_7m", "csl_tinyvit_7m_lmbn", "csl_tinyvit_23m"])
def test_csl_equals_flax(name):
    jmodel = jcore.MODEL_FACTORY[name]()
    variables = flax_variables(jmodel, HW, seed=len(name))
    x = np.random.default_rng(2).uniform(-2, 2, (2, *HW, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    model = tcore.build_model(name, HW).eval()
    model.load_state_dict(tconvert.backbone_state_dict_from_flax(variables, name, HW))
    # the shapes this input takes: padded windows in every stage, a stride-1 merge
    grids = []
    hook = lambda m, i, o: grids.append((tuple(i[0].shape[2:]), m.window))  # noqa: E731
    handles = [m.register_forward_hook(hook) for n, m in model.named_modules()
               if n.endswith("_b0") and hasattr(m, "window")]
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    for h in handles:
        h.remove()
    assert grids == [((8, 4), (7, 7)), ((4, 2), (14, 14)), ((4, 2), (7, 7))]
    assert model.merge2.conv2.c.stride == (1, 1) and model.merge1.conv2.c.stride == (2, 2)
    assert got.shape == want.shape == (2, jmodel.feature_dim) == (2, model.feature_dim)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("resolution", [(7, 7), (14, 14), (3, 5)])
def test_bias_index_table_equals_jax(resolution):
    got, n = bias_index_table(resolution)
    want, n_want = jcsl._bias_index_table(resolution)
    assert n == n_want and np.array_equal(got, want)
    # a non-persistent buffer: not in the state dict, moved with the module
    model = tcore.build_model("csl_tinyvit_7m", HW)
    assert not any("idx_table" in k for k in model.state_dict())
    assert model.s2_b0.attn.idx_table.dtype == torch.int64


def test_every_name_builds_its_variant():
    """The ten names: each alias builds its target's architecture, and each
    variant's feature width is the JAX model's."""
    for name in tcore.CSL_VARIANTS:
        model = tcore.build_model(name, HW)
        target = tcore.build_model(CSL_ALIASES.get(name, name), HW)
        assert {k: v.shape for k, v in model.state_dict().items()} == \
            {k: v.shape for k, v in target.state_dict().items()}
        assert model.feature_dim == jcore.MODEL_FACTORY[name]().feature_dim


def test_facade_serves_csl():
    reid = ReID(model_name="csl_tinyvit_lmbn", device="cpu")
    img = np.random.default_rng(3).integers(0, 256, (120, 200, 3), dtype=np.uint8)
    boxes = np.array([[10, 5, 60, 100], [100, 20, 150, 110]], np.float32)
    f = reid.get_features(boxes, img)
    assert f.shape == (2, 3584) and np.isfinite(f).all()
    np.testing.assert_allclose(np.linalg.norm(f, axis=1), 1.0, atol=1e-5)
