"""The port's greedy NMS twin (``ops/nms.py::nms_plain``, what K6 computes)
and ``yolox_decode`` against the JAX package's, on the CPU.

Inputs come from numpy seeds (``chip_smoke.nms_edge_sets`` and
``nms_boxes``, which ``chip_smoke.py`` phase 3 also holds K6 to on the
card).  ``keep_idx`` and ``keep_mask`` must be equal exactly: ties go to
the lowest index, IoUs exactly at the threshold do not suppress, NaN IoUs
never suppress.  The decoded boxes differ from JAX's by the last bits of
``exp`` (the port rounds the float64 value once): rtol 1e-6; the scores
are sigmoids of the same raw values, one ulp apart at most: atol 2.5e-7.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxmot_tpu.ops.nms import batched_class_nms as jax_batched_class_nms
from boxmot_tpu.ops.nms import nms as jax_nms
from boxmot_tpu.ops.nms import yolox_decode as jax_yolox_decode
from boxmot_tpu_torch.ops import nms as tnms
from chip_smoke import nms_boxes, nms_edge_sets

EDGE_SETS = nms_edge_sets(np.random.default_rng(7))


def _jax(boxes, scores, classes, thresh, max_out):
    if classes is None:
        keep, mask = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out)
    else:
        keep, mask = jax_batched_class_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                           jnp.asarray(classes), thresh, max_out)
    return np.asarray(keep), np.asarray(mask)


def _port(boxes, scores, classes, thresh, max_out):
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    if classes is None:
        keep, mask = tnms.nms(b, s, thresh, max_out)
    else:
        keep, mask = tnms.batched_class_nms(b, s, torch.from_numpy(classes), thresh, max_out)
    return keep.numpy(), mask.numpy()


@pytest.mark.parametrize("case", EDGE_SETS, ids=[c[0] for c in EDGE_SETS])
def test_nms_twin_equals_jax_on_edge_sets(case):
    _, boxes, scores, classes, thresh, max_out = case
    jk, jm = _jax(boxes, scores, classes, thresh, max_out)
    tk, tm = _port(boxes, scores, classes, thresh, max_out)
    assert tk.dtype == np.int32 and tm.dtype == np.bool_ and tk.shape == (max_out,)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tm, jm)
    assert (tk[~tm] == -1).all() and (tk[tm] >= 0).all()


def test_nms_edge_sets_decide_what_they_name():
    """The edge sets reach their edges: the threshold sets keep the box whose
    IoU equals the threshold, the limits bind, NaN boxes are kept."""
    by = {c[0]: c for c in EDGE_SETS}
    keep = {label: _port(*case[1:])[0] for label, case in by.items()}
    n_kept = {label: int((k >= 0).sum()) for label, k in keep.items()}
    assert n_kept["no positive score"] == 0
    assert n_kept["exactly max_out"] == 64 and n_kept["more survivors than max_out"] == 64
    assert 0 < n_kept["fewer survivors than max_out"] < 64
    assert {1, 4} <= set(keep["IoU exactly at the threshold 0.7"].tolist())  # IoU 0.7: kept
    assert 7 not in keep["IoU exactly at the threshold 0.7"].tolist()  # IoU just above: dropped
    assert {2, 5} <= set(keep["IoU exactly at the threshold 0.5"].tolist())
    _, b, s, *_ = by["NaN coordinates"]
    assert np.isnan(b[keep["NaN coordinates"][0]]).any()
    assert n_kept["N = 1"] == 1


def test_nms_twin_equals_jax_at_scale():
    """N = 4000 clustered boxes, max_out 256: the twin tracks JAX at scale."""
    boxes, scores = nms_boxes(np.random.default_rng(11), 4000)
    jk, jm = _jax(boxes, scores, None, 0.7, 256)
    tk, tm = _port(boxes, scores, None, 0.7, 256)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tm, jm)
    assert tm.all()


def test_nms_wrapper_checks_its_arguments():
    b, s = torch.zeros((3, 4)), torch.ones(3)
    with pytest.raises(ValueError, match="boxes must be"):
        tnms.nms(torch.zeros((3, 5)), s, 0.5)
    with pytest.raises(ValueError, match="scores must be"):
        tnms.nms(b, torch.ones(4), 0.5)
    with pytest.raises(TypeError, match="float32"):
        tnms.nms(b.double(), s.double(), 0.5)
    keep, mask = tnms.nms(b, s, 0.5, 0)
    assert keep.shape == (0,) and mask.shape == (0,)


@pytest.mark.parametrize("img_hw", [(64, 96), (256, 320)])
def test_yolox_decode_matches_jax(img_hw):
    n = sum((img_hw[0] // s) * (img_hw[1] // s) for s in (8, 16, 32))
    raw = np.random.default_rng(3).normal(0, 1.5, (n, 7)).astype(np.float32)
    jb, jo, jc = (np.asarray(a) for a in jax_yolox_decode(jnp.asarray(raw), img_hw=img_hw))
    tb, to, tc = (a.numpy() for a in tnms.yolox_decode(torch.from_numpy(raw), img_hw=img_hw))
    assert tb.shape == jb.shape == (n, 4) and tc.shape == jc.shape == (n, 2)
    np.testing.assert_allclose(tb, jb, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(to, jo, rtol=0, atol=2.5e-7)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=2.5e-7)
