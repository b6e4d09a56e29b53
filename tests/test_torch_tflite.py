"""The port's SavedModel and TFLite exports (``onnxlite/tf_function.py``)
and runtimes (``reid/backends.py``) against the JAX package's, on the CPU.

osnet_x0_25 with the weights of ``tests/test_torch_export.py``, 64 x 32
crops.  Tolerances: the port's artifact within 1e-3 of JAX's (``jax2tf``) on
the same probe and within 2e-2 of the port's forward (``tests/
test_exporters.py``'s tolerance), each scaled by the largest output where
that exceeds 1; dynamic-range quantization correlated > 0.98 with the
forward; the port's backends on JAX-made artifacts (crops through K5's twin
here), on a seeded frame with axis-aligned and rotated boxes: features
within 1e-4 of the JAX backends'; the TF function of four other backbones'
graphs within 1e-5 of the copied evaluator on the same graph.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from boxmot_tpu.reid import backends as jbackends
from boxmot_tpu.reid import exporters as jex
from boxmot_tpu_torch.reid import create_reid
from boxmot_tpu_torch.reid import backends as tbackends
from boxmot_tpu_torch.reid import exporters as tex
from tests.test_torch_export import BOXES, HW, OBBS, carried, frame, probe, seeded


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tf_artifacts(tmp_path_factory):
    """osnet_x0_25's SavedModel and TFLite from both packages, one set of
    carried weights."""
    root = tmp_path_factory.mktemp("tf")
    jmodel, variables, model = carried("osnet_x0_25", seed=2)
    blob = tex.onnx_bytes(model, HW)
    return {
        "model": model,
        "jax_tflite": jex.export_tflite(jmodel, variables, root / "jax" / "osnet_x0_25.tflite",
                                        hw=HW),
        "jax_saved": jex.export_saved_model(jmodel, variables, root / "jax" / "osnet_saved",
                                            hw=HW),
        "tflite": tex.export_tflite(model, root / "osnet_x0_25.tflite", hw=HW, blob=blob),
        "saved": tex.export_saved_model(model, root / "osnet_saved", hw=HW, blob=blob),
        "dynamic": tex.export_tflite(model, root / "osnet_q.tflite", hw=HW, quantize="dynamic",
                                     blob=blob),
    }


def test_tflite_and_saved_model_equal_jax(tf_artifacts):
    from boxmot_tpu_torch.onnxlite.tf_function import tensorflow

    a = tf_artifacts
    x = probe(seed=6)
    ref = tex.forward_nhwc(a["model"], x)
    got = tex.run_tflite(a["tflite"], x)
    scale = max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(got, jex.run_tflite(a["jax_tflite"], x), rtol=0, atol=1e-3 * scale)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2 * scale)
    assert tex.verify_export(a["model"], a["tflite"], hw=HW, atol=2e-2 * scale) < 2e-2 * scale
    tf = tensorflow()
    saved = np.asarray(tf.saved_model.load(str(a["saved"])).fwd(x))
    jsaved = np.asarray(tf.saved_model.load(str(a["jax_saved"])).fwd(x))
    np.testing.assert_allclose(saved, jsaved, rtol=0, atol=1e-3 * scale)
    np.testing.assert_allclose(saved, ref, rtol=0, atol=2e-2 * scale)
    quant = tex.run_tflite(a["dynamic"], x)
    assert np.corrcoef(quant.ravel(), ref.ravel())[0, 1] > 0.98


@pytest.mark.parametrize("kind", ["tflite", "saved"])
def test_backends_equal_jax(tf_artifacts, kind):
    """The port's runtime on a JAX-made artifact against the JAX runtime, on
    axis-aligned and rotated boxes; the dispatch, empty calls and a crop
    size the model was not exported at."""
    path = tf_artifacts[f"jax_{kind}"]
    cls = {"tflite": tbackends.TFLiteReID, "saved": tbackends.SavedModelReID}[kind]
    jcls = {"tflite": jbackends.TFLiteReID, "saved": jbackends.SavedModelReID}[kind]
    backend = create_reid(path, device="cpu", crop_hw=HW, half=True)
    assert isinstance(backend, cls) and backend.feature_dim == 512
    jbackend = jcls(path, crop_hw=HW)
    img = frame()
    for boxes in (BOXES, OBBS):
        got, want = backend.get_features(boxes, img), jbackend.get_features(boxes, img)
        assert got.shape == want.shape == (len(boxes), 512)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert backend.get_features(np.zeros((0, 4)), img).shape == (0, 512)
    if kind == "tflite":
        wrong = cls(path, crop_hw=(32, 16), device="cpu")
        with pytest.raises(ValueError, match="crop_hw the model was exported with"):
            wrong.get_features(BOXES, img)


@pytest.mark.parametrize("name", ["vit_nano", "csl_tinyvit_7m", "mlfn", "mobilenetv2_x1_0"])
def test_tf_function_equals_the_evaluator(name):
    """The TF function of a port graph against the copied evaluator on the
    same graph, on backbones that together hold every op the exporter emits
    beyond OSNet's (layer norms, softmax and its max reduction, products,
    slices, concatenations, pads, grouped convolutions and expands, the
    ReLU6's ``Min``): within 1e-5 of the largest output."""
    from boxmot_tpu_torch.onnxlite import run_onnx
    from boxmot_tpu_torch.onnxlite.tf_function import tf_function
    from boxmot_tpu_torch.reid import core as tcore

    model = seeded(tcore.build_model(name, HW), seed=len(name))
    blob = tex.onnx_bytes(model, HW)
    x = probe(seed=7)
    want = run_onnx(blob, [x])[0]
    got = np.asarray(tf_function(blob, (1, *HW, 3))(x))
    assert got.shape == want.shape == (1, model.feature_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
