"""The port's ONNX export (``onnxlite/export.py``, ``torch.export`` to opset
17) against the JAX package's jaxpr translator, on the CPU.

Weights as in ``tests/test_torch_export.py``; crops 64 x 32.  The names
held to JAX are osnet_x0_25, osnet_ain_x0_25, lmbn_n and a narrow
CLIP-ReID of the ``clip`` model's class, 64 wide and 2 layers (JAX's
translator raises on every ViT and CSL-TinyViT name, whose GELU it cannot
translate, and on hacnn).  Tolerances: the JAX package's ``run_onnx`` on
the port's file within 1e-4 of it on JAX's file; the copied evaluator equal
to the JAX one on the port's file to the bit; the port's forward within the
JAX ONNX test's tolerances (``tests/test_onnx_export.py::_export_and_check``:
cosine > 0.999, 5e-5; 5e-4 for LMBN).  Each absolute tolerance is scaled by
the largest output where that exceeds 1 (seeded weights leave the
features' scale free).  The rest of JAX's covered names, and two names JAX
cannot export, go through the port alone (no JAX): the copied evaluator
against the port's forward, with the port's own seeded weights.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from boxmot_tpu.onnxlite import run_onnx as jax_run_onnx
from boxmot_tpu.reid import exporters as jex
from boxmot_tpu_torch.onnxlite import proto as P
from boxmot_tpu_torch.onnxlite import run_onnx
from boxmot_tpu_torch.onnxlite.runtime import decode_model
from boxmot_tpu_torch.reid import core as tcore
from boxmot_tpu_torch.reid import exporters as tex
from tests.test_torch_export import HW, carried, probe, seeded

# the MODEL_FACTORY names JAX's jaxpr translator exports at their smallest crop
JAX_ONNX_NAMES = ("osnet_x1_0", "osnet_x0_75", "osnet_x0_5", "osnet_x0_25", "osnet_ibn_x1_0",
                  "osnet_ain_x1_0", "osnet_ain_x0_75", "osnet_ain_x0_5", "osnet_ain_x0_25",
                  "lmbn_n", "lmbn_ain_n", "cspreid_n", "mlfn", "clip", "resnet50", "resnet101",
                  "mobilenetv2_x1_0", "mobilenetv2_x1_4", "mobilenetv2")
HELD_TO_JAX = ("osnet_x0_25", "osnet_ain_x0_25", "lmbn_n", "clip")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", HELD_TO_JAX)
def test_onnx_equals_jax(name, tmp_path):
    jmodel, variables, model = carried(name, seed=1)
    jpath = jex.export_onnx(jmodel, variables, tmp_path / "jax" / f"{name}.onnx", hw=HW)
    path = tex.export_onnx(model, tmp_path / f"{name}.onnx", hw=HW)
    x = probe()
    mine = jax_run_onnx(path, [x])[0]
    theirs = jax_run_onnx(jpath, [x])[0]
    np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-4 * max(1.0, np.abs(theirs).max()))
    np.testing.assert_array_equal(run_onnx(path, [x])[0], mine)
    ref = tex.forward_nhwc(model, x)
    cos = (mine * ref).sum(-1) / (np.linalg.norm(mine, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() > 0.999
    atol = (5e-4 if name.startswith("lmbn") else 5e-5) * max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(mine, ref, rtol=0, atol=atol)
    nodes, _, ins, outs = decode_model(path.read_bytes())
    assert ins == ["images"] and outs == ["features"] and nodes[0].op == "Transpose"
    graph = P.parse_message(P.parse_message(path.read_bytes())[P.MODEL.GRAPH][0])
    assert graph[P.GRAPH.NAME][0].decode() == f"boxmot_tpu_{name}"


@pytest.mark.parametrize("name", [n for n in JAX_ONNX_NAMES if n not in HELD_TO_JAX]
                         + ["vit_nano", "csl_tinyvit_7m"])
def test_onnx_port_alone(name):
    """The rest of JAX's covered list, and two transformer names beyond it,
    through the port alone: the copied evaluator on the port's graph at batch
    2 against the port's forward."""
    model = seeded(tcore.build_model(name, HW), seed=len(name))
    x = probe(n=2)
    got = run_onnx(tex.onnx_bytes(model, HW, batch=2), [x])[0]
    ref = tex.forward_nhwc(model, x)
    assert got.shape == ref.shape == (2, model.feature_dim)
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() > 0.999
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5 * max(1.0, np.abs(ref).max()))


def test_onnx_refusals():
    """HACNN's spatial transformer has no translation (JAX's raises too)."""
    with pytest.raises(NotImplementedError, match="ATen op"):
        tex.onnx_bytes(tcore.build_model("hacnn"), (160, 64))
