"""Dependency-free ONNX for the port's backbones (counterpart of
``boxmot_tpu/onnxlite``).

- ``proto.py``, ``builder.py``, ``runtime.py``: copies of the JAX package's
  wire format, ``GraphBuilder`` and numpy evaluator (host code);
- ``export.py``: the port's own translator, ``torch.export`` core ATen to
  ONNX opset 17 (the JAX package's walks a jaxpr);
- ``tf_function.py``: a TensorFlow function evaluating such a graph, for
  the SavedModel and TFLite exports.
"""

from boxmot_tpu_torch.onnxlite.export import export_module_to_onnx  # noqa: F401
from boxmot_tpu_torch.onnxlite.runtime import run_onnx  # noqa: F401
