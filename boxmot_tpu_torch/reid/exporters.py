"""ReID model exporters (counterpart of ``boxmot_tpu/reid/exporters.py``).

The JAX package's targets, from the port's modules:

  * checkpoint       - Flax msgpack (``models/flax_msgpack.py``) of the
    model's Flax tree (``models/convert.py::flax_paths``: HWIO kernels,
    ``batch_stats``), which the JAX package's ``load_checkpoint`` reads and
    the port's ``ReID`` loads;
  * torch state dict - torchreid's ``{"state_dict": ...}`` ``.pt`` of the
    OSNet family (the port's OSNet modules carry torchreid's names);
  * onnx             - opset 17 through ``onnxlite/export.py``
    (``torch.export``), input ``"images"`` NHWC ``(B, H, W, 3)``
    as in the JAX artifact, output ``"features"``;
  * SavedModel / TFLite - a ``tf.function`` traced from that ONNX graph
    (``onnxlite/tf_function.py``), saved or converted with the JAX
    package's calls and signature (batch 1, NHWC), float32, ``"dynamic"``
    or ``"int8"``.

Each verifier runs the artifact on the host and the port's forward on the
model's device (float32; ``utils/device.py`` keeps TF32 off) on the JAX
package's fixed probe.  ``run_export`` builds ``ReID`` on ``device``, the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from boxmot_tpu_torch.models import convert as convert_mod
from boxmot_tpu_torch.models import flax_msgpack
from boxmot_tpu_torch.models.osnet import OSNET_VARIANTS

TARGETS = ("checkpoint", "torch", "saved_model", "tflite", "onnx")


def flax_variables(model: torch.nn.Module, name: str) -> dict:
    """The port's ``model`` (backbone ``name``) as Flax ``{"params",
    "batch_stats"}`` of float32 numpy arrays: the inverse of
    ``convert.state_dict_from_flax_paths`` (OIHW kernels to HWIO, dense
    kernels transposed)."""
    sd = model.state_dict()
    tree: dict = {}
    for key, (coll, *path) in convert_mod.flax_paths(model, name).items():
        a = sd[key].detach().to("cpu", torch.float32).numpy()
        if path[-1] == "kernel":
            a = np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a.T
        node = tree.setdefault(coll, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return tree


def export_checkpoint(model: torch.nn.Module, name: str, path: Path) -> Path:
    """Flax msgpack of ``flax_variables(model, name)``."""
    return flax_msgpack.write_variables(flax_variables(model, name), path)


def load_checkpoint(model: torch.nn.Module, name: str, path: Path) -> torch.nn.Module:
    """Load a Flax msgpack checkpoint (of either package) into ``model``."""
    sd = convert_mod.state_dict_from_flax_paths(model, name, flax_msgpack.read_variables(path))
    model.load_state_dict(sd)
    return model


def export_torch_state_dict(model: torch.nn.Module, name: str, path: Path) -> Path:
    """torchreid-format ``.pt`` of an OSNet variant: its state dict without
    the batch norms' ``num_batches_tracked``, the JAX package's keys.  Other
    families have no torchreid layout and raise."""
    if name not in OSNET_VARIANTS:
        raise ValueError(f"torch state dict export supports the OSNet family, not {name!r}")
    sd = {k: v.detach().to("cpu", torch.float32).clone() for k, v in model.state_dict().items()
          if "num_batches_tracked" not in k}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": sd}, path)
    return path


def onnx_bytes(model: torch.nn.Module, hw=(256, 128), batch: int = 1,
               graph_name: str = "boxmot_tpu") -> bytes:
    """The ONNX model of ``model``'s forward on NHWC ``(batch, H, W, 3)``."""
    from boxmot_tpu_torch.onnxlite.export import export_module_to_onnx  # noqa: PLC0415

    return export_module_to_onnx(model, (batch, hw[0], hw[1], 3), graph_name=graph_name)


def export_onnx(model: torch.nn.Module, path: Path, hw=(256, 128), batch: int = 1,
                blob: bytes | None = None) -> Path:
    """ONNX (opset 17), static at ``batch``; graph ``boxmot_tpu_<stem>`` as
    the JAX package names it.  ``blob``: the graph, where made already."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(blob or onnx_bytes(model, hw, batch, graph_name=f"boxmot_tpu_{path.stem}"))
    return path


def _tf_function(model: torch.nn.Module, hw, blob: bytes | None = None):
    """The batch-1 ``tf.function`` of ``model``'s ONNX graph (``blob``, where
    made already)."""
    from boxmot_tpu_torch.onnxlite.tf_function import tf_function  # noqa: PLC0415

    return tf_function(blob or onnx_bytes(model, hw), (1, hw[0], hw[1], 3))


def export_saved_model(model: torch.nn.Module, path: Path, hw=(256, 128),
                       blob: bytes | None = None) -> Path:
    from boxmot_tpu_torch.onnxlite.tf_function import tensorflow  # noqa: PLC0415

    tf = tensorflow()
    path = Path(path)
    module = tf.Module()
    module.fwd = _tf_function(model, hw, blob)
    tf.saved_model.save(module, str(path))
    return path


def export_tflite(model: torch.nn.Module, path: Path, hw=(256, 128), quantize: str | None = None,
                  representative_batches=None, blob: bytes | None = None) -> Path:
    """quantize: None (float32), "dynamic", or "int8" (needs
    representative_batches: an iterable of (1, H, W, 3) float arrays)."""
    from boxmot_tpu_torch.onnxlite.tf_function import tensorflow  # noqa: PLC0415

    tf = tensorflow()
    fn = _tf_function(model, hw, blob)
    converter = tf.lite.TFLiteConverter.from_concrete_functions([fn.get_concrete_function()])
    if quantize in ("dynamic", "int8"):
        converter.optimizations = [tf.lite.Optimize.DEFAULT]
    if quantize == "int8":
        if representative_batches is None:
            raise ValueError("int8 quantization needs representative_batches")

        def rep():
            for batch in representative_batches:
                yield [np.asarray(batch, np.float32)]

        converter.representative_dataset = rep
    blob = converter.convert()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(blob)
    return path


def run_onnx_export(path: Path, x: np.ndarray) -> np.ndarray:
    """Run an exported ``.onnx``: onnxruntime where it is installed, else the
    copied ``onnxlite`` evaluator."""
    try:
        import onnxruntime as ort  # noqa: PLC0415

        sess = ort.InferenceSession(str(path), providers=["CPUExecutionProvider"])
        return sess.run(None, {"images": np.asarray(x, np.float32)})[0]
    except ImportError:
        from boxmot_tpu_torch.onnxlite import run_onnx  # noqa: PLC0415

        return run_onnx(path, [np.asarray(x, np.float32)])[0]


def run_tflite(path: Path, x: np.ndarray) -> np.ndarray:
    from boxmot_tpu_torch.onnxlite.tf_function import tensorflow  # noqa: PLC0415

    interp = tensorflow().lite.Interpreter(model_path=str(path))
    interp.allocate_tensors()
    inp = interp.get_input_details()[0]
    out = interp.get_output_details()[0]
    interp.set_tensor(inp["index"], np.asarray(x, np.float32))
    interp.invoke()
    return interp.get_tensor(out["index"])


@torch.no_grad()
def forward_nhwc(model: torch.nn.Module, x: np.ndarray) -> np.ndarray:
    """The port's forward of NHWC float32 crops, on the model's device."""
    p = next(model.parameters())
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).permute(0, 3, 1, 2)
    return model(t.to(p.device, p.dtype)).float().cpu().numpy()


def probe(hw) -> np.ndarray:
    """The JAX package's fixed verification input: (1, H, W, 3) in [-1, 1)."""
    return np.random.default_rng(0).uniform(-1, 1, (1, hw[0], hw[1], 3)).astype(np.float32)


def verify_export(model: torch.nn.Module, path: Path, hw=(256, 128), atol=1e-3) -> float:
    """Max abs deviation between the source model and the exported tflite
    artifact on the fixed probe; raises above ``atol``."""
    x = probe(hw)
    dev = float(np.abs(forward_nhwc(model, x) - run_tflite(path, x)).max())
    if dev > atol:
        raise AssertionError(f"export parity failure: max deviation {dev} > {atol}")
    return dev


def run_export(weights=None, model_name: str = "osnet_x0_25", include=("tflite",),
               out_dir="exports", hw=(256, 128), quantize: str | None = None, verify: bool = True,
               device="cuda"):
    """Export ``weights`` (or ``model_name``'s seeded weights) to each target
    of ``include``; returns an ``ExportResult`` {target: {"path", "max_dev"?}}
    (the onnx and tflite targets verified against the forward on ``device``
    within 5e-3)."""
    from boxmot_tpu_torch.engine.results import ExportResult  # noqa: PLC0415
    from boxmot_tpu_torch.reid.core import ReID  # noqa: PLC0415

    reid = ReID(weights=weights, model_name=None if weights else model_name, crop_hw=hw,
                device=device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    results, graphs = {}, {}
    for target in include:
        results[target] = export_target(reid, target, out, quantize=quantize, verify=verify,
                                        graphs=graphs)
    return ExportResult(results)


def export_target(reid, target: str, out: Path, quantize: str | None = None, verify: bool = True,
                  graphs: dict | None = None) -> dict:
    """One target of ``run_export`` for the ``ReID`` facade ``reid``:
    {"path", "max_dev"?}.  ``graphs`` keeps the model's ONNX graph for the
    onnx, SavedModel and TFLite targets of one export, so it is traced once."""
    model, stem, hw = reid.model, reid.model_name, reid.crop_hw
    graphs = {} if graphs is None else graphs

    def graph() -> bytes:
        if "onnx" not in graphs:
            graphs["onnx"] = onnx_bytes(model, hw, graph_name=f"boxmot_tpu_{stem}")
        return graphs["onnx"]

    info = {}
    if target == "checkpoint":
        info["path"] = export_checkpoint(model, stem, out / f"{stem}.msgpack")
    elif target == "torch":
        info["path"] = export_torch_state_dict(model, stem, out / f"{stem}.pt")
    elif target == "saved_model":
        info["path"] = export_saved_model(model, out / f"{stem}_saved", hw=hw, blob=graph())
    elif target == "onnx":
        info["path"] = export_onnx(model, out / f"{stem}.onnx", hw=hw, blob=graph())
        if verify:
            x = probe(hw)
            info["max_dev"] = float(np.abs(forward_nhwc(model, x)
                                           - run_onnx_export(info["path"], x)).max())
            if info["max_dev"] > 5e-3:
                raise AssertionError(f"onnx export parity failure: {info['max_dev']}")
    elif target == "tflite":
        info["path"] = export_tflite(model, out / f"{stem}.tflite", hw=hw, quantize=quantize,
                                     blob=graph())
        if verify:
            info["max_dev"] = verify_export(model, info["path"], hw=hw, atol=5e-3)
    else:
        raise ValueError(f"unknown export target {target!r}; choose from "
                         "checkpoint,torch,saved_model,tflite,onnx")
    return info
