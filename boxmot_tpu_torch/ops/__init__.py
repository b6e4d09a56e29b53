"""Geometry, IoU, and the two hand-written kernels with their plain twins.

The package exports, lazily, what the JAX package's ``ops`` does: the
``geometry`` module, the IoU family with ``ASSO_FUNCS`` / ``ASSO_FUNCS_WH``
and ``get_asso_func``, and ``linear_assignment``, ``linear_assignment_np`` and
``masked_assignment``.
"""

_EXPORTS = {
    **dict.fromkeys(("ASSO_FUNCS", "ASSO_FUNCS_WH", "ciou_batch", "centroid_batch",
                     "centroid_batch_obb", "diou_batch", "get_asso_func", "giou_batch",
                     "hmiou_batch", "iou_batch", "iou_batch_obb"), "boxmot_tpu_torch.ops.iou"),
    **dict.fromkeys(("linear_assignment", "linear_assignment_np", "masked_assignment"),
                    "boxmot_tpu_torch.ops.lap"),
}

__all__ = ("geometry", *_EXPORTS)


def __getattr__(name):
    from importlib import import_module

    if name == "geometry":
        return import_module("boxmot_tpu_torch.ops.geometry")
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'boxmot_tpu_torch.ops' has no attribute {name!r}")
    return getattr(import_module(mod), name)
