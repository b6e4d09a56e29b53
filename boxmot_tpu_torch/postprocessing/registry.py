"""A copy of ``boxmot_tpu/postprocessing/registry.py``.

Postprocessor registry (mirror of boxmot/postprocessing/registry.py).
"""

from __future__ import annotations

_REGISTRY = {
    "gsi": ("boxmot_tpu_torch.postprocessing.gsi", "GSIPostprocessor"),
    "gbrc": ("boxmot_tpu_torch.postprocessing.gbrc", "GBRCPostprocessor"),
    "gta": ("boxmot_tpu_torch.postprocessing.gta", "GTAPostprocessor"),
}


def supported_postprocessors() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def create_postprocessor(name: str, **kwargs):
    import importlib

    key = name.strip().lower()
    if key not in _REGISTRY:
        raise ValueError(
            f"unknown postprocessor {name!r}; supported: {supported_postprocessors()}"
        )
    module, cls = _REGISTRY[key]
    return getattr(importlib.import_module(module), cls)(**kwargs)


def apply_chain(names: str, mot_results_folder):
    """Apply a comma-separated chain like "gbrc,gta" (engine/cli.py:174-177)."""
    for name in filter(None, (n.strip() for n in names.split(","))):
        create_postprocessor(name).run(mot_results_folder)
