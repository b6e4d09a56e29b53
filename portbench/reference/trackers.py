"""A tracker of the frozen copies by name: (config class, init_state, step)."""

from __future__ import annotations

import dataclasses
import importlib
import inspect


def resolve(name: str):
    """``frozen/trackers/<name>.py``'s config dataclass, ``init_state`` and
    ``<name>_step``, the step taking (cfg, state, dets, det_valid, embs,
    warps) whatever the tracker reads."""
    module = importlib.import_module(f"portbench.reference.frozen.trackers.{name}")
    config = next(v for k, v in vars(module).items() if k.endswith("Config")
                  and dataclasses.is_dataclass(v) and v.__module__ == module.__name__)
    step = getattr(module, f"{name}_step")
    if len(inspect.signature(step).parameters) == 4:
        motion_only = step
        step = lambda cfg, s, d, v, e, w: motion_only(cfg, s, d, v)  # noqa: E731
    return config, module.init_state, step

