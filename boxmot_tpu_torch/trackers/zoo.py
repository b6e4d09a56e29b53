"""Tracker registry (counterpart of boxmot_tpu/trackers/zoo.py).

Every tracker of the JAX zoo is ported: ByteTrack, SFSORT, OC-SORT, BoT-SORT
and OccluBoost for axis-aligned and oriented boxes; DeepOCSORT, BoostTrack,
StrongSORT and HybridSORT for axis-aligned boxes; and sam2mot, a host
tracker in both packages.  Any other name raises.  Config resolution order,
as in the JAX zoo: built-in defaults < per-tracker config dict < kwargs.
"""

from __future__ import annotations

from boxmot_tpu_torch.configs import get_tracker_defaults

PORTED = ("bytetrack", "sfsort", "ocsort", "botsort", "deepocsort", "boosttrack", "occluboost",
          "strongsort", "hybridsort", "sam2mot")


def check_ported(name: str) -> None:
    """Raise unless ``name`` is a tracker the port runs."""
    if name not in PORTED:
        raise ValueError(f"Unknown tracker {name!r}; available: {list(PORTED)}")


def create_tracker(tracker_type: str, *, device="cuda", tracker_config: dict | None = None,
                   per_class: bool = False, evolve_param_dict: dict | None = None, **kwargs):
    """Build a live tracker by name on ``device`` ("cpu", "cuda", "cuda:N");
    the card unless the caller asks for the CPU (sam2mot, a host tracker,
    takes the argument and runs on the host)."""
    check_ported(tracker_type)
    from boxmot_tpu_torch.trackers.boosttrack import BoostTrack
    from boxmot_tpu_torch.trackers.botsort import BotSort
    from boxmot_tpu_torch.trackers.bytetrack import ByteTrack
    from boxmot_tpu_torch.trackers.deepocsort import DeepOcSort
    from boxmot_tpu_torch.trackers.hybridsort import HybridSort
    from boxmot_tpu_torch.trackers.occluboost import OccluBoost
    from boxmot_tpu_torch.trackers.ocsort import OcSort
    from boxmot_tpu_torch.trackers.sam2mot import Sam2Mot
    from boxmot_tpu_torch.trackers.sfsort import SFSORT
    from boxmot_tpu_torch.trackers.strongsort import StrongSort

    params = get_tracker_defaults(tracker_type) if tracker_config is None else dict(tracker_config)
    if evolve_param_dict:
        params.update(evolve_param_dict)
    params.update(kwargs)
    params["per_class"] = per_class
    classes = {"bytetrack": ByteTrack, "sfsort": SFSORT, "ocsort": OcSort, "botsort": BotSort,
               "deepocsort": DeepOcSort, "boosttrack": BoostTrack, "occluboost": OccluBoost,
               "strongsort": StrongSort, "hybridsort": HybridSort, "sam2mot": Sam2Mot}
    return classes[tracker_type](device=device, **params)
