"""Tracker registry (counterpart of boxmot_tpu/trackers/zoo.py).

ByteTrack, SFSORT, OC-SORT, BoT-SORT and OccluBoost are ported, each for
axis-aligned and oriented boxes, and DeepOCSORT and BoostTrack for
axis-aligned boxes; every other
tracker name raises and names the ROADMAP slice that brings it.  Config resolution order, as in the JAX
zoo: built-in defaults < per-tracker config dict < kwargs.
"""

from __future__ import annotations

from boxmot_tpu_torch.configs import get_tracker_defaults

# trackers of the JAX zoo that the port does not run yet -> ROADMAP Queue A slice
NOT_PORTED = {
    "strongsort": "Slice 4",
    "hybridsort": "Slice 4",
    "sam2mot": "Slice 4",
}


PORTED = ("bytetrack", "sfsort", "ocsort", "botsort", "deepocsort", "boosttrack", "occluboost")


def check_ported(name: str) -> None:
    """Raise unless ``name`` is a tracker the port runs."""
    if name in PORTED:
        return
    if name in NOT_PORTED:
        raise ValueError(
            f"tracker {name!r} is not ported to PyTorch yet: it arrives with "
            f"ROADMAP Queue A, {NOT_PORTED[name]}"
        )
    raise ValueError(f"Unknown tracker {name!r}; available: {list(PORTED)}")


def create_tracker(tracker_type: str, *, device="cuda", tracker_config: dict | None = None,
                   per_class: bool = False, evolve_param_dict: dict | None = None, **kwargs):
    """Build a live tracker by name on ``device`` ("cpu", "cuda", "cuda:N");
    the card unless the caller asks for the CPU."""
    check_ported(tracker_type)
    from boxmot_tpu_torch.trackers.boosttrack import BoostTrack
    from boxmot_tpu_torch.trackers.botsort import BotSort
    from boxmot_tpu_torch.trackers.bytetrack import ByteTrack
    from boxmot_tpu_torch.trackers.deepocsort import DeepOcSort
    from boxmot_tpu_torch.trackers.occluboost import OccluBoost
    from boxmot_tpu_torch.trackers.ocsort import OcSort
    from boxmot_tpu_torch.trackers.sfsort import SFSORT

    params = get_tracker_defaults(tracker_type) if tracker_config is None else dict(tracker_config)
    if evolve_param_dict:
        params.update(evolve_param_dict)
    params.update(kwargs)
    params["per_class"] = per_class
    classes = {"bytetrack": ByteTrack, "sfsort": SFSORT, "ocsort": OcSort, "botsort": BotSort,
               "deepocsort": DeepOcSort, "boosttrack": BoostTrack, "occluboost": OccluBoost}
    return classes[tracker_type](device=device, **params)
