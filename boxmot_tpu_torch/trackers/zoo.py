"""Tracker registry (counterpart of boxmot_tpu/trackers/zoo.py).

ByteTrack and SFSORT are ported, each for axis-aligned and oriented
boxes; every other tracker name raises and names the ROADMAP slice that
brings it.  Config resolution order, as in the JAX
zoo: built-in defaults < per-tracker config dict < kwargs.
"""

from __future__ import annotations

from boxmot_tpu_torch.configs import get_tracker_defaults

# trackers of the JAX zoo that the port does not run yet -> ROADMAP Queue A slice
NOT_PORTED = {
    "ocsort": "Slice 3",
    "botsort": "Slice 4",
    "occluboost": "Slice 4",
    "deepocsort": "Slice 4",
    "strongsort": "Slice 4",
    "boosttrack": "Slice 4",
    "hybridsort": "Slice 4",
    "sam2mot": "Slice 4",
}


PORTED = ("bytetrack", "sfsort")


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
    from boxmot_tpu_torch.trackers.bytetrack import ByteTrack
    from boxmot_tpu_torch.trackers.sfsort import SFSORT

    params = get_tracker_defaults(tracker_type) if tracker_config is None else dict(tracker_config)
    if evolve_param_dict:
        params.update(evolve_param_dict)
    params.update(kwargs)
    params["per_class"] = per_class
    return {"bytetrack": ByteTrack, "sfsort": SFSORT}[tracker_type](device=device, **params)
