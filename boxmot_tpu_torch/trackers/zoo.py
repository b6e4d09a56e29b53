"""Tracker registry (counterpart of boxmot_tpu/trackers/zoo.py).

Every tracker of the JAX zoo is ported: ByteTrack, SFSORT, OC-SORT, BoT-SORT
and OccluBoost for axis-aligned and oriented boxes; DeepOCSORT, BoostTrack,
StrongSORT and HybridSORT for axis-aligned boxes; and sam2mot, a host
tracker in both packages.  Any other name raises.  ``name:cpp`` (or
``backend="cpp"``) gives the repo's native C++ core of the tracker, on the
host, as in the JAX zoo.  Config resolution order,
as in the JAX zoo: built-in defaults (or a YAML file's) < per-tracker config
dict < kwargs.
"""

from __future__ import annotations

from boxmot_tpu_torch.configs import get_tracker_defaults, load_tracker_yaml

# the trackers that read appearance embeddings (boxmot_tpu/trackers/zoo.py:25)
REID_TRACKERS = ("botsort", "deepocsort", "strongsort", "boosttrack", "occluboost", "hybridsort")
PORTED = ("bytetrack", "sfsort", "ocsort", "botsort", "deepocsort", "boosttrack", "occluboost",
          "strongsort", "hybridsort", "sam2mot")


def check_ported(name: str) -> None:
    """Raise unless ``name`` is a tracker the port runs."""
    if name not in PORTED:
        raise ValueError(f"Unknown tracker {name!r}; available: {list(PORTED)}")


BACKENDS = ("tpu", "cpp")  # the JAX zoo's: its device programs and its native cores


def parse_tracker_spec(spec: str) -> tuple[str, str]:
    """"name" / "name:backend" -> (name, backend), as
    ``boxmot_tpu/trackers/zoo.py::parse_tracker_spec`` (:39-49)."""
    name, _, backend = spec.partition(":")
    backend = backend or "tpu"
    if backend not in BACKENDS:
        raise ValueError(f"unknown tracker backend {backend!r} in {spec!r}")
    return name, backend


def create_tracker(tracker_type: str, *, device="cuda", tracker_config=None,
                   reid_weights=None, half: bool = False, per_class: bool = False,
                   evolve_param_dict: dict | None = None, backend: str | None = None, **kwargs):
    """Build a live tracker by name on ``device`` ("cpu", "cuda", "cuda:N");
    the card unless the caller asks for the CPU (sam2mot, a host tracker,
    takes the argument and runs on the host).  For an appearance tracker,
    ``reid_weights`` (a model name or a torchreid checkpoint) builds its
    ``reid_model`` on the same device, in bf16 with ``half``, unless the
    caller passes one.

    ``tracker_type`` may carry a backend ("bytetrack:tpu"), or ``backend``
    names it (it wins over the spec's, as in the JAX zoo): "tpu", the
    default, is the port's device tracker; "cpp" is the repo's native C++
    core of the tracker (``native.trackers.NativeTracker``), host code that
    takes ``device`` and ignores it, and raises where the native library
    cannot be built; any other backend raises ``ValueError``.
    ``tracker_config`` is a dict of params or the path of a tracker YAML file
    (read with ``yaml``)."""
    if ":" in tracker_type:
        tracker_type, spec_backend = parse_tracker_spec(tracker_type)
        backend = backend or spec_backend
    backend = backend or "tpu"
    if backend not in BACKENDS:
        raise ValueError(f"unknown tracker backend {backend!r}; available: {list(BACKENDS)}")
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

    if tracker_config is None:
        params = get_tracker_defaults(tracker_type)
    elif isinstance(tracker_config, dict):
        params = dict(tracker_config)
    else:
        params = load_tracker_yaml(tracker_config)
    if evolve_param_dict:
        params.update(evolve_param_dict)
    params.update(kwargs)
    if backend == "cpp":
        from boxmot_tpu_torch.native.trackers import NATIVE_LIVE_TRACKERS, NativeTracker

        if tracker_type not in NATIVE_LIVE_TRACKERS:
            raise ValueError(f"no native (cpp) core for {tracker_type!r}; "
                             f"available: {sorted(NATIVE_LIVE_TRACKERS)}")
        return NativeTracker(tracker_type, per_class=per_class, device=device, **params)
    params["per_class"] = per_class
    if reid_weights is not None and tracker_type in REID_TRACKERS:
        from boxmot_tpu_torch.reid import create_reid

        params.setdefault("reid_model", create_reid(weights=reid_weights, half=half, device=device))
    classes = {"bytetrack": ByteTrack, "sfsort": SFSORT, "ocsort": OcSort, "botsort": BotSort,
               "deepocsort": DeepOcSort, "boosttrack": BoostTrack, "occluboost": OccluBoost,
               "strongsort": StrongSort, "hybridsort": HybridSort, "sam2mot": Sam2Mot}
    return classes[tracker_type](device=device, **params)
