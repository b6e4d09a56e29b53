"""Trackers: batched device steps and the live host shell.

The package exports, lazily as the JAX package's does, ``BaseTracker``,
``TrackResults``, the zoo's ``TRACKER_MAPPING`` / ``TRACKER_REGISTRY``,
``create_tracker`` and ``get_tracker_class``, and the ten tracker classes.
"""

_EXPORTS = {
    "BaseTracker": "boxmot_tpu_torch.trackers.base",
    "TrackResults": "boxmot_tpu_torch.trackers.track_results",
    "TRACKER_MAPPING": "boxmot_tpu_torch.trackers.zoo",
    "TRACKER_REGISTRY": "boxmot_tpu_torch.trackers.zoo",
    "create_tracker": "boxmot_tpu_torch.trackers.zoo",
    "get_tracker_class": "boxmot_tpu_torch.trackers.zoo",
    "BoostTrack": "boxmot_tpu_torch.trackers.boosttrack",
    "BotSort": "boxmot_tpu_torch.trackers.botsort",
    "ByteTrack": "boxmot_tpu_torch.trackers.bytetrack",
    "DeepOcSort": "boxmot_tpu_torch.trackers.deepocsort",
    "HybridSort": "boxmot_tpu_torch.trackers.hybridsort",
    "OccluBoost": "boxmot_tpu_torch.trackers.occluboost",
    "OcSort": "boxmot_tpu_torch.trackers.ocsort",
    "Sam2Mot": "boxmot_tpu_torch.trackers.sam2mot",
    "SFSORT": "boxmot_tpu_torch.trackers.sfsort",
    "StrongSort": "boxmot_tpu_torch.trackers.strongsort",
}

__all__ = tuple(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'boxmot_tpu_torch.trackers' has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(mod), name)
