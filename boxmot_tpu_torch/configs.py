"""Tracker runtime defaults (mirror of the YAML tier read by
``boxmot_tpu.configs.get_tracker_defaults``).

The JAX package reads ``configs/trackers/<name>.yaml`` with ``yaml``, which
the machine with the card may not have, so the defaults of the trackers the
port runs are written out here.  A CPU test holds them equal to the YAML.
"""

from __future__ import annotations

_DEFAULTS = {
    "bytetrack": {
        "min_conf": 0.1,
        "track_thresh": 0.6,
        "track_buffer": 30,
        "match_thresh": 0.9,
        "frame_rate": 30,
    },
}


def get_tracker_defaults(name: str) -> dict:
    """{param: default} for a ported tracker; {} for any other name, as the
    JAX function returns for a tracker without a YAML."""
    return dict(_DEFAULTS.get(name, {}))
