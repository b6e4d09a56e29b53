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
    "sfsort": {
        "high_th": 0.6,
        "match_th_first": 0.67,
        "new_track_th": 0.7,
        "low_th": 0.1,
        "match_th_second": 0.3,
        "dynamic_tuning": False,
        "cth": 0.5,
        "high_th_m": 0.0,
        "new_track_th_m": 0.0,
        "match_th_first_m": 0.0,
        "marginal_timeout": 0,
        "central_timeout": 0,
        "horizontal_margin": 0,
        "vertical_margin": 0,
    },
    "ocsort": {
        "min_conf": 0.1,
        "det_thresh": 0.6,
        "max_age": 30,
        "min_hits": 3,
        "delta_t": 3,
        "asso_func": "iou",
        "use_byte": False,
        "inertia": 0.1,
        "Q_xy_scaling": 0.01,
        "Q_s_scaling": 0.0001,
    },
}


def get_tracker_defaults(name: str) -> dict:
    """{param: default} for a ported tracker; {} for any other name, as the
    JAX function returns for a tracker without a YAML."""
    return dict(_DEFAULTS.get(name, {}))
