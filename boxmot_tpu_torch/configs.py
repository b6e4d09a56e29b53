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
    # the YAML's "activates" children (cmc_method under use_cmc, the
    # appearance thresholds under with_reid) flattened to the top level
    "botsort": {
        "track_high_thresh": 0.6296854875023994,
        "track_low_thresh": 0.1014392537025336,
        "new_track_thresh": 0.6246494191492591,
        "track_buffer": 40,
        "match_thresh": 0.7722224024589055,
        "use_cmc": True,
        "cmc_method": "sof",
        "frame_rate": 30,
        "fuse_first_associate": True,
        "with_reid": True,
        "proximity_thresh": 0.6084297894561342,
        "appearance_thresh": 0.6188818853936099,
        "unconfirmed_emb_scale": 2.5445206391993294,
        "second_match_thresh": 0.28795081514328974,
        "unconfirmed_match_thresh": 0.41148010638233784,
        "removed_stracks_buffer": 329,
    },
    "deepocsort": {
        "det_thresh": 0.5,
        "max_age": 30,
        "min_hits": 3,
        "iou_thresh": 0.3,
        "delta_t": 3,
        "asso_func": "iou",
        "inertia": 0.2,
        "w_association_emb": 0.75,
        "alpha_fixed_emb": 0.95,
        "aw_param": 0.5,
        "embedding_off": False,
        "cmc_off": False,
        "aw_off": False,
        "Q_xy_scaling": 0.01,
        "Q_s_scaling": 0.0001,
    },
}


def get_tracker_defaults(name: str) -> dict:
    """{param: default} for a ported tracker; {} for any other name, as the
    JAX function returns for a tracker without a YAML."""
    return dict(_DEFAULTS.get(name, {}))
