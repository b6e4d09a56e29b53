"""Tracker runtime defaults (mirror of the YAML tier read by
``boxmot_tpu.configs.get_tracker_defaults``).

The JAX package reads ``configs/trackers/<name>.yaml`` with ``yaml``, which
the machine with the card may not have, so the defaults of the trackers the
port runs are written out here.  A CPU test holds them equal to the YAML.
A caller's own YAML file (``create_tracker(tracker_config=path)``) is read
with ``yaml`` where it is installed (``load_tracker_yaml``).
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
    # appearance thresholds under with_reid, and so on) flattened to the top
    # level, in the JAX flattening's order
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
    "boosttrack": {
        "max_age": 60,
        "min_hits": 3,
        "det_thresh": 0.6,
        "iou_threshold": 0.3,
        "use_cmc": True,
        "cmc_method": "ecc",
        "min_box_area": 10,
        "aspect_ratio_thresh": 1.6,
        "lambda_iou": 0.5,
        "lambda_mhd": 0.25,
        "lambda_shape": 0.25,
        "use_dlo_boost": True,
        "use_duo_boost": True,
        "dlo_boost_coef": 0.65,
        "s_sim_corr": False,
        "use_rich_s": True,
        "use_sb": True,
        "use_vt": True,
        "with_reid": True,
        "adaptive_kf": False,
    },
    "occluboost": {
        "max_age": 146,
        "min_hits": 1,
        "det_thresh": 0.5678626013369781,
        "iou_threshold": 0.2957128153631725,
        "use_cmc": True,
        "cmc_method": "sof",
        "min_box_area": 73,
        "aspect_ratio_thresh": 1.4888137942764672,
        "lambda_iou": 1.0784558316374715,
        "lambda_mhd": 0.304435887183232,
        "lambda_shape": 1.6709449476805447,
        "use_dlo_boost": True,
        "dlo_boost_coef": 1.2061962091907352,
        "use_duo_boost": False,
        "s_sim_corr": False,
        "use_rich_s": False,
        "use_sb": True,
        "use_vt": True,
        "with_reid": True,
        "recovery_appearance_thresh": 0.6732855110134396,
        "recovery_iou_thresh": 0.24380051350243462,
        "recovery_max_age": 113,
        "feat_alpha": 0.8324072665785186,
        "track_low_thresh": 0.04473431588067598,
        "use_second_pass": True,
        "second_iou_thresh": 0.8131671757478834,
        "second_appearance_thresh": 0.364089272226479,
        "second_pass_max_age": 8,
        "second_pass_min_hits": 7,
        "new_track_thresh": 0.7128242784621849,
        "confirm_hits": 2,
        "instant_confirm_thresh": 0.6783889178413256,
        "tentative_max_age": 3,
        "duplicate_iou_thresh": 0.9571823233925608,
        "ams_enabled": True,
        "ams_alpha0": 0.8732388616784778,
        "ams_threshold": 0.9206232808452425,
        "ams_buffer_size": 57,
        "ams_shrink_ratio": 0.6934881647679682,
        "lambda_emb_multiplier": 2.9476295884842885,
        "gta_enabled": False,
        "gta_appearance_thresh": 0.7125445489563044,
        "gta_min_track_length": 7,
        "gta_smooth_tau": 14.757519908748044,
        "gta_interpolate": False,
        "gta_max_gap": 40,
        "adaptive_kf": False,
    },
    "strongsort": {
        "min_conf": 0.6,
        "ema_alpha": 0.9,
        "max_cos_dist": 0.4,
        "max_iou_dist": 0.7,
        "max_age": 30,
        "n_init": 3,
        "mc_lambda": 0.98,
        "nn_budget": 100,
    },
    "hybridsort": {
        "det_thresh": 0.38633684113126876,
        "max_age": 230,
        "max_obs": 90,
        "min_hits": 1,
        "iou_threshold": 0.24623615333496582,
        "asso_func": "diou",
        "dataset": "",
        "cmc_method": "ecc",
        "delta_t": 4,
        "use_byte": False,
        "low_thresh": 0.1,
        "TCM_byte_step": True,
        "TCM_byte_step_weight": 1.0,
        "TCM_first_step": True,
        "inertia": 0.07385224556640951,
        "track_thresh": 0.3190991353484191,
        "with_reid": True,
        "longterm_bank_length": 270,
        "alpha": 0.9189916764734039,
        "adapfs": True,
        "EG_weight_high_score": 3.8961609177336562,
        "EG_weight_low_score": 0.5096125821683565,
        "high_score_matching_thresh": 0.6764212909416498,
        "with_longterm_reid": True,
        "longterm_reid_weight": 1.9752492019041523,
        "with_longterm_reid_correction": True,
        "longterm_reid_correction_thresh": 0.11310432273756706,
        "longterm_reid_correction_thresh_low": 0.3479740001301599,
    },
    "sam2mot": {
        "tolerance_frames": 30,
        "memory_window": 25,
        "cost_weight": 0.5,
        "tau_r": 0.8,
        "tau_p": 0.5,
        "tau_s": 0.3,
        "density_threshold": 0.9,
        "second_stage_iou_threshold": 0.3,
        "frame_out_d_thre": 0.6,
        "miou_threshold": 0.8,
        "untracked_ratio_threshold": 0.5,
        "new_track_thresh": 0.5,
    },
}


def flatten_config(specs: dict) -> dict:
    """Specs -> {param: default} runtime kwargs (a copy of
    ``boxmot_tpu/configs/__init__.py::flatten_config``, :31-51).

    Mirrors reference flatten_yaml_config (search_space.py:43-62): entries
    with an ``activates`` block have all descendants promoted to the top
    level; parents keep their own default.
    """
    out = {}

    def _visit(entries: dict) -> None:
        for key, spec in entries.items():
            if isinstance(spec, dict) and "default" in spec:
                out[key] = spec["default"]
                children = spec.get("activates")
                if isinstance(children, dict):
                    _visit(children)
            else:
                out[key] = spec

    _visit(specs)
    return out


def load_tracker_yaml(path) -> dict:
    """The runtime params of a tracker YAML file (param specs flattened to
    their defaults), as the JAX zoo reads a ``tracker_config`` path.
    ``yaml`` is imported here alone: the default paths never need it."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"reading the tracker config {str(path)!r} needs PyYAML, which is not installed; pass "
            "the params as a dict (tracker_config={...}) or as keyword arguments") from e
    with open(path) as f:
        return flatten_config(yaml.safe_load(f) or {})


def get_tracker_defaults(name: str) -> dict:
    """{param: default} for a ported tracker; {} for any other name, as the
    JAX function returns for a tracker without a YAML."""
    return dict(_DEFAULTS.get(name, {}))
