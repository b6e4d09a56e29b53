"""Config data and its readers (counterpart of ``boxmot_tpu/configs/__init__.py``).

The package holds copies of the JAX package's YAML data: the tracker specs
(``trackers/*.yaml``), the benchmark-tuned overlays (``trackers/tuned/``),
the benchmark configs (``benchmarks/``, read by ``benchmark.py``), the ReID
training recipes (``training/``) and the workflow modes (``modes.yaml``).
The readers below are the JAX package's, with ``yaml`` imported where a file
is read, so that the evals and the live API, which need only the defaults,
never import it: the runtime defaults of the trackers the port runs are
written out in ``_DEFAULTS``, and a CPU test holds them equal to the YAML.
"""

from __future__ import annotations

from pathlib import Path

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


def _read_yaml(path) -> dict:
    """A YAML file's mapping ({} for an empty file); ``yaml`` is imported
    here alone."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"reading the config {str(path)!r} needs PyYAML, which is not installed; pass "
            "the params as a dict (tracker_config={...}) or as keyword arguments") from e
    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_tracker_yaml(path) -> dict:
    """The runtime params of a tracker YAML file (param specs flattened to
    their defaults), as the JAX zoo reads a ``tracker_config`` path."""
    return flatten_config(_read_yaml(path))


def get_tracker_defaults(name: str) -> dict:
    """{param: default} for a ported tracker; {} for any other name, as the
    JAX function returns for a tracker without a YAML."""
    return dict(_DEFAULTS.get(name, {}))


TRACKER_CONFIG_DIR = Path(__file__).parent / "trackers"


def get_tracker_config_path(name: str) -> Path:
    path = TRACKER_CONFIG_DIR / f"{name}.yaml"
    if not path.exists():
        raise FileNotFoundError(f"no config for tracker {name!r} at {path}")
    return path


def load_tracker_config(name: str) -> dict:
    """Full param specs: {param: {type, default, range/options}}."""
    return _read_yaml(get_tracker_config_path(name))


def flatten_specs(specs: dict) -> dict:
    """Specs with ``activates`` children promoted to the top level, each
    keeping its full spec dict (reference flatten_yaml_config,
    search_space.py:43-62) — the form search backends consume."""
    out = {}

    def _visit(entries: dict) -> None:
        for key, spec in entries.items():
            if isinstance(spec, dict):
                out[key] = {k: v for k, v in spec.items() if k != "activates"}
                children = spec.get("activates")
                if isinstance(children, dict):
                    _visit(children)
            else:
                out[key] = spec

    _visit(specs)
    return out


def available_tuned_configs() -> tuple[str, ...]:
    tuned_dir = Path(__file__).resolve().parent / "trackers" / "tuned"
    return tuple(sorted(p.stem for p in tuned_dir.glob("*.yaml")))


def load_tuned_config(name: str) -> dict:
    """Benchmark-tuned runtime params (reference configs/trackers/tuned/).

    ``name`` is "<tracker>_<benchmark>_<split>", e.g.
    "occluboost_mot17_ablation".  Returns base defaults overlaid with the
    tuned values — ready to pass as tracker params.
    """
    tuned_dir = Path(__file__).resolve().parent / "trackers" / "tuned"
    path = tuned_dir / f"{name}.yaml"
    if not path.exists():
        raise ValueError(
            f"unknown tuned config {name!r}; available: {available_tuned_configs()}"
        )
    tracker = name.split("_", 1)[0]
    return {**get_tracker_defaults(tracker), **_read_yaml(path)}


TRAINING_RECIPES_DIR = Path(__file__).resolve().parent / "training"

# recipe keys that configure torchvision machinery the trainer does not
# have, or eval-time behavior the repo handles elsewhere; listed so
# resolution is loud about what it drops rather than silently permissive
_RECIPE_IGNORED_KEYS = frozenset(
    {
        "preprocess",  # crop normalizer — export/runtime tier in this repo
        "random_patch",  # torchreid RandomPatch — not implemented
        "color_augmentation",  # AlexNet-style PCA jitter — not implemented
        "eta_min",  # cosine floor is lr/1000 in make_schedule
        "branch_loss_agg",  # LMBN multi-branch aggregation — single head here
    }
)

# nested hparams-style recipe sections (the CSL-TinyViT recipes;
# reference _flatten_training_recipe_values, configs/__init__.py:35-134)
_RECIPE_SECTIONS = (
    "run", "data", "model", "optimization", "losses",
    "augmentation", "evaluation", "system", "derived",
)

# (section path) -> flat recipe key
_NESTED_RECIPE_PATHS = {
    ("run", "model_name"): "model",
    ("run", "seed"): "seed",
    ("data", "dataset"): "dataset",
    ("data", "img_size"): "imgsz",
    ("data", "batch_size"): "batch_size",
    ("data", "sampler", "p"): "p_ids",
    ("data", "sampler", "k"): "k_instances",
    ("optimization", "epochs"): "epochs",
    ("optimization", "optimizer"): "optimizer",
    ("optimization", "lr"): "lr",
    ("optimization", "weight_decay"): "weight_decay",
    ("optimization", "grad_clip"): "grad_clip",
    ("optimization", "layer_decay"): "layer_decay",
    ("optimization", "vit_lr_profile"): "vit_lr_profile",
    ("optimization", "backbone_freeze_epochs"): "backbone_freeze_epochs",
    ("optimization", "scheduler", "warmup_epochs"): "warmup_epochs",
    ("optimization", "ema_decay"): "ema_decay",
    ("model", "head", "warmup_epochs"): "head_warmup_epochs",
    ("model", "head", "warmup_lr_mult"): "head_warmup_lr_mult",
    ("losses", "loss_type"): "loss",
    ("losses", "classifier_loss"): "classifier_loss",
    ("losses", "label_smooth"): "label_smooth",
    ("losses", "weights", "id_loss_weight"): "id_loss_weight",
    ("losses", "weights", "metric_loss_weight"): "metric_loss_weight",
    ("losses", "weights", "center_loss_weight"): "center_loss_weight",
    ("losses", "weights", "aux_ce_weight"): "aux_ce_weight",
    ("losses", "aux_ce_drop_epoch"): "aux_ce_drop_epoch",
    ("losses", "triplet", "margin"): "margin",
    ("losses", "triplet", "soft_margin"): "soft_margin",
    ("losses", "arcface", "scale"): "arcface_scale",
    ("losses", "arcface", "margin"): "arcface_margin",
    ("losses", "cosface", "scale"): "cosface_scale",
    ("losses", "cosface", "margin"): "cosface_margin",
    ("augmentation", "color_jitter"): "color_jitter",
    ("augmentation", "gaussian_blur"): "gaussian_blur",
    ("augmentation", "random_grayscale"): "random_grayscale",
    ("augmentation", "random_erasing"): "random_erasing",
    ("evaluation", "eval_interval"): "eval_interval",
    ("evaluation", "flip_tta"): "flip_tta",
}


def _flatten_nested_recipe(values: dict) -> dict:
    """Nested hparams recipe -> flat recipe vocabulary.  Architecture
    hyperparameters (model.head/attention/...) are baked into the named
    backbone variant here, so only train-arg paths are lifted."""
    out: dict = {}
    for path, key in _NESTED_RECIPE_PATHS.items():
        node = values
        for part in path:
            if not isinstance(node, dict) or part not in node:
                node = None
                break
            node = node[part]
        if node is not None:
            out[key] = node
    return out


def list_training_recipes() -> tuple[str, ...]:
    """Names of the shipped training recipes (reference
    configs/__init__.py:151-153 list_training_recipes)."""
    return tuple(sorted(p.stem for p in TRAINING_RECIPES_DIR.glob("*.yaml")))


def load_training_recipe(name: str) -> dict:
    """Raw recipe values by name (reference load_training_recipe,
    configs/__init__.py:137-148)."""
    path = TRAINING_RECIPES_DIR / f"{name}.yaml"
    if not path.exists():
        raise ValueError(
            f"unknown training recipe {name!r}; available: "
            f"{', '.join(list_training_recipes()) or '(none)'}"
        )
    values = _read_yaml(path)
    # a flat recipe may legitimately contain a key that shares a section
    # name ("model: lmbn_n"); only dict-valued sections mark nesting
    if any(isinstance(values.get(s), dict) for s in _RECIPE_SECTIONS):
        values = _flatten_nested_recipe(values)
    return values


def train_config_kwargs_from_recipe(values: dict) -> dict:
    """Map reference recipe vocabulary onto TrainConfig field names.

    The reference trainer consumes recipes as flat train-arg dicts
    (configs/__init__.py:35-56); this repo's TrainConfig is step-based,
    so keys are renamed (lr -> base_lr, margin ->
    triplet_margin, imgsz -> crop_hw, p_ids/k_instances -> p/k) and
    epoch counts pass through for the trainer to resolve against the
    dataset size.  Unknown keys raise; known-but-inapplicable keys
    (flip_tta, preprocess, ...) are dropped.
    """
    rename = {
        "lr": "base_lr",
        "margin": "triplet_margin",
        "p_ids": "p",
        "k_instances": "k",
        "id_loss_weight": "ce_weight",
        "metric_loss_weight": "triplet_weight",
    }
    passthrough = {
        "model", "dataset", "loss", "soft_margin", "epochs", "warmup_epochs",
        "weight_decay", "label_smooth", "center_loss_weight", "ema_decay",
        "random_erasing", "color_jitter", "gaussian_blur", "random_grayscale",
        "eval_interval", "seed", "steps", "warmup_steps",
        "grad_clip", "layer_decay", "vit_lr_profile", "center_lr",
        "head_warmup_epochs", "head_warmup_lr_mult", "backbone_freeze_epochs",
        "classifier_loss", "aux_ce_weight", "aux_ce_drop_epoch",
        "arcface_scale", "arcface_margin", "cosface_scale", "cosface_margin",
        "flip_tta",
    }
    out: dict = {}
    batch_size = None
    for key, val in values.items():
        if key in _RECIPE_IGNORED_KEYS:
            continue
        if key == "imgsz":
            out["crop_hw"] = tuple(val)
        elif key == "optimizer":
            out["optimizer"] = str(val).lower()  # reference spells "AdamW"
        elif key == "batch_size":
            batch_size = int(val)
        elif key in rename:
            out[rename[key]] = val
        elif key in passthrough:
            out[key] = val
        else:
            raise ValueError(f"unknown training-recipe key {key!r}")
    if batch_size is not None and "p" not in out:
        # recipes may give a flat batch size; keep K and derive P
        k = int(out.get("k", 4))
        out.setdefault("k", k)
        out["p"] = max(1, batch_size // k)
    return out


_MODES_PATH = Path(__file__).resolve().parent / "modes.yaml"
_MODES_CACHE: dict | None = None


def _modes() -> dict:
    global _MODES_CACHE
    if _MODES_CACHE is None:
        _MODES_CACHE = _read_yaml(_MODES_PATH)
    return _MODES_CACHE


def get_mode_defaults(mode: str) -> dict:
    """Merged defaults for a workflow mode: shared + runtime + the mode
    section (reference configs/__init__.py get_mode_defaults over
    modes.yaml)."""
    modes = _modes()
    mode = str(mode).lower()
    if mode not in modes and mode not in ("shared", "runtime"):
        raise ValueError(f"unknown mode {mode!r}; available: "
                         f"{sorted(k for k in modes if k not in ('shared', 'runtime'))}")
    out = dict(modes.get("shared") or {})
    out.update(modes.get("runtime") or {})
    out.update(modes.get(mode) or {})
    return out


def build_mode_namespace(mode: str, payload: dict | None = None,
                         explicit_keys=None):
    """Normalized SimpleNamespace for CLI / Python API workflows
    (reference build_mode_namespace, configs/__init__.py:245-280):
    defaults from modes.yaml, then payload values override — all payload
    keys win when explicit_keys is None, otherwise only the listed ones."""
    from types import SimpleNamespace

    values = get_mode_defaults(mode)
    payload = dict(payload or {})
    explicit = set(explicit_keys) if explicit_keys is not None else set(payload)
    for key, val in payload.items():
        if key in explicit or key not in values:
            values[key] = val
    values["mode"] = str(mode).lower()
    return SimpleNamespace(**values)
