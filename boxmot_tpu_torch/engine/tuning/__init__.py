"""Hyperparameter tuning over cached replays (counterpart of
``boxmot_tpu/engine/tuning``)."""

from boxmot_tpu_torch.engine.tuning.tuner import Tuner, run_tune  # noqa: F401
