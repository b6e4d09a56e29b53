"""Top-level Python API: the Boxmot facade and functional helpers
(counterpart of ``boxmot_tpu/api.py``).

A ``Boxmot`` object carries detector / reid / tracker specs and the device
its work runs on (the card unless the caller asks for the CPU), and exposes
the workflow verbs of the JAX facade: ``track``, ``generate``, ``val``,
``tune``, ``research``, ``train``, ``eval_reid`` and ``export`` (every
target of the JAX package's, ``reid/exporters.py``) run on the port.
``track`` and ``evaluate`` are one-call functional wrappers.

    from boxmot_tpu_torch.api import Boxmot

    bm = Boxmot(tracker="occluboost", reid="osnet_x0_25", device="cuda")
    results = bm.track(source="path/to/seq")      # list of TrackResults
    report = bm.val(data="assets/MOT17-mini/train")

Specs are permissive like the JAX facade's: a tracker spec is a name or a
{"name": ..., "config": {...}} mapping; a reid spec is a model name or a
weights path.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from boxmot_tpu_torch.configs import get_mode_defaults


def _tracker_name(spec) -> str:
    if isinstance(spec, dict):
        return spec.get("name", get_mode_defaults("track")["tracker"])
    return str(spec)


def _tracker_config(spec) -> dict | None:
    if isinstance(spec, dict):
        return spec.get("config")
    return None


def _build_reid(spec, device):
    if spec in (None, "", "none"):
        return None
    from boxmot_tpu_torch.reid import ReID
    from boxmot_tpu_torch.reid.backends import create_reid

    if Path(str(spec)).exists():
        return create_reid(weights=spec, device=device)  # suffix-dispatched runtime
    return ReID(model_name=str(spec), device=device)


class Boxmot:
    """Workflow facade: construct once, call track / generate / val / tune /
    research / train / eval_reid on ``device`` ("cuda", "cuda:N" or "cpu")."""

    def __init__(self, detector=None, reid=None, tracker=None, classes=None, device="cuda"):
        shared = get_mode_defaults("track")
        self.detector = detector if detector is not None else shared["detector"]
        self.reid = reid if reid is not None else shared["reid"]
        self.tracker = tracker if tracker is not None else shared["tracker"]
        self.classes = (
            [int(c) for c in np.atleast_1d(classes)] if classes is not None else None
        )
        self.device = device

    # -- construction helpers ------------------------------------------

    def _make_tracker(self):
        from boxmot_tpu_torch.trackers.zoo import REID_TRACKERS, create_tracker

        name = _tracker_name(self.tracker)
        kwargs = {}
        if name in REID_TRACKERS:
            model = _build_reid(self.reid, self.device)
            if model is not None:
                kwargs["reid_model"] = model
        return create_tracker(name, device=self.device,
                              tracker_config=_tracker_config(self.tracker), **kwargs)

    # -- workflows ------------------------------------------------------

    def track(self, *, source, save_txt=None, show_timing: bool = False):
        """Live tracking over a frame source.

        source: image dir / MOT sequence dir / video / glob — anything
        data.loaders.iter_source accepts.  Detections come from the
        sequence's det.txt when present.  Returns a list of per-frame
        TrackResults (and writes MOT rows when save_txt is set).
        """
        from boxmot_tpu_torch.data.mot import MOTSequence
        from boxmot_tpu_torch.engine.generate import load_frame
        from boxmot_tpu_torch.engine.mot_io import convert_to_mot_format, write_mot_results

        src = Path(source)
        seq_dir = src if (src / "img1").is_dir() or (src / "seqinfo.ini").exists() else None
        trk = self._make_tracker()
        if show_timing:
            from boxmot_tpu_torch.utils.timing import TimedTracker, TimingStats

            trk = TimedTracker(trk, TimingStats())

        results, rows = [], []
        if seq_dir is not None:
            seq = MOTSequence(seq_dir)
            dets_per_frame = seq.dets_per_frame()
            for f, img_path in enumerate(seq.img_paths):
                img = load_frame(img_path)
                dets = (
                    dets_per_frame[f]
                    if f < len(dets_per_frame)
                    else np.zeros((0, 6), np.float32)
                )
                out = trk.update(dets, img)
                results.append(out)
                if len(out):
                    rows.append(convert_to_mot_format(np.asarray(out), f + 1))
        else:
            from boxmot_tpu_torch.data.loaders import iter_source

            for f, (_ident, img) in enumerate(iter_source(str(source))):
                out = trk.update(np.zeros((0, 6), np.float32), img)
                results.append(out)
        if save_txt and rows:
            write_mot_results(save_txt, np.concatenate(rows, axis=0))
        return results

    def generate(self, *, data, cache_root, preprocess: str = "resize"):
        """Detection + embedding cache generation."""
        from boxmot_tpu_torch.engine.generate import run_generate

        reid_model = _build_reid(self.reid, self.device)
        return run_generate(
            Path(data),
            Path(cache_root),
            detector=str(self.detector),
            reid_model=reid_model,
            reid_name=str(self.reid) if reid_model is not None else None,
            preprocess=preprocess,
            device=self.device,
        )

    def val(self, *, data, cache_root=None, postprocessing=None, min_det_conf=None):
        """Benchmark evaluation -> HOTA/MOTA/IDF1 report."""
        from boxmot_tpu_torch.engine.eval import run_eval

        return run_eval(
            Path(data),
            tracker_type=_tracker_name(self.tracker),
            device=self.device,
            tracker_params=_tracker_config(self.tracker),
            cache_root=Path(cache_root) if cache_root else None,
            reid=str(self.reid) if cache_root else None,
            postprocessing=postprocessing,
            min_det_conf=min_det_conf,
        )

    def tune(self, *, data, n_trials: int = 20, work_dir=None, seed: int = 0,
             backend: str = "random"):
        """Hyperparameter tuning on ``device``; ``backend`` is one of random /
        grid / tpe (``engine/tuning/backends.py``)."""
        from boxmot_tpu_torch.engine.tuning.tuner import Tuner

        tuner = Tuner(
            Path(data),
            _tracker_name(self.tracker),
            base_params=_tracker_config(self.tracker),
            work_dir=work_dir,
            seed=seed,
            backend=backend,
            device=self.device,
        )
        return tuner.fit(n_trials=n_trials)

    def research(self, *, data, n_candidates: int = 10, work_dir=None, seed: int = 0):
        """The propose/evaluate research loop over parameters, on ``device``."""
        from boxmot_tpu_torch.engine.research.runner import run_research

        return run_research(
            Path(data),
            tracker_type=_tracker_name(self.tracker),
            n_candidates=n_candidates,
            work_dir=work_dir,
            seed=seed,
            device=self.device,
        )

    def export(self, *, include=("tflite",), out_dir="exports", hw=(256, 128), quantize=None,
               verify: bool = True):
        """Export the configured ReID model, its forward on ``device``.

        The reid spec supplies either a weights path (converted) or a model
        name; returns {target: {"path", "max_dev"?}}.
        """
        from boxmot_tpu_torch.reid.exporters import run_export

        spec = str(self.reid) if self.reid not in (None, "", "none") else None
        weights = spec if spec and Path(spec).exists() else None
        return run_export(
            weights=weights,
            model_name=spec or "osnet_x0_25",
            include=include,
            out_dir=out_dir,
            hw=hw,
            quantize=quantize,
            verify=verify,
            device=self.device,
        )

    def train(self, *, data, dataset: str = "market1501", steps: int = 1000,
              ckpt_dir="reid_ckpts", resume=None, **cfg_kwargs):
        """Train the configured ReID backbone on ``device``."""
        from boxmot_tpu_torch.engine.results import TrainResult
        from boxmot_tpu_torch.reid.core import infer_model_name
        from boxmot_tpu_torch.reid.training.trainer import ReIDTrainer, TrainConfig

        model = str(self.reid) if self.reid not in (None, "", "none") else "osnet_x0_25"
        if Path(model).exists():
            # a weights path names the backbone via its filename, like the
            # other verbs (eval_reid)
            model = infer_model_name(model)
        cfg = TrainConfig(
            model=model, dataset=dataset, data_root=str(data), steps=steps,
            ckpt_dir=str(ckpt_dir), **cfg_kwargs,
        )
        trainer = ReIDTrainer(cfg, device=self.device)
        if resume:
            trainer.load_checkpoint(resume)
        history = trainer.fit()
        return TrainResult(
            steps=trainer.step,
            final_loss=history[-1]["loss"] if history else float("nan"),
            weights_path=str(ckpt_dir),
            history=list(history),
        )

    def eval_reid(self, *, data, dataset: str = "market1501", rerank: bool = False):
        """CMC / mAP ranking evaluation on ``device``.  A weights path names
        its backbone by its file name and is converted as ``ReID`` converts
        it (a torchreid checkpoint by torchreid's key names); a model name
        gives ``ReID``'s seeded weights."""
        from boxmot_tpu_torch.reid import ReID
        from boxmot_tpu_torch.reid.datasets import load_dataset
        from boxmot_tpu_torch.reid.training.evaluator import evaluate_reid

        spec = str(self.reid) if self.reid not in (None, "", "none") else "osnet_x0_25"
        if Path(spec).exists():
            reid = ReID(weights=spec, device=self.device)
        else:
            reid = ReID(model_name=spec, device=self.device)
        return evaluate_reid(reid.model, load_dataset(dataset, data), rerank=rerank)


def track(source, tracker="bytetrack", reid=None, device="cuda", **kwargs):
    """Functional one-call tracking."""
    return Boxmot(reid=reid, tracker=tracker, device=device).track(source=source, **kwargs)


def evaluate(data, tracker="bytetrack", reid=None, device="cuda", **kwargs):
    """Functional one-call evaluation."""
    return Boxmot(reid=reid, tracker=tracker, device=device).val(data=data, **kwargs)
