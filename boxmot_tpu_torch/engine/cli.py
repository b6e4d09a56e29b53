"""Command-line interface (counterpart of ``boxmot_tpu/engine/cli.py``).

The click group of the JAX package's CLI, on the port: ``eval``,
``generate``, ``track``, ``tune-kf``, ``train`` and ``eval-reid`` run, on the
card unless ``--device cpu`` is given; so do ``tune``, ``research`` (over
parameters, or with ``--edit-source`` over tracker source, each candidate in
a child process on the same device), ``build`` (the native C++ cores) and
``export`` (the JAX package's targets, verified against the forward on the
device).  A ``name:cpp`` tracker runs on the native cores, on the host.
Called in-process (``cli.main(args, standalone_mode=False)``),
``eval`` returns its metrics, ``track`` its MOT rows, ``tune-kf`` its
estimate, ``tune`` its best trial and ``research`` its best candidate (with
``--edit-source``, its summary).

Usage:
    python -m boxmot_tpu_torch.engine.cli eval --data assets/MOT17-mini/train
    python -m boxmot_tpu_torch.engine.cli eval --benchmark mmot-mini --tracker ocsort
    python -m boxmot_tpu_torch.engine.cli track --source <seq_dir> --tracker ocsort
    python -m boxmot_tpu_torch.engine.cli eval --data assets/MOT17-mini/train --device cpu
"""

from __future__ import annotations

import json
from pathlib import Path

import click
import numpy as np


def _parse_params(params: tuple[str, ...]) -> dict:
    out = {}
    for p in params:
        if "=" not in p:
            raise click.BadParameter(f"expected key=value, got {p!r}")
        k, v = p.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def _device_option(fn):
    return click.option("--device", default="cuda", show_default=True,
                        help="cuda, cuda:N or cpu")(fn)


@click.group()
def cli():
    """boxmot_tpu_torch — multi-object tracking on PyTorch + CUDA."""


@cli.command()
@click.option("--data", type=click.Path(exists=True), default=None, help="MOT split dir")
@click.option("--benchmark", default=None, help="benchmark config id (e.g. mot17-mini)")
@click.option("--split", default=None)
@click.option("--tracker", default="bytetrack", show_default=True)
@click.option("--output-dir", type=click.Path(), default=None, help="write MOT txt here")
@click.option("--cache-root", type=click.Path(), default=None, help="replay from caches")
@click.option("--detector", default="public", show_default=True)
@click.option("--reid", default=None, help="reid cache id for appearance replay")
@click.option("--min-det-conf", type=float, default=None)
@click.option("--postprocessing", default=None, help="chain e.g. gsi or gbrc,gta")
@click.option("--param", "-p", multiple=True, help="tracker param key=value (json)")
@click.option("--plots-dir", type=click.Path(), default=None,
              help="write metric radar/bar charts here")
@click.option("--rich/--no-rich", "use_rich", default=None,
              help="rich table output (default: auto on TTY)")
@click.option("--kf-noise", type=click.Path(exists=True), default=None,
              help="tune-kf JSON; injects calibrated KF std weights")
@click.option("--tuned", default=None,
              help="benchmark-tuned config id, e.g. occluboost_mot17_ablation")
@click.option("--n-workers", type=int, default=1, show_default=True,
              help="sequence thread pool size (cpp backend only)")
@_device_option
def eval(data, benchmark, split, tracker, output_dir, cache_root, detector, reid, min_det_conf,
         postprocessing, param, plots_dir, use_rich, kf_noise, tuned, n_workers, device):
    """Replay cached detections and report HOTA / MOTA / IDF1."""
    from boxmot_tpu_torch.engine.eval import run_eval

    params = _parse_params(param)
    if tuned:
        from boxmot_tpu_torch.configs import load_tuned_config

        params = {**load_tuned_config(tuned), **params}

    if benchmark:
        from boxmot_tpu_torch.configs.benchmark import load_benchmark, resolve_split_dir

        bcfg = load_benchmark(benchmark)
        data = data or str(resolve_split_dir(bcfg, split))
        if detector == "public":
            detector = bcfg.get("detector", {}).get("id", "public")
        reid = reid or (bcfg.get("reid", {}) or {}).get("id")
        if bcfg["dataset"].get("box_type") == "obb":
            from boxmot_tpu_torch.engine.eval_obb import run_eval_obb

            # the mmot split dir holds mot/ + npy/, one level up from npy
            obb_root = Path(data).parent if Path(data).name == "npy" else Path(data)
            res = run_eval_obb(
                obb_root, tracker, device=device, tracker_params=params,
                output_dir=output_dir, verbose=True,
            )
            c = res["combined"]
            for cls_id, m in res.get("per_class", {}).items():
                click.echo(
                    f"  class {cls_id}: HOTA {100 * m['HOTA']:.2f}  "
                    f"MOTA {100 * m['MOTA']:.2f}  IDF1 {100 * m['IDF1']:.2f}"
                )
            click.echo(
                f"CLASS-AVERAGED: HOTA {100 * c['HOTA']:.2f}  "
                f"MOTA {100 * c['MOTA']:.2f}  IDF1 {100 * c['IDF1']:.2f}"
            )
            return res
    if not data:
        raise click.ClickException("provide --data or --benchmark")

    from boxmot_tpu_torch.utils import reporters as rep

    reporter = rep.EvalReporter(
        benchmark=benchmark, data=data, tracker=tracker, tuned=tuned,
        postprocessing=postprocessing, detector=detector, reid=reid,
        n_workers=n_workers,
    )
    with reporter.start(use_rich) as wp:
        wp.start_step(rep.SETUP)
        wp.finish_step(rep.SETUP)
        wp.start_step(rep.TRACK, detail=str(data))
        res = run_eval(
            data,
            tracker,
            device=device,
            tracker_params=params,
            output_dir=output_dir,
            cache_root=cache_root,
            detector=detector,
            reid=reid,
            min_det_conf=min_det_conf,
            postprocessing=postprocessing,
            verbose=True,
            n_workers=n_workers,
            kf_noise=kf_noise,
            progress=lambda name, done, total: wp.advance("sequences", done, total),
        )
        wp.finish_step(rep.TRACK)
        if postprocessing:
            # chained inside run_eval per sequence; surface as done
            wp.start_step(rep.POSTPROCESS, detail=postprocessing)
            wp.finish_step(rep.POSTPROCESS)
        wp.start_step(rep.EVALUATE)
        wp.finish_step(rep.EVALUATE)
    c = res["combined"]
    from boxmot_tpu_torch.utils.rich_ui import metrics_table, want_rich

    if want_rich(use_rich):
        from rich.console import Console

        console = Console()
        metrics_table(res["per_seq"], title=f"{tracker} per-sequence", console=console)
        metrics_table({"COMBINED": c}, title="combined", console=console)
    else:
        click.echo("\nper-sequence:")
        for name, m in res["per_seq"].items():
            click.echo(
                f"  {name}: HOTA {100 * m['HOTA']:.2f}  MOTA {100 * m['MOTA']:.2f}  "
                f"IDF1 {100 * m['IDF1']:.2f}"
            )
    click.echo(
        f"COMBINED: HOTA {100 * c['HOTA']:.2f}  MOTA {100 * c['MOTA']:.2f}  "
        f"IDF1 {100 * c['IDF1']:.2f}  (TP {c['CLR_TP']}  FP {c['CLR_FP']}  "
        f"FN {c['CLR_FN']}  IDSW {c['IDSW']})"
    )
    if plots_dir:
        from boxmot_tpu_torch.engine.plots import plot_eval_summary

        paths = plot_eval_summary({tracker: c, **res["per_seq"]}, plots_dir)
        click.echo("plots: " + ", ".join(str(p) for p in paths))
    return res


@cli.command()
@click.option("--data", required=True, type=click.Path(exists=True))
@click.option("--cache-root", required=True, type=click.Path())
@click.option("--detector", default="public", show_default=True)
@click.option("--reid-weights", default=None, help="ReID weights path or model name")
@click.option("--preprocess", default="resize", show_default=True)
@click.option("--frame-group", type=int, default=1, show_default=True,
              help="batch this many frames' ReID crops into one backbone call "
              "(sparse-scene throughput)")
@click.option("--batch-size", type=int, default=0, show_default=True,
              help="ReID crop batch size (0 = whole frame at once)")
@click.option("--auto-batch/--no-auto-batch", default=True, show_default=True,
              help="Halve the batch and retry on device OOM")
@_device_option
def generate(data, cache_root, detector, reid_weights, preprocess, frame_group, batch_size,
             auto_batch, device):
    """Generate detection / mask / embedding caches for a MOT split."""
    from boxmot_tpu_torch.engine.generate import run_generate

    detector_model = None
    if detector != "public" and Path(detector).exists():
        from boxmot_tpu_torch.detectors.registry import create_detector

        detector_model = create_detector(detector, device=device)
        detector = Path(detector).stem
    reid_model = None
    reid_name = None
    if reid_weights:
        from boxmot_tpu_torch.reid import ReID

        if Path(reid_weights).exists():
            from boxmot_tpu_torch.reid.backends import create_reid

            reid_model = create_reid(weights=reid_weights, preprocess_name=preprocess,
                                     device=device)
        else:
            reid_model = ReID(model_name=reid_weights, preprocess_name=preprocess, device=device)
        reid_name = reid_model.model_name
    from boxmot_tpu_torch.utils import reporters as rep

    reporter = rep.GenerateReporter(
        data=data, cache_root=cache_root, detector=detector,
        reid_weights=reid_weights, preprocess=preprocess,
        batch_size=batch_size,
    )
    with reporter.start() as wp:
        wp.start_step(rep.SETUP)
        wp.finish_step(rep.SETUP)
        wp.start_step(rep.GENERATE, detail=str(data))
        stats = run_generate(
            data,
            cache_root,
            detector=detector,
            detector_model=detector_model,
            reid_model=reid_model,
            reid_name=reid_name,
            preprocess=preprocess,
            verbose=True,
            progress=wp.advance,
            batch_size=batch_size,
            auto_batch=auto_batch,
            frame_group=frame_group,
            device=device,
        )
        wp.finish_step(rep.GENERATE)
    total = sum(s["dets"] for s in stats.values())
    click.echo(f"cached {total} detections across {len(stats)} sequences")


@cli.command()
@click.option("--source", required=True, type=click.Path(exists=True),
              help="MOT sequence dir (with img1/) or image directory")
@click.option("--tracker", default="bytetrack", show_default=True)
@click.option("--reid-weights", default=None)
@click.option("--save-txt", type=click.Path(), default=None)
@click.option("--save-video", type=click.Path(), default=None,
              help="render plot_results frames into an mp4")
@click.option("--show-trajectories/--no-show-trajectories", default=True)
@click.option("--show-timing", is_flag=True, help="print per-stage timing summary")
@click.option("--detector", "detector_weights", default=None,
              help="Detector weights: run live inference instead of det.txt")
@click.option("--batch-size", type=int, default=0, show_default=True,
              help="ReID crop batch size for the live pipeline")
@click.option("--project", type=click.Path(), default=None,
              help="run output root; MOT txt defaults into an incremented "
                   "<project>/<name> dir (reference runs/track semantics)")
@click.option("--name", "run_name", default="exp", show_default=True,
              help="run dir name under --project (auto-incremented)")
@click.option("--exist-ok", is_flag=True,
              help="reuse <project>/<name> instead of incrementing")
@click.option("--param", "-p", multiple=True)
@_device_option
def track(source, tracker, reid_weights, save_txt, save_video, show_trajectories,
          show_timing, detector_weights, batch_size, project, run_name, exist_ok,
          param, device):
    """Run live tracking over a frame source."""
    from boxmot_tpu_torch.data.loaders import VIDEO_EXTS
    from boxmot_tpu_torch.engine.generate import load_frame
    from boxmot_tpu_torch.engine.mot_io import convert_to_mot_format, write_mot_results
    from boxmot_tpu_torch.trackers.zoo import REID_TRACKERS, create_tracker

    source = Path(source)
    if project is not None:
        from boxmot_tpu_torch.utils.misc import increment_path

        run_dir = increment_path(Path(project) / run_name, exist_ok=exist_ok, mkdir=True)
        if save_txt is None:
            save_txt = str(run_dir / f"{source.stem}.txt")
        click.echo(f"run dir: {run_dir}")
    is_video = source.is_file() and source.suffix.lower() in VIDEO_EXTS
    if is_video:
        frames = None  # streamed via iter_source; count unknown up front
    else:
        img_dir = source / "img1" if (source / "img1").is_dir() else source
        frames = sorted(
            p for p in img_dir.iterdir() if p.suffix.lower() in (".jpg", ".png", ".jpeg")
        )
        if not frames:
            raise click.ClickException(f"no frames under {img_dir}")

    from boxmot_tpu_torch.utils import reporters as rep

    reporter = rep.TrackReporter(
        tracker=tracker, reid_weights=reid_weights, detector=detector_weights,
        source=str(source), save_txt=save_txt, save_video=save_video,
    )
    with reporter.start() as wp:
        wp.start_step(rep.SETUP)
        kwargs = _parse_params(param)
        if reid_weights and tracker in REID_TRACKERS:
            from boxmot_tpu_torch.reid import ReID

            if Path(reid_weights).exists():
                kwargs["reid_model"] = ReID(weights=reid_weights, device=device)
            else:
                kwargs["reid_model"] = ReID(model_name=reid_weights, device=device)
        trk = create_tracker(tracker, device=device, **kwargs)
        stats = None
        if show_timing:
            from boxmot_tpu_torch.utils.timing import TimedTracker, TimingStats

            stats = TimingStats()
            trk = TimedTracker(trk, stats)

        # Detections: live detector inference when --detector is given
        # (DetectorReIDPipeline, the reference inference.py workflow), else
        # the sequence's public det.txt.
        pipeline = None
        dets_per_frame = None
        if detector_weights:
            from boxmot_tpu_torch.detectors.registry import create_detector
            from boxmot_tpu_torch.engine.inference import DetectorReIDPipeline

            pipeline = DetectorReIDPipeline(
                create_detector(detector_weights, device=device),
                reid=kwargs.get("reid_model"),
                batch_size=batch_size,
                timing=stats if stats is not None else None,
            )
            pipeline.warmup()
        else:
            det_file = source / "det" / "det.txt"
            if not det_file.exists():
                raise click.ClickException(
                    "no det/det.txt next to the source; pass --detector WEIGHTS "
                    "to run live inference"
                )
            from boxmot_tpu_torch.data.mot import MOTSequence

            seq = MOTSequence(source)
            dets_per_frame = seq.dets_per_frame()

        wp.finish_step(rep.SETUP)
        wp.start_step(rep.TRACK)
        writer = None
        rows = []
        if is_video:
            from boxmot_tpu_torch.data.loaders import iter_source

            frame_iter = (img for _ident, img in iter_source(source))
            n_total = None
        else:
            frame_iter = (load_frame(p) for p in frames)
            n_total = len(frames)
        f = -1
        for f, img in enumerate(frame_iter):
            if pipeline is not None:
                dets, embs, result = pipeline(img)
                upd_kwargs = {}
                if embs is not None:
                    upd_kwargs["embs"] = embs
                if result is not None and getattr(result, "masks", None) is not None:
                    upd_kwargs["masks"] = result.masks
                out = trk.update(dets, img, **upd_kwargs)
            else:
                dets = dets_per_frame[f] if f < len(dets_per_frame) else np.zeros((0, 6), np.float32)
                out = trk.update(dets, img)
            if len(out):
                rows.append(convert_to_mot_format(np.asarray(out), f + 1))
            if save_video:
                import cv2

                canvas = trk.plot_results(
                    np.ascontiguousarray(img), show_trajectories=show_trajectories
                )
                if writer is None:
                    writer = cv2.VideoWriter(
                        str(save_video),
                        cv2.VideoWriter_fourcc(*"mp4v"),
                        30,
                        (canvas.shape[1], canvas.shape[0]),
                    )
                    if not writer.isOpened():
                        raise click.ClickException(
                            f"cannot open video writer at {save_video}"
                        )
                writer.write(canvas)
            wp.advance("frames", f + 1, n_total if n_total else f + 1)
        if f < 0:
            raise click.ClickException(f"no frames decoded from {source}")
        wp.finish_step(rep.TRACK, detail=f"{f + 1} frames")
    if writer is not None:
        writer.release()
        click.echo(f"wrote video to {save_video}")
    if hasattr(trk, "flush_gta"):
        gta_rows = trk.flush_gta()
        if len(gta_rows):
            rows.append(gta_rows)
    all_rows = np.concatenate(rows, axis=0) if rows else np.empty((0, 9))
    if save_txt:
        write_mot_results(save_txt, all_rows)
        click.echo(f"wrote {len(all_rows)} rows to {save_txt}")
    if stats is not None:
        click.echo(stats.summary())
    return all_rows


@cli.command("tune-kf")
@click.option("--data", required=True, type=click.Path(exists=True),
              help="MOT train root (sequence dirs with gt/gt.txt)")
@click.option("--tracker", default=None, help="tracker name (resolves kf type)")
@click.option("--kf-type", default=None, type=click.Choice(["xywh", "xyah", "xysr", "xyhr"]))
@click.option("--dets", type=click.Path(exists=True), default=None,
              help="det cache dir (.npy per sequence) for det-vs-GT R estimation")
@click.option("--iou-threshold", type=float, default=0.5, show_default=True)
@click.option("--per-class", is_flag=True)
@click.option("--out", type=click.Path(), default=None, help="write estimate JSON here")
def tune_kf(data, tracker, kf_type, dets, iou_threshold, per_class, out):
    """Estimate Kalman Q/R noise and std weights from ground truth."""
    from boxmot_tpu_torch.motion.calibration import (
        estimate_kf_noise,
        save_kf_noise,
        tracker_kf_type,
    )

    if kf_type is None:
        if tracker is None:
            raise click.ClickException("provide --kf-type or --tracker")
        kf_type = tracker_kf_type(tracker)
        if kf_type is None:
            raise click.ClickException(f"no KF parameterization known for {tracker!r}")
    result = estimate_kf_noise(
        Path(data),
        kf_type=kf_type,
        dets_root=Path(dets) if dets else None,
        iou_threshold=iou_threshold,
        per_class=per_class,
        verbose=True,
    )
    click.echo(
        f"std_weight_position={result['std_weight_position']:.6f} "
        f"std_weight_velocity={result['std_weight_velocity']:.6f} "
        f"(source: {result['source']})"
    )
    if out:
        save_kf_noise(result, out)
        click.echo(f"wrote {out}")
    return result


@cli.command()
@click.option("--data", required=True, type=click.Path(exists=True))
@click.option("--tracker", default="bytetrack", show_default=True)
@click.option("--n-trials", type=int, default=20, show_default=True)
@click.option("--work-dir", type=click.Path(), default="tune_results")
@click.option("--seed", type=int, default=0)
@click.option("--backend", default="random", show_default=True,
              type=click.Choice(["random", "grid", "tpe"]),
              help="search strategy (tpe = optuna-style adaptive sampler)")
@click.option("--n-workers", type=int, default=1, show_default=True,
              help="concurrent trials per batch (threads)")
@_device_option
def tune(data, tracker, n_trials, work_dir, seed, backend, n_workers, device):
    """Tune tracker hyperparameters over cached replays."""
    from boxmot_tpu_torch.engine.tuning import run_tune
    from boxmot_tpu_torch.utils import reporters as rep

    reporter = rep.TuneReporter(
        data=data, tracker=tracker, backend=backend, n_trials=n_trials,
        seed=seed, work_dir=work_dir,
    )
    feed = rep.TrialFeed()
    with reporter.start() as wp:
        def _on_trial(trial):
            feed.record(trial)
            if wp._use_rich:
                wp.extra = feed.renderable()
            else:
                click.echo(feed.log_line(trial))
            wp.advance("trials", len(feed.rows), n_trials)

        wp.start_step(rep.SETUP)
        wp.finish_step(rep.SETUP)
        wp.start_step(rep.OPTIMIZE, detail=f"{backend} x{n_trials}")
        best = run_tune(data, tracker, n_trials=n_trials, work_dir=work_dir,
                        seed=seed, backend=backend, trial_callback=_on_trial,
                        n_workers=n_workers, device=device)
        wp.finish_step(rep.OPTIMIZE)
    if rep.want_rich():
        from rich.console import Console

        rep.artifacts_table(
            {
                "Trials log": str(Path(work_dir) / "trials.json"),
                "Best config": str(Path(work_dir) / "best.yaml"),
            },
            console=Console(),
        )
    click.echo(f"best score {best['score']:.4f} with params:")
    for k, v in best["params"].items():
        click.echo(f"  {k}: {v}")
    return best


@cli.command()
@click.option("--data", required=True, type=click.Path(exists=True), help="reid dataset root")
@click.option("--recipe", default=None,
              help="training recipe name from configs/training/ (reference "
                   "`train --recipe`); explicit flags override recipe values")
@click.option("--model", default="osnet_x0_25", show_default=True)
@click.option("--dataset", default="market1501", show_default=True)
@click.option("--steps", type=int, default=1000, show_default=True)
@click.option("--lr", type=float, default=3.5e-4)
@click.option("--p", type=int, default=16, help="identities per batch")
@click.option("--k", type=int, default=4, help="instances per identity")
@click.option("--loss", default="triplet", show_default=True,
              type=click.Choice(["softmax", "triplet", "circle", "ms"],
                                case_sensitive=False),
              help="metric loss (softmax = identity loss only)")
@click.option("--classifier-loss", default="ce", show_default=True,
              type=click.Choice(["ce", "arcface", "cosface"],
                                case_sensitive=False),
              help="identity classifier (reference --classifier-loss)")
@click.option("--ckpt-dir", type=click.Path(), default="reid_ckpts")
@click.option("--resume", type=click.Path(exists=True), default=None)
@_device_option
@click.pass_context
def train(ctx, data, recipe, model, dataset, steps, lr, p, k, loss,
          classifier_loss, ckpt_dir, resume, device):
    """Train a ReID backbone (identity loss + metric loss)."""
    from boxmot_tpu_torch.reid.training.trainer import ReIDTrainer, TrainConfig

    kwargs = dict(data_root=data, ckpt_dir=ckpt_dir)
    if recipe:
        from boxmot_tpu_torch.configs import (
            load_training_recipe,
            train_config_kwargs_from_recipe,
        )

        kwargs.update(train_config_kwargs_from_recipe(load_training_recipe(recipe)))
        # a recipe supplies its own schedule; drop the CLI steps default
        kwargs.pop("steps", None)
    cli_params = [
        ("model", model), ("dataset", dataset), ("steps", steps),
        ("base_lr", lr), ("p", p), ("k", k), ("loss", loss.lower()),
        ("classifier_loss", classifier_loss.lower()),
    ]
    flag_of = {"base_lr": "lr"}
    explicit = {
        name: val
        for name, val in cli_params
        if ctx.get_parameter_source(flag_of.get(name, name)).name == "COMMANDLINE"
    }
    kwargs.update(explicit)
    if "steps" in explicit:
        kwargs["epochs"] = 0  # explicit --steps beats a recipe's epoch count
    if not recipe:
        for name, val in cli_params:
            kwargs.setdefault(name, val)
    cfg = TrainConfig(**kwargs)
    trainer = ReIDTrainer(cfg, device=device)
    if resume:
        trainer.load_checkpoint(resume)
    trainer.fit(verbose=True)
    res = trainer.evaluate()
    click.echo(
        f"rank-1 {100 * res['rank1']:.2f}  rank-5 {100 * res['rank5']:.2f}  "
        f"mAP {100 * res['mAP']:.2f}"
    )
    click.echo(f"checkpoints in {ckpt_dir}")


@cli.command()
@click.option("--data", required=True, type=click.Path(exists=True))
@click.option("--tracker", default="bytetrack", show_default=True)
@click.option("--n-candidates", type=int, default=10, show_default=True)
@click.option("--work-dir", type=click.Path(), default="research_results")
@click.option("--seed", type=int, default=0)
@click.option(
    "--edit-source", is_flag=True,
    help="Research over tracker SOURCE candidates (sandboxed workspace) "
    "instead of config parameters.",
)
@click.option(
    "--editable-file", "editable_files", multiple=True,
    help="Repo-relative file(s) the source proposer may edit "
    "(default: the port's step module of the tracker).",
)
@click.option(
    "--proposer", default="ast", show_default=True,
    type=click.Choice(["ast", "llm"]),
    help="Source-candidate proposer: offline AST literal mutation, or an "
    "LLM endpoint (BOXMOT_LLM_ENDPOINT / _MODEL / _API_KEY env).",
)
@_device_option
def research(data, tracker, n_candidates, work_dir, seed, edit_source,
             editable_files, proposer, device):
    """Iterative candidate-proposal research loop over a benchmark."""
    from boxmot_tpu_torch.utils import reporters as rep

    reporter = rep.ResearchReporter(
        data=data, tracker=tracker, n_candidates=n_candidates,
        edit_source=edit_source,
    )

    def _wire_phases(wp, runner):
        def on_phase(stage, done, total):
            if stage == "baseline":
                if wp.pipeline[rep.PREPARE].state == "running":
                    wp.finish_step(rep.PREPARE)
                wp.start_step(rep.BASELINE)
            elif stage == "candidates":
                if wp.pipeline[rep.PREPARE].state == "running":
                    wp.finish_step(rep.PREPARE)
                if wp.pipeline[rep.BASELINE].state == "running":
                    wp.finish_step(rep.BASELINE)
                elif wp.pipeline[rep.BASELINE].state == "pending":
                    wp.finish_step(rep.BASELINE, "skipped", "resumed")
                if wp.pipeline[rep.PROPOSE].state == "pending":
                    wp.start_step(rep.PROPOSE)
                wp.advance("candidates", done, total)

        runner.phase_callback = on_phase

    if edit_source:
        from boxmot_tpu_torch.engine.research import SourceResearchRunner
        from boxmot_tpu_torch.engine.research.candidates import create_proposer

        with reporter.start() as wp:
            wp.start_step(rep.PREPARE)
            runner = SourceResearchRunner(
                data, tracker, editable_files=list(editable_files) or None,
                work_dir=work_dir, seed=seed,
                proposal_fn=create_proposer(proposer), device=device,
            )
            _wire_phases(wp, runner)
            try:
                summary = runner.run(n_candidates=n_candidates)
            finally:
                runner.workspace.cleanup()
            if wp.pipeline[rep.PROPOSE].state == "running":
                wp.finish_step(rep.PROPOSE)
            wp.start_step(rep.BEST)
            wp.finish_step(
                rep.BEST,
                detail="none beat baseline" if summary["best"] is None
                else summary["best"]["tag"],
            )
        best = summary["best"]
        click.echo(
            f"evaluated {summary['n_evaluated']} source candidates "
            f"({summary['n_failed']} failed)"
        )
        if best is None:
            click.echo("no candidate beat the baseline")
        else:
            click.echo(
                f"best {best['tag']}  score {best['score']:+.4f}  "
                f"HOTA {100 * best['metrics']['HOTA']:.2f}"
            )
            for ch in best["changes"]:
                click.echo(f"  {ch['path']}: +{ch['added']} -{ch['removed']}")
        return summary

    from boxmot_tpu_torch.engine.research import ResearchRunner

    with reporter.start() as wp:
        wp.start_step(rep.PREPARE)
        runner = ResearchRunner(data, tracker, work_dir=work_dir, seed=seed, device=device)
        _wire_phases(wp, runner)
        best = runner.run(n_candidates=n_candidates)
        if wp.pipeline[rep.PROPOSE].state == "running":
            wp.finish_step(rep.PROPOSE)
        wp.start_step(rep.BEST)
        wp.finish_step(rep.BEST, detail=f"score {best['score']:+.4f}")
    click.echo(f"best score {best['score']:+.4f}  HOTA {100 * best['metrics']['HOTA']:.2f}")
    for k, v in best["params"].items():
        click.echo(f"  {k}: {v}")
    return best


@cli.command("eval-reid")
@click.option("--data", required=True, type=click.Path(exists=True))
@click.option("--model", default="osnet_x0_25", show_default=True)
@click.option("--dataset", default="market1501", show_default=True)
@click.option("--weights", type=click.Path(exists=True), default=None,
              help="torchreid .pt checkpoint (converted on load)")
@click.option("--rerank", is_flag=True, default=False)
@click.option("--flip-tta/--no-flip-tta", default=False, show_default=True,
              help="average original + horizontally-flipped features "
                   "(reference --flip-tta)")
@_device_option
def eval_reid(data, model, dataset, weights, rerank, flip_tta, device):
    """CMC / mAP ranking evaluation on a ReID dataset."""
    from boxmot_tpu_torch.reid import ReID
    from boxmot_tpu_torch.reid.datasets import load_dataset
    from boxmot_tpu_torch.reid.training.evaluator import evaluate_reid

    ds = load_dataset(dataset, data)
    net = ReID(weights=weights, model_name=model, device=device).model
    res = evaluate_reid(net, ds, rerank=rerank, flip_tta=flip_tta)
    click.echo(
        f"rank-1 {100 * res['rank1']:.2f}  rank-5 {100 * res['rank5']:.2f}  "
        f"mAP {100 * res['mAP']:.2f}"
    )
    return res


@cli.command()
@click.option("--force", is_flag=True, help="rebuild even if the library exists")
@_device_option
def build(force, device):
    """Build the native C++ tracker cores and report the environment."""
    from boxmot_tpu_torch import native as native_mod
    from boxmot_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if force:
        for name in ("libboxmot_native.so", "CMakeCache.txt"):
            (native_mod._BUILD_DIR / name).unlink(missing_ok=True)
        native_mod._LIB = None  # so that get_library() rebuilds
    try:
        native_mod.get_library()
    except (RuntimeError, OSError) as exc:
        raise click.ClickException(f"native library unavailable: {exc}") from None
    click.echo("native library ready")

    import torch

    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    click.echo(f"torch device: {dev.type} x{count}")
    for extra in ("rich", "matplotlib"):
        try:
            __import__(extra)
            click.echo(f"{extra}: available")
        except ImportError:
            click.echo(f"{extra}: missing (degraded output only)")


@cli.command("export")
@click.option("--weights", default=None, help="torchreid checkpoint to convert (optional)")
@click.option("--model", default="osnet_x0_25", show_default=True)
@click.option("--include", default="tflite", show_default=True,
              help="comma list: checkpoint,torch,saved_model,tflite,onnx")
@click.option("--out-dir", type=click.Path(), default="exports", show_default=True)
@click.option("--imgsz", default="256,128", show_default=True, help="crop H,W")
@click.option("--int8", is_flag=True, help="TFLite dynamic-range quantization")
@click.option("--verify/--no-verify", "do_verify", default=True,
              help="compare exported outputs against the forward on the device")
@_device_option
def export(weights, model, include, out_dir, imgsz, int8, do_verify, device):
    """Export a ReID backbone (reference `boxmot export`, engine/cli.py:430+).
    Called in-process, returns the ``ExportResult`` {target: {"path",
    "max_dev"?, "seconds"}}."""
    import time

    from boxmot_tpu_torch.engine.results import ExportResult
    from boxmot_tpu_torch.reid import ReID
    from boxmot_tpu_torch.reid import exporters as ex
    from boxmot_tpu_torch.utils import reporters as rep

    reporter = rep.ExportReporter(
        model=model, weights=weights, imgsz=imgsz, include=include,
        int8=int8, do_verify=do_verify, out_dir=out_dir,
    )
    artifacts: dict[str, str] = {}
    verify_notes: list[str] = []
    with reporter.start() as wp:
        wp.start_step(rep.SETUP)
        hw = tuple(int(v) for v in imgsz.split(","))
        reid = ReID(weights=weights, model_name=None if weights else model, crop_hw=hw,
                    device=device)
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        targets = [t.strip() for t in include.split(",") if t.strip()]
        for target in targets:
            if target not in ex.TARGETS:
                raise click.ClickException(f"unknown export target {target!r}; "
                                           "choose from checkpoint,torch,saved_model,tflite,onnx")
        wp.finish_step(rep.SETUP)
        wp.start_step(rep.EXPORT)
        graphs, results = {}, ExportResult()
        for i, target in enumerate(targets):
            t0 = time.perf_counter()
            info = ex.export_target(reid, target, out, quantize="dynamic" if int8 else None,
                                    verify=do_verify, graphs=graphs)
            results[target] = {**info, "seconds": time.perf_counter() - t0}
            if "max_dev" in info:
                verify_notes.append(f"{target} max |diff| vs {reid.device.type}: "
                                    f"{info['max_dev']:.2e}")
            artifacts[target] = str(info["path"])
            wp.advance("targets", i + 1, len(targets))
        wp.finish_step(rep.EXPORT, detail=f"{len(targets)} formats")
    for note in verify_notes:
        click.echo(note)
    if rep.want_rich():
        from rich.console import Console

        rep.artifacts_table(artifacts, console=Console())
    else:
        for target, path in artifacts.items():
            click.echo(f"exported {target} -> {path}")
    return results


if __name__ == "__main__":
    cli()
