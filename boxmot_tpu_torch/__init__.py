"""boxmot_tpu_torch: the PyTorch + CUDA port of boxmot_tpu.

It runs the ten trackers of the JAX zoo: replay, eval and live tracking
with ByteTrack, SFSORT, OC-SORT, BoT-SORT and OccluBoost for axis-aligned
and oriented boxes, and DeepOCSORT, BoostTrack, StrongSORT and HybridSORT
for axis-aligned ones, with appearance embeddings and camera-motion
compensation (ECC on the device), on one NVIDIA H100, or on the CPU
through each kernel's plain PyTorch twin; and sam2mot, a host tracker in
both packages.  A live appearance tracker can compute its embeddings from
the frame with the ReID facade (``reid``: crops on the card, OSNet from
torchreid checkpoints, ResNet, MobileNetV2, LMBN, MLFN, CSPReID and HACNN).
Images become tracks through the YOLOX detector or the vendored
``yololite*`` predictor (``detectors``: ``YoloXDetector``,
``UltralyticsDetector``, ``Detector``, yolox checkpoints, NMS on the card),
the staged ``engine.inference.DetectorReIDPipeline`` or the
fused ``engine.fused.FusedLiveTracker`` (detect, crop, ReID and track on
the card with no host sync inside a frame); ``run_generate`` writes the
detection, mask, embedding and warp caches that ``run_eval`` reads.  The hot ops of the tracker
steps and the detector's NMS are kernels written by hand for Hopper
(``csrc/``), built with nvcc on first use.  The package imports torch, numpy, scipy and cv2 (the OBB metric),
and nothing of JAX or of the JAX package: it keeps its own copies of the
host modules it needs (``data``, ``engine.metrics``, ``engine.mot_io``,
``engine.results``, ``trackers.per_class_ids``, ``trackers.track_results``).

Entry points, on the card unless ``device="cpu"`` is given::

    boxmot_tpu_torch.run_eval(root, "bytetrack")
    boxmot_tpu_torch.run_eval_obb(mmot_root, "ocsort")
    tracker = boxmot_tpu_torch.create_tracker("ocsort")
    tracker.update(dets, img)  # (N, 6) xyxy or (N, 7) xywha detections
    from boxmot_tpu_torch.detectors import create_detector
    from boxmot_tpu_torch.engine.fused import FusedLiveTracker
    from boxmot_tpu_torch.reid import ReID
    det = create_detector("yolox_x_MOT17_ablation.pt")  # a yolox checkpoint
    live = FusedLiveTracker(det, ReID("osnet_x0_25"), "occluboost")
    live.update(frame_bgr)  # (M, 8) rows
    boxmot_tpu_torch.run_generate(root, cache_root, detector="yololite-seg",
                                  detector_model=create_detector("yololite-seg.pt"),
                                  reid_model=ReID("osnet_x0_25"), cmc_method="ecc")
    from boxmot_tpu_torch.api import Boxmot
    Boxmot(tracker="ocsort").track(source=seq_dir)  # the facade of the JAX package

    from boxmot_tpu_torch.engine.tuning import run_tune
    run_tune(root, "bytetrack", n_trials=20, n_workers=4)  # trials in threads

and from the shell, ``python -m boxmot_tpu_torch.engine.cli eval --data
root`` (also ``generate``, ``track``, ``tune-kf``, ``tune``, ``research``,
``train``, ``eval-reid``, ``build``; ``--device cpu`` for the CPU).  A
``name:cpp`` tracker runs the repo's native C++ core on the host
(``native``).
"""

from boxmot_tpu_torch.engine.eval import run_eval
from boxmot_tpu_torch.engine.eval_obb import run_eval_obb
from boxmot_tpu_torch.engine.generate import run_generate
from boxmot_tpu_torch.trackers.zoo import create_tracker

__all__ = ["create_tracker", "run_eval", "run_eval_obb", "run_generate"]
