"""boxmot_tpu_torch: the PyTorch + CUDA port of boxmot_tpu.

It runs the ten trackers of the JAX zoo: replay, eval and live tracking
with ByteTrack, SFSORT, OC-SORT, BoT-SORT and OccluBoost for axis-aligned
and oriented boxes, and DeepOCSORT, BoostTrack, StrongSORT and HybridSORT
for axis-aligned ones, with appearance embeddings and camera-motion
compensation (ECC on the device), on one NVIDIA H100, or on the CPU
through each kernel's plain PyTorch twin; and sam2mot, a host tracker in
both packages.  The hot ops of the tracker steps are
kernels written by hand for Hopper (``csrc/``), built with nvcc on first
use.  The package imports torch, numpy, scipy and cv2 (the OBB metric),
and nothing of JAX or of the JAX package: it keeps its own copies of the
host modules it needs (``data``, ``engine.metrics``, ``engine.mot_io``,
``engine.results``, ``trackers.per_class_ids``, ``trackers.track_results``).

Entry points, on the card unless ``device="cpu"`` is given::

    boxmot_tpu_torch.run_eval(root, "bytetrack")
    boxmot_tpu_torch.run_eval_obb(mmot_root, "ocsort")
    tracker = boxmot_tpu_torch.create_tracker("ocsort")
    tracker.update(dets, img)  # (N, 6) xyxy or (N, 7) xywha detections
"""

from boxmot_tpu_torch.engine.eval import run_eval
from boxmot_tpu_torch.engine.eval_obb import run_eval_obb
from boxmot_tpu_torch.trackers.zoo import create_tracker

__all__ = ["create_tracker", "run_eval", "run_eval_obb"]
