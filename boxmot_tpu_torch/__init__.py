"""boxmot_tpu_torch: the PyTorch + CUDA port of boxmot_tpu.

It runs ByteTrack and SFSORT replay, eval and live tracking, for
axis-aligned and oriented boxes, on one NVIDIA H100, or on the CPU through
each kernel's plain PyTorch twin.  The hot ops of the tracker steps are
kernels written by hand for Hopper (``csrc/``), built with nvcc on first
use.  The package imports torch, numpy and scipy, and the JAX package's
host-only modules; never JAX.

Entry points::

    boxmot_tpu_torch.run_eval(root, "bytetrack", device="cuda")
    boxmot_tpu_torch.run_eval_obb(mmot_root, "sfsort", device="cuda")
    tracker = boxmot_tpu_torch.create_tracker("sfsort", device="cuda")
    tracker.update(dets, img)  # (N, 6) xyxy or (N, 7) xywha detections
"""

from boxmot_tpu_torch.engine.eval import run_eval
from boxmot_tpu_torch.engine.eval_obb import run_eval_obb
from boxmot_tpu_torch.trackers.zoo import create_tracker

__all__ = ["create_tracker", "run_eval", "run_eval_obb"]
