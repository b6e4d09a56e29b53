"""boxmot_tpu_torch: the PyTorch + CUDA port of boxmot_tpu.

It runs ByteTrack (axis-aligned boxes) replay and live tracking on one
NVIDIA H100, or on the CPU through each kernel's plain PyTorch twin.  The
two hot ops of the tracker step are kernels written by hand for Hopper
(``csrc/``), built with nvcc on first use.  The package imports torch,
numpy and scipy, and the JAX package's host-only modules; never JAX.

Entry points::

    boxmot_tpu_torch.run_eval(root, "bytetrack", device="cuda")
    boxmot_tpu_torch.create_tracker("bytetrack", device="cuda").update(dets, img)
"""

from boxmot_tpu_torch.engine.eval import run_eval
from boxmot_tpu_torch.trackers.zoo import create_tracker

__all__ = ["create_tracker", "run_eval"]
