"""The fused frame's model FLOPs (YOLOX at the cell's input and the ReID
model on ``max_dets`` crops, counted from layer shapes by ``flops.py``) over
the untraced frames' mean time and the card's float32 peak (67 TFLOP/s;
TF32 is off), %."""

from portbench.peaks import FP32_FLOPS_PER_S


def read(s):
    f, unit_s = s.work.get("model_flops_per_frame"), s.work.get("unit_s")
    if not f or not unit_s:
        return None
    return 100.0 * f / unit_s / FP32_FLOPS_PER_S
