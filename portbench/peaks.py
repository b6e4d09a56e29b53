"""The card's published peaks and the least time some work can take.

NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit: 3.35
TB/s of HBM and 67 TFLOP/s of float32 outside the tensor cores.  The
configurations run float32 with TF32 off, so the float32 rate bounds their
products and convolutions.  (The arithmetic of
``boxmot_tpu_torch/utils/measure.py::bound_ms``, copied so that the
yardstick does not move with the program.)
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations", whichever sets it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline_pct(bound_ms_total: float, device_ms_total: float) -> float | None:
    """The share of the least time in the time taken, in %; None without a
    measured time (a reader that finds nothing returns nothing)."""
    if not device_ms_total > 0.0:
        return None
    return 100.0 * bound_ms_total / device_ms_total
