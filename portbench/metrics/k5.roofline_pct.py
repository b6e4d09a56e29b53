"""K5 (ReID crops, ``csrc/crops.cu``): the least time of the traced frames'
crops (``work.k5_bound``: the frame pixels the taps reach and the boxes read
once, the crops written once, at 3.35 TB/s) over the device time of every
``crops_*`` kernel in the traced frames, %."""

from portbench.peaks import roofline_pct


def read(s):
    bound = s.work.get("k5_bound_ms")
    launches, secs = s.kernel_s("crops_")
    return None if bound is None or not launches else roofline_pct(bound, secs * 1e3)
