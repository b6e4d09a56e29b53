"""K6 (greedy NMS, ``csrc/nms.cu``): the least time of the traced frames'
NMS calls (``work.k6_bound``: the scores and the examined candidates' boxes
read once, the kept indices written once, or the sorted definition's IoUs
at 67 TFLOP/s) over the device time of every ``nms_*`` kernel, %."""

from portbench.peaks import roofline_pct


def read(s):
    bound = s.work.get("k6_bound_ms")
    launches, secs = s.kernel_s("nms_")
    return None if bound is None or not launches else roofline_pct(bound, secs * 1e3)
