"""K4 (the ORU, ``csrc/oru.cu``): the least time of the traced steps' ORU
replays (``work.k4_bound`` over each step's rejoin flags and gaps, as the
reference replays them) over the device time of every ``oru_*`` kernel in
those steps, %."""

from portbench.peaks import roofline_pct


def read(s):
    bound = s.work.get("k4_bound_ms")
    launches, secs = s.kernel_s("oru_")
    return None if bound is None or not launches else roofline_pct(bound, secs * 1e3)
