"""Device ms a step of the work launched inside the tracker's step (all
sequences at once), over the traced steps."""


def read(s):
    got = s.range_stat("tracker.step", "device_s")
    return None if not got or not s.units else got * 1e3 / s.units
