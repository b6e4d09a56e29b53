"""Device ms a frame of the work launched inside the ReID facade's
``_embed`` (the backbone on the frame's crops and the L2 norm)."""


def read(s):
    got = s.range_stat("reid._embed", "device_s")
    return None if not got or not s.units else got * 1e3 / s.units
