"""Device ms a frame of the work launched inside the detector's ``detect``
(standardized frame in, NMS out: YOLOX's forward, decode and kernel K6)."""


def read(s):
    got = s.range_stat("detector.detect", "device_s")
    return None if not got or not s.units else got * 1e3 / s.units
