"""Host ms a frame of the detector's ``preprocess_u8`` (OpenCV's letterbox
of the 1280 x 720 frame to the detector's input)."""


def read(s):
    got = s.range_stat("detector.preprocess_u8", "host_s")
    return None if not got or not s.units else got * 1e3 / s.units
