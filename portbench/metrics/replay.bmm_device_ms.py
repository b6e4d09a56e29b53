"""Device ms a step of the appearance products: the kernels launched inside
``aten::bmm`` in the traced steps (HybridSORT's two a step: the EMA
feature's and the long-term feature's cosine distances)."""


def read(s):
    got = s.range_stat("aten::bmm", "device_s")
    return None if not got or not s.units else got * 1e3 / s.units
