"""Share of a frame's time in which no operation ran on the card, %: one
less the traced frames' busy device time a frame over the untraced frames'
mean time (the profiler slows the frames it traces)."""


def read(s):
    unit_s = s.work.get("unit_s")
    if not unit_s or not s.units:
        return None
    return 100.0 * (1.0 - s.busy_s / s.units / unit_s)
