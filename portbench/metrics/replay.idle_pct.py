"""Share of a replay step's time in which no operation ran on the card, %:
one less the traced steps' busy device time a step over the untraced
calls' time a step (packing and upload included)."""


def read(s):
    unit_s = s.work.get("unit_s")
    if not unit_s or not s.units:
        return None
    return 100.0 * (1.0 - s.busy_s / s.units / unit_s)
