"""Host ms a step of the frame loop in the traced steps: the time from one
step's start to the next one's.  The loop never waits for the card on
purpose, so this is dispatch, and any wait once the launch queue is full."""


def read(s):
    got = s.range_stat("tracker.step", "period_s")
    return None if got is None else got * 1e3
