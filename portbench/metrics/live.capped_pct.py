"""Share of the window's frames in which one of the tracker's assignments
stopped at the auction's iteration cap, %: the program's own counter
(``lap_capped`` in the tracker state), read after the window.  Each such
frame spends the cap's iterations of kernel K2."""


def read(s):
    frames = s.work.get("frames")
    if not frames or "capped_frames" not in s.work:
        return None
    return 100.0 * s.work["capped_frames"] / frames
