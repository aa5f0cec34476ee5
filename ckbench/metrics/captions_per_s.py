"""captions_per_s: captions of the split passes completed in the window,
over the time those passes took (host clock)."""


def read(r):
    if r.traffic["kind"] != "offline" or not r.window_s:
        return None
    return r.captions / r.window_s
