"""device.idle_share: 1 - (device activity, overlaps once) / the traced
window, in %."""


def read(r):
    if r.trace is None or not r.trace.window_s or not r.trace.busy_s:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
