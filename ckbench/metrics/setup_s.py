"""setup_s: seconds from process start to the window's first timed work
(import, kernel libraries built or loaded, weights, inputs, warm-up)."""


def read(r):
    return r.setup_s or None
