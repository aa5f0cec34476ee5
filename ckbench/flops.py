"""Model FLOPs of a beam decode, from the configuration's widths; each
architecture counts its own (``archs/<arch>.py::caption_flops``).

A caption costs its encode (once per image) plus ``steps`` decode steps
of ``beam`` rows each: every row of the beam runs the whole step, live or
not, as the batched beam search does. Counted are the products (2 m n k
for an [m, k] x [k, n] product) and the attention reads (weights times
values); the score arithmetic of additive attention (an add, a tanh, a
multiply-add per term) and the gates' elementwise work are not products
and are left out, as a model FLOP count leaves them out.
"""

from __future__ import annotations


def lstm(d_in: int, h: int) -> int:
    """One row's LSTM step: [x | h] times the four gates' kernels."""
    return 2 * (d_in + h) * 4 * h
