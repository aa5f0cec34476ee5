"""The yardstick: the H100's peaks and the least time of each kernel call.

Frozen copies of the bound functions that the port's chip smoke test
worked out (operations and bytes from the shapes alone), kept here so
that a change to the program cannot change how its kernels are judged.
A bound counts the algorithm's work at the call's shapes: each input
read once, each output written once, whatever the kernel reads again.
The longest of the units that run at once (tensor cores, CUDA cores,
special-function unit, memory) is the least time of the call.

The special-function peak is worked out from the SM count and clock, not
published, and no metric of this benchmark takes it: the bound functions
report ``tanh_m`` beside it, and ``bound_s`` of the rooflines read here
comes from products and bytes (``BOUND_UNITS``).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores, TF32 off
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# 16 MUFU results a clock an SM, 132 SMs at the 1,980 MHz boost clock.
PEAK_SFU_OPS = 132 * 16 * 1.98e9

#: the units a roofline share of this benchmark is taken against
BOUND_UNITS = ("tensor cores", "CUDA cores", "bytes")


def ops_bound(mm, ew, n_bytes, fp32=False, tanh=0) -> dict:
    """The least time of a call: bf16 products on the tensor cores, fp32
    arithmetic on the CUDA cores and ``tanh`` on the special-function
    unit (separate units, so the longest of them) against the bytes read
    and written once. ``fp32``: the products too run on the CUDA cores.
    ``bound_ms`` takes every unit; ``roofline_ms`` leaves out the
    special-function unit, whose peak is not published."""
    if fp32:
        mm, ew = 0, mm + ew
    units = {"tensor cores": mm / PEAK_BF16_FLOPS,
             "CUDA cores": ew / PEAK_FP32_FLOPS,
             "special-function unit": tanh / PEAK_SFU_OPS,
             "bytes": n_bytes / PEAK_BYTES}
    unit = max(units, key=units.get)
    published = max(BOUND_UNITS, key=units.get)
    return {"bf16_gflop": mm / 1e9, "fp32_gflop": ew / 1e9,
            "tanh_m": tanh / 1e6, "mbytes": n_bytes / 1e6,
            "bound_ms": 1e3 * units[unit],
            "bound_by": "bytes" if unit == "bytes" else "operations",
            "bound_unit": unit,
            "roofline_ms": 1e3 * units[published],
            "roofline_unit": published}


def head_bound(N, H, V, k, *, int8: bool = False, fp32: bool = False
               ) -> dict:
    """The vocab head's top-k: 2 N H V products (bf16, int8 or fp32)
    against h, W, scales and bias read once and the top-k and log-sum-exp
    written once."""
    ops = 2.0 * N * H * V
    if int8:
        n_bytes = N * H * 4 + H * V + 2 * V * 4 + N * k * 8 + N * 4
        t_ops = ops / PEAK_INT8_OPS
    elif fp32:
        n_bytes = N * H * 4 + H * V * 4 + V * 4 + N * k * 8 + N * 4
        t_ops = ops / PEAK_FP32_FLOPS
    else:
        n_bytes = N * H * 2 + H * V * 2 + V * 4 + N * k * 8 + N * 4
        t_ops = ops / PEAK_BF16_FLOPS
    t_bytes = n_bytes / PEAK_BYTES
    ms = 1e3 * max(t_ops, t_bytes)
    return {"bound_ms": ms, "roofline_ms": ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def cell_bound(name, N, B, E, H, A, F, R, T, fp32=False, t_valid=None
               ) -> dict:
    """One fused-cell call (``att_cell``, ``lang_cell``, ``dcnet_score``,
    ``dcnet_cell``) at N rows of B images. Each attended (row, position,
    A) term is one add and one multiply-add (3 fp32 operations) and one
    tanh. ``t_valid``: the attendable (image, caption position) pairs
    (all B T when None); a masked position needs no key and no
    arithmetic."""
    f4, b2 = 4, (4 if fp32 else 2)
    K = N // B
    t_valid = B * T if t_valid is None else t_valid
    if name == "att_cell":
        mm = 2 * N * (E + 2 * H) * 4 * H + 2 * N * H * 2 * A
        tanh = N * R * A + K * t_valid * A
        ew = 3 * tanh
        n_in = (N * E * f4 + 3 * N * H * f4 + N * 4 * H * f4
                + (E + 2 * H) * 4 * H * b2 + H * 2 * A * b2 + 4 * A * f4
                + (B * R + t_valid) * A * b2 + B * T * f4)
        n_out = 2 * N * H * f4 + N * (R + T) * b2
    elif name == "lang_cell":
        mm = (2 * N * H * F + 2 * N * (F + 2 * H) * 4 * H
              + 2 * N * (F + 3 * H) * H)
        ew = tanh = 0
        n_in = (N * F * f4 + 4 * N * H * f4 + H * F * b2
                + (F + 2 * H) * 4 * H * b2 + (F + 3 * H) * H * b2
                + (F + 5 * H) * f4)
        n_out = 2 * N * H * f4
    elif name == "dcnet_score":
        mm = 2 * N * H * A
        tanh = K * t_valid * A
        ew = 3 * tanh
        n_in = (N * H * f4 + H * A * b2 + 2 * A * f4 + t_valid * A * b2
                + B * T * f4)
        n_out = N * T * b2
    elif name == "dcnet_cell":
        mm = 2 * N * H * H + 2 * N * (E + 2 * H) * 4 * H
        ew = tanh = 0
        n_in = (N * E * f4 + 3 * N * H * f4 + H * H * b2
                + (E + 2 * H) * 4 * H * b2 + 5 * H * f4)
        n_out = 2 * N * H * f4
    else:
        raise ValueError(f"no bound for cell {name!r}")
    return ops_bound(mm, ew, n_in + n_out, fp32, tanh)


def score_stage_bound(N, B, A, heads, fp32=False, split=1) -> dict:
    """A score stage alone (the score kernel after its query product):
    over ``heads``, each (P positions, attendable pairs, masked), one tanh
    and 3 fp32 operations per attended term; each head's q partials, b, v,
    attended keys and mask read, its weights [N, P] written once."""
    kb = 4 if fp32 else 2
    K = N // B
    tanh = sum(K * valid * A for _, valid, _ in heads)
    n_bytes = sum(split * N * A * 4 + 2 * A * 4 + valid * A * kb
                  + (B * P * 4 if masked else 0) + N * P * kb
                  for P, valid, masked in heads)
    return ops_bound(0, 3 * tanh, n_bytes, fp32, tanh)


def lstm_bound(N, D, H, copy, fp32=False) -> dict:
    """An LSTM (or Copy-LSTM) cell: 2 N (D + H) 4H products (and 2 N
    (D + 2H) H for the copy gate); x, h, c (and c*) read in fp32, the
    weights once, h' and c' written in fp32."""
    wb = 4 if fp32 else 2
    mm = 2 * N * (D + H) * 4 * H
    n_bytes = 4 * N * (D + 2 * H) + wb * (D + H) * 4 * H + 16 * H + 8 * N * H
    if copy:
        mm += 2 * N * (D + 2 * H) * H
        n_bytes += 4 * N * H + wb * (D + 2 * H) * H + 4 * H
    return ops_bound(mm, 0, n_bytes, fp32)


def attention_bound(B, P, A, V, Q, n_valid, fp32=False) -> dict:
    """Additive attention: the query product 2 B Q A; per valid (row,
    position) 3 A fp32 operations and A tanh for the score and 2 V for the
    context; the valid keys and values read once, ctx and w written."""
    wb = 4 if fp32 else 2
    mm = 2 * B * Q * A
    ew = n_valid * (3 * A + 2 * V)
    n_bytes = (4 * B * Q + wb * Q * A + 8 * A + wb * n_valid * (A + V)
               + 4 * B + 4 * B * V + 4 * B * P)
    return ops_bound(mm, ew, n_bytes, fp32, tanh=n_valid * A)


def wholestep_bound(N, H, F, V, k, fp32=False) -> dict:
    """The lang cell's products and the head's 2 N H V; the cell's inputs
    read in fp32, the weights once, h', c', the top-k and lse written."""
    wb = 4 if fp32 else 2
    mm = (2 * N * H * F + 2 * N * (F + 2 * H) * 4 * H
          + 2 * N * (F + 3 * H) * H + 2 * N * H * V)
    n_bytes = (4 * N * F + 16 * N * H + wb * H * F
               + wb * (F + 2 * H) * 4 * H + wb * (F + 3 * H) * H
               + 4 * (F + 5 * H) + wb * H * V + 4 * V + 8 * N * H
               + 8 * N * k + 4 * N)
    return ops_bound(mm, 0, n_bytes, fp32)
