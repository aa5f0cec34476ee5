"""decode.mfu: the model's FLOPs per caption (the architecture's
``caption_flops``: the encode plus every step of every beam row, at the
configuration's widths) times the captions decoded in the traced window,
over the bf16 peak (989 TFLOP/s) times the window, in %."""

from ckbench import archs
from ckbench.roofline import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS


def read(r):
    if r.trace is None or not r.trace_captions or not r.trace.window_s:
        return None
    m = r.model
    per = archs.get(r.arch).caption_flops(
        m, beam=r.decode["beam_size"], steps=r.decode["max_decode_len"],
        t=22)
    peak = PEAK_FP32_FLOPS if m["compute_dtype"] == "float32" \
        else PEAK_BF16_FLOPS
    return 100.0 * per * r.trace_captions / (peak * r.trace.window_s)
