"""kimi.decode_mfu: ``decode.mfu``'s reading in the Kimi-VL cell: the
architecture's FLOPs per caption (``archs/kimi_vl.py::caption_flops``:
the projector, the prefill, every beam row's steps and the head) times
the captions decoded in the traced window, over the bf16 peak (989
TFLOP/s) times the window, in %: the share of the whole step's peak."""

from ckbench import spec


def read(r):
    return spec.reader("decode.mfu")(r)
