"""feed.gather_ms: host ms of the split's row gather and float32 cast a
batch: the port's ``split.gather`` spans (``decode_split``, around the
``next()`` of the split's batch iterator) over their number."""

from ckbench.program_spans import spans_per


def read(r):
    return spans_per(r, "split.gather", "split.gather")
