"""feed.host_copy_ms: host ms a decode call spends in its host-to-device
feed copy: the port's ``decode.feed_copy`` spans (``make_decode_fn``,
around ``feed_to_device`` and ``dequantize_for_feed``) over the number of
``decode.search`` spans (one a decode call)."""

from ckbench.program_spans import spans_per


def read(r):
    return spans_per(r, "decode.feed_copy", "decode.search")
