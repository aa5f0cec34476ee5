"""feed.pinned_share: % of the bytes the decode's feed copies to the
device that come from pinned host memory: the port's counters
``feed_bytes_pinned`` and ``feed_bytes_pageable`` (``feed_to_device``).
None where the feed copied nothing."""

from ckbench.program_spans import counters


def read(r):
    c = counters(r)
    if c is None:
        return None
    pinned = c.get("feed_bytes_pinned", 0)
    total = pinned + c.get("feed_bytes_pageable", 0)
    return None if not total else 100.0 * pinned / total
