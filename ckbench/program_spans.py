"""Readers' access to the port's own spans and counters.

The port records them (``captionkit_torch.utils.profiling``: ``annotate``
and ``count``) only while a profiler session runs, that is, in a traced
run's window; the store then holds that window. A span is recorded when
it is entered inside the session, so a reader divides a span's total by
the count of a span entered with it: the spans inside the decode function
by ``decode.search``, the consume's by ``split.consume``. A program
without the store (one older than it) reads as nothing.
"""

from __future__ import annotations


def summary(r):
    """The port's ``profiling.summary()`` in a traced run, else None.
    Imported here, at read time: loading a reader loads no program."""
    if r.trace is None:
        return None
    try:
        from captionkit_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "summary", None)
    return None if read is None else read()


def _count(s, name: str) -> int:
    return s["spans"].get(name, {}).get("count", 0)


def spans_per(r, name: str, per: str):
    """ms of the ``name`` spans' total over the number of ``per`` spans."""
    s = summary(r)
    if s is None or not _count(s, name) or not _count(s, per):
        return None
    return 1e-6 * s["spans"][name]["total_ns"] / _count(s, per)


def count_per(r, name: str, per: str):
    """The number of ``name`` spans over the number of ``per`` spans."""
    s = summary(r)
    if s is None or not _count(s, per):
        return None
    return _count(s, name) / _count(s, per)


def counters(r):
    """The port's counter totals in a traced run, else None."""
    s = summary(r)
    return None if s is None else s["counters"]
