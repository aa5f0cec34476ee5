"""search.done_read_ms: host ms a decode call waits in the beam's
done-flag reads: the port's ``beam.done_read`` spans (``beam_search``,
around each step's ``bool(done.all())``) over the number of
``decode.search`` spans (one a decode call)."""

from ckbench.program_spans import spans_per


def read(r):
    return spans_per(r, "beam.done_read", "decode.search")
