"""search.step_host_ms: host ms a decode call spends enqueueing the
beam's steps, outside the done-flag reads: the port's ``beam.step`` spans
(``beam_search``, around the loop's body) over the number of
``decode.search`` spans (one a decode call)."""

from ckbench.program_spans import spans_per


def read(r):
    return spans_per(r, "beam.step", "decode.search")
