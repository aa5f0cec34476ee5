"""driver.consume_ms: host ms of ``decode_split``'s consume of a batch
(the read-back of its tokens and their detokenizing): the port's
``split.consume`` spans over their number."""

from ckbench.program_spans import spans_per


def read(r):
    return spans_per(r, "split.consume", "split.consume")
