"""search.host_reads: device-to-host reads that wait for the device, a
batch: the port's ``beam.done_read`` spans (one a step's done-flag read)
over its ``decode.search`` spans, plus its ``split.readback`` spans (one a
batch's token read-back) over its ``split.consume`` spans."""

from ckbench.program_spans import count_per


def read(r):
    steps = count_per(r, "beam.done_read", "decode.search")
    back = count_per(r, "split.readback", "split.consume")
    return None if steps is None or back is None else steps + back
