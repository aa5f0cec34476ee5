"""model.device_ms_per_batch: device ms a batch of the kernels and memsets
that the batch's decode call launched (the profiler's records; copies are
the feed's)."""


def read(r):
    if r.trace is None or not r.trace_batches:
        return None
    spans = r.trace.named("ckbench.batch")
    busy = sum(sp.device_s(("kernel", "gpu_memset")) for sp in spans)
    if not busy:
        return None
    return 1e3 * busy / r.trace_batches
