"""feed.copy_ms: device ms a batch of the host-to-device copies that the
batch's decode call launched (the profiler's memcpy records)."""


def read(r):
    if r.trace is None or not r.trace_batches:
        return None
    spans = r.trace.named("ckbench.batch")
    copy = sum(e - s for sp in spans for s, e, cat, name in sp.device
               if cat == "gpu_memcpy" and "HtoD" in name)
    if not copy:
        return None
    return 1e-3 * copy / r.trace_batches
