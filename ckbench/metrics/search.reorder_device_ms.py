"""search.reorder_device_ms: device ms a batch of the beam's state
reorder (each step's row gather of every state field, ``_reorder_rows``:
kernels, memsets and device copies), over the traced batches."""


def read(r):
    if r.trace is None or not r.trace_batches:
        return None
    spans = r.trace.named("ckbench.call.reorder_rows|")
    busy = sum(sp.device_s() for sp in spans)
    return 1e3 * busy / r.trace_batches if busy else None
