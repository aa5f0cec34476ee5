"""moe.device_ms_per_batch: device ms a batch of the kernels and memsets
that the expert layers launched (each ``moe_layer`` call: routing, the
grouped products, the combine, the shared experts), over the traced
batches."""


def read(r):
    if r.trace is None or not r.trace_batches:
        return None
    spans = r.trace.named("ckbench.call.moe_layer|")
    busy = sum(sp.device_s(("kernel", "gpu_memset")) for sp in spans)
    return 1e3 * busy / r.trace_batches if busy else None
