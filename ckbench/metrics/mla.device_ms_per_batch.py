"""mla.device_ms_per_batch: device ms a batch of the kernels and memsets
that the MLA blocks launched (``mla_prefill`` and ``mla_decode`` calls:
projections, rope, scores, softmax, read-out, the latent's write), over
the traced batches."""


def read(r):
    if r.trace is None or not r.trace_batches:
        return None
    spans = (r.trace.named("ckbench.call.mla_prefill|")
             + r.trace.named("ckbench.call.mla_decode|"))
    busy = sum(sp.device_s(("kernel", "gpu_memset")) for sp in spans)
    return 1e3 * busy / r.trace_batches if busy else None
