"""kernel.head_topk_roofline: the vocab head's least time at the calls'
shapes (``roofline.head_bound``: 2 N H V bf16 products against the bytes
read and written once) over the device time its calls took (each call's
kernels from first start to last end, overlaps once), in %."""

from ckbench.instrument import parse_call
from ckbench.roofline import head_bound


def read(r):
    if r.trace is None:
        return None
    m = r.model
    bound = took = 0.0
    for sp in r.trace.named("ckbench.call.fused_head_topk|"):
        _, rows, _, _ = parse_call(sp.name)
        span = sp.device_span_s()
        if not span:
            continue
        bound += head_bound(rows, m["hidden_dim"], m["vocab_size"],
                            r.decode["beam_size"],
                            fp32=m["compute_dtype"] == "float32")[
                                "roofline_ms"] * 1e-3
        took += span
    return 100.0 * bound / took if took else None
