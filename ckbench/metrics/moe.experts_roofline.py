"""moe.experts_roofline: the grouped expert products' least time
(``roofline_moe.experts_bound_s``: their FLOPs at the bf16 peak or the
bytes of the experts that got slots, read once, and of the slots' rows in
and out, at the memory's) over the device time their calls took (each
``grouped_experts`` call's kernels, first start to last end), in %. The
experts hit a call are the port's counter ``moe.experts_hit`` over its
``moe.experts`` spans."""

from ckbench.instrument import parse_call
from ckbench.program_spans import summary
from ckbench.roofline_moe import experts_bound_s


def read(r):
    s = summary(r)
    if s is None:
        return None
    calls = s["spans"].get("moe.experts", {}).get("count", 0)
    hit = s["counters"].get("moe.experts_hit", 0)
    if not calls or not hit:
        return None
    m = r.model
    bound = took = 0.0
    for sp in r.trace.named("ckbench.call.grouped_experts|"):
        _, slots, _, _ = parse_call(sp.name)
        span = sp.device_span_s()
        if not span:
            continue
        bound += experts_bound_s(slots, hit / calls, m["hidden_dim"],
                                 m["moe_intermediate_size"])
        took += span
    return 100.0 * bound / took if took else None
