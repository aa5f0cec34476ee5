"""kernel.cells_roofline: the fused cells' least time at the calls' shapes
(``roofline.cell_bound`` of att_cell and lang_cell, or dcnet_score and
dcnet_cell; products and bytes, the special-function unit left out) over
the device time their calls took (each call's kernels from first start to
last end, overlaps once), in %."""

from ckbench.instrument import parse_call
from ckbench.roofline import cell_bound

CELLS = ("att_cell", "lang_cell", "dcnet_score", "dcnet_cell")


def read(r):
    if r.trace is None:
        return None
    m = r.model
    T = 22  # the existing caption's padded length (max_existing_len)
    bound = took = 0.0
    for sp in r.trace.named("ckbench.call."):
        name, rows, images, valid = parse_call(sp.name)
        span = sp.device_span_s()
        if name not in CELLS or not span or not images:
            continue
        b = cell_bound(name, rows, images, m["emb_dim"], m["hidden_dim"],
                       m["att_dim"], m["feat_dim"], m["num_regions"], T,
                       fp32=m["compute_dtype"] == "float32", t_valid=valid)
        bound += b["roofline_ms"] * 1e-3
        took += span
    return 100.0 * bound / took if took else None
