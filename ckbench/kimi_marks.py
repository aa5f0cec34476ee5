"""The benchmark's marks around the port's wrappers that Kimi-VL's
language model adds: its MLA blocks, its expert layer and their grouped
products, and the beam's state reorder.

Each call of a wrapped function made inside a profiler session runs in a
``record_function`` named "ckbench.call.<wrapper>|<rows>|0|0" (the form
``instrument.parse_call`` reads), so the trace reader finds the device
work each call launched; outside a session the wrapper calls straight
through. The wrappers are replaced where the port's callers look them up
(the module attribute a calling function reads), once a process:
``archs/kimi_vl.py::program`` installs them, so only a run of that
architecture has them.
"""

from __future__ import annotations

import functools
import importlib

#: wrapper name -> (module the callers read it from, attribute, the rows
#: of a call from its positional arguments)
SITES = {
    "mla_prefill": ("captionkit_torch.nn.mla", "mla_prefill",
                    lambda a: a[2].shape[0] * a[2].shape[1]),
    "mla_decode": ("captionkit_torch.nn.mla", "mla_decode",
                   lambda a: a[2].shape[0]),
    "moe_layer": ("captionkit_torch.nn.moe", "moe_layer",
                  lambda a: a[0].shape[0]),
    "grouped_experts": ("captionkit_torch.nn.moe", "grouped_experts",
                        lambda a: a[0].shape[0]),
    "reorder_rows": ("captionkit_torch.decode.beam", "_reorder_rows",
                     lambda a: a[1].shape[0]),
}


def install() -> None:
    """Wrap every site that is not wrapped yet."""
    import torch
    from torch.profiler import record_function

    profiling = torch._C._autograd._profiler_enabled
    for wrapper, (mod_name, attr, rows) in SITES.items():
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        if getattr(fn, "_ckbench_mark", False):
            continue

        def marked(*args, _fn=fn, _w=wrapper, _rows=rows, **kw):
            if not profiling():
                return _fn(*args, **kw)
            with record_function(f"ckbench.call.{_w}|{_rows(args)}|0|0"):
                return _fn(*args, **kw)

        marked = functools.wraps(fn)(marked)
        marked._ckbench_mark = True
        setattr(mod, attr, marked)
