"""moe.load_max_ratio: the busiest expert's slots times the experts over
all slots, summed over the expert layers' calls (the port's counters
``moe.busiest`` and ``moe.slots``): 1.0 where every expert gets as many
slots, more the more the load leans on one."""

from ckbench.program_spans import counters


def read(r):
    c = counters(r)
    if c is None or not c.get("moe.slots"):
        return None
    return c.get("moe.busiest", 0) / c["moe.slots"]
