"""MoE (``models/moe.py``): device time of the kernels ``torch._grouped_mm``
launches (their names learned by profiling one call at a MoE layer's
shapes in set-up) over all device time of the traced window."""
from bench.reduce import kernel_time


def read(rec):
    names = rec.names.get("grouped_mm")
    t = kernel_time(rec, lambda n: bool(names) and n in names)
    if t is None:
        return None
    return 100.0 * t / rec.trace.busy_s
