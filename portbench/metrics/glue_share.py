"""glue_share: device time outside the program's own CUDA kernels (names
matched by peaks.PORT_KERNEL_SYMBOLS) over all device time of the traced
views (sums of event durations, copies and sets included)."""
from portbench.peaks import is_port_kernel


def read(ctx):
    if ctx.trace is None or ctx.trace["device_s"] <= 0:
        return None
    names, ns = ctx.trace["names"], ctx.trace["device_ns_by_name"]
    port = sum(float(t) for n, t in zip(names, ns) if is_port_kernel(n))
    total = float(ns.sum())
    return (total - port) / total
