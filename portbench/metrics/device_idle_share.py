"""device_idle_share: 1 - device busy seconds per view / wall seconds per
view.  The busy seconds are the union of the device's busy intervals over
the traced views; the wall is that of the views that ended before the
profiler started, since the profiler's host cost lengthens the traced
views' wall (the run line's trace_overhead) but not the device's work,
which is alike from view to view of the window."""
from portbench.core import before_trace, per_view_s


def read(ctx):
    n = sum(1 for v in ctx.views if v.traced)
    wall = per_view_s(before_trace(ctx))
    if ctx.trace is None or not n or not wall:
        return None
    return 1.0 - ctx.trace["busy_s"] / n / wall
