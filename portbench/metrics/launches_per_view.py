"""launches_per_view: device kernels (glue included; copies and sets left
out) the profiler recorded in the traced views, per view."""


def read(ctx):
    vs = [v for v in ctx.views if v.traced]
    if ctx.trace is None or not vs:
        return None
    names, calls = ctx.trace["names"], ctx.trace["calls_by_name"]
    n = sum(int(c) for name, c in zip(names, calls)
            if not name.startswith(("Memcpy", "Memset")))
    return n / len(vs)
