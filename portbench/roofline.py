"""Shares of a kernel's roofline from the traced views.

A shim the benchmark puts round the program's wrapper of a kernel, in the
traced run only, records each launch made while the profiler records
(``install``).  The i-th recorded launch is the i-th device event of the
kernel's symbol; a reader sums the bounds of the recorded launches and
divides by the device time of the same launches.  Where the counts of launches and
events differ, or the card has no peaks, the share is not read.
"""
from __future__ import annotations

from .trace import kernel_events


def install(ctx, module, attr: str, key: str, describe):
    """Wrap module.<attr>; describe(ctx, *args, **kw) -> the record of one
    launch (a dict).  Returns the undo."""
    orig = getattr(module, attr)
    calls = ctx.shim_calls.setdefault(key, [])

    def shim(*args, **kw):
        if ctx.tracing:
            calls.append(describe(ctx, *args, **kw))
        return orig(*args, **kw)

    setattr(module, attr, shim)
    return lambda: setattr(module, attr, orig)


def share(ctx, key: str, symbol: str, bound_s) -> float | None:
    """100 * sum of bound_s(record) / sum of device seconds, over the
    recorded launches."""
    if ctx.trace is None or ctx.peaks is None:
        return None
    calls = ctx.shim_calls.get(key, [])
    _, durs = kernel_events(ctx.trace, symbol)
    if not calls or len(calls) != len(durs):
        return None
    t = int(durs.sum()) / 1e9
    if t <= 0:
        return None
    return 100.0 * sum(bound_s(c, ctx.peaks) for c in calls) / t
