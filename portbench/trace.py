"""The traced window: the profiler's device events on the host's clock, and
what the host was doing while the device sat idle.

``Tracer`` records the device's activity (kernels, copies, sets) with
``torch.profiler``; a marker launched right after a device sync ties the
profiler's timestamps to ``time.perf_counter_ns``.  Nothing else runs
beside the program (a stack sampler of the host thread, even at 20 ms,
slows host-bound views: PERF.md), so idle time is named from what the
harness knows instead: the phase of the view the host was in (its own
clock stamps) and the device operation that ended the gap.  ``reduce``
turns the events into the numbers the metric readers take: device time by
name, the union of busy intervals, and idle time by host phase.
"""
from __future__ import annotations

import collections
import time

import numpy as np

OP_CHARS = 80        # a device operation's name in a label, cut to this


class Tracer:
    """Context manager around the traced part of the window."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.mark_host_ns = None
        self.events = None           # (names list, name ids, start ns, dur ns)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        marker = torch.empty(1, device="cuda")
        self.mark_host_ns = time.perf_counter_ns()
        marker.fill_(1.0)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        self._collect()
        return False

    def _collect(self):
        names, ids, starts, durs = [], [], [], []
        index = {}
        for ev in self.prof.profiler.kineto_results.events():
            if not str(ev.device_type()).endswith("CUDA"):
                continue
            d = ev.duration_ns()
            if d <= 0:
                continue
            n = ev.name()
            k = index.get(n)
            if k is None:
                k = index[n] = len(names)
                names.append(n)
            ids.append(k)
            starts.append(ev.start_ns())
            durs.append(d)
        order = np.argsort(np.asarray(starts, dtype=np.int64), kind="stable")
        starts = np.asarray(starts, dtype=np.int64)[order]
        durs = np.asarray(durs, dtype=np.int64)[order]
        ids = np.asarray(ids, dtype=np.int64)[order]
        # The first device event is the marker: shift the device clock onto
        # the host's perf_counter_ns.
        if len(starts):
            starts = starts - starts[0] + self.mark_host_ns
            starts, durs, ids = starts[1:], durs[1:], ids[1:]
        self.events = (names, ids, starts, durs)
        self.prof = None


def busy_union(starts: np.ndarray, durs: np.ndarray, lo: int, hi: int):
    """Merged busy intervals [(a, b)] of the events, clipped to [lo, hi]."""
    out = []
    ends = starts + durs
    for a, b in zip(starts.tolist(), ends.tolist()):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def idle_by_phase(busy, names, ids, starts, phases, lo: int, hi: int):
    """Idle ns by "<host phase> before <device op>": each gap between busy
    intervals is cut at the host phases it spans ((a, b, label) sorted and
    disjoint; time in none is the harness's), and each piece is named by
    its phase and the device operation that ended the gap."""
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    nxt = np.searchsorted(starts, [b for _, b in gaps]) if gaps else []
    out = collections.Counter()
    j = 0
    for (a, b), k in zip(gaps, nxt):
        op = (names[ids[k]][:OP_CHARS] if k < len(starts)
              else "the window's end")
        while j < len(phases) and phases[j][1] <= a:
            j += 1
        t, p = a, j
        while t < b:
            if p < len(phases) and phases[p][0] <= t:
                e, lab = min(b, phases[p][1]), phases[p][2]
                p += 1
            else:
                e = min(b, phases[p][0]) if p < len(phases) else b
                lab = "harness"
            out[f"{lab} before {op}"] += e - t
            t = e
    return out


def reduce(tracer: Tracer, lo_ns: int, hi_ns: int, phases=()) -> dict:
    """Numbers of the traced window [lo_ns, hi_ns] (host clock); `phases`
    are the host's (start ns, end ns, label) in it."""
    names, ids, starts, durs = tracer.events
    inside = (starts >= lo_ns) & (starts < hi_ns)
    ids, starts, durs = ids[inside], starts[inside], durs[inside]
    by_name = np.bincount(ids, weights=durs, minlength=len(names))
    calls = np.bincount(ids, minlength=len(names))
    busy = busy_union(starts, durs, lo_ns, hi_ns)
    busy_ns = sum(b - a for a, b in busy)
    idle_by = idle_by_phase(busy, names, ids, starts, list(phases),
                            lo_ns, hi_ns)
    top = np.argsort(-by_name)[:10]
    return {
        "names": names, "ids": ids, "starts": starts, "durs": durs,
        "device_ns_by_name": by_name, "calls_by_name": calls,
        "busy_s": busy_ns / 1e9, "window_s": (hi_ns - lo_ns) / 1e9,
        "device_s": float(durs.sum()) / 1e9,
        "device_ops": [[names[k][:120], float(by_name[k]) / 1e9]
                       for k in top if by_name[k] > 0],
        "idle_gaps": [[lab, ns / 1e9] for lab, ns in idle_by.most_common(10)],
    }


def kernel_events(red: dict, symbol: str):
    """(start ns, dur ns) of the events whose name holds `symbol`, in
    launch order."""
    hit = np.asarray([symbol in n for n in red["names"]], dtype=bool)
    sel = hit[red["ids"]] if len(red["ids"]) else np.zeros(0, dtype=bool)
    return red["starts"][sel], red["durs"][sel]
