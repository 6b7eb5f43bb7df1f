"""prep_s_per_view: host clock around pipeline.prepare_job, synced to the
device, averaged over the views of a traced run that ended before the
profiler started (its host cost is in none of them)."""
from portbench.core import before_trace


def read(ctx):
    vs = before_trace(ctx)
    return sum(v.t1 - v.t0 for v in vs) / len(vs) if vs else None
