"""run_s_per_view: host clock around pipeline.run_prepared_job, ending with
the host fetch of depth, normals and cost, averaged over the views of a
traced run that ended before the profiler started (its host cost is in
none of them)."""
from portbench.core import before_trace


def read(ctx):
    vs = before_trace(ctx)
    return sum(v.t2 - v.t1 for v in vs) / len(vs) if vs else None
