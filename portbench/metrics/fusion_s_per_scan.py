"""fusion_s_per_scan: rank 0's host-clock wall inside the program's
fusion.sharded.fuse_depthmaps_sharded, a mean over the run's scans (traced
runs of the folder driver; every rank's device is profiled then, so the
profiler's host cost is in it)."""


def read(ctx):
    walls = (getattr(ctx, "folder", None) or {}).get("fusion_s")
    return sum(walls) / len(walls) if walls else None
