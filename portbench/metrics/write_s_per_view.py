"""write_s_per_view: rank 0's host-clock wall inside the program's
pipeline.write_outputs (two .dmb files, three PNGs, a PLY and results.txt),
a mean over its views that ended before its profiler started (traced runs
of the folder driver)."""


def read(ctx):
    walls = (getattr(ctx, "folder", None) or {}).get("write_s")
    return sum(walls) / len(walls) if walls else None
