"""rank_wait_share: 1 - (mean over ranks of the host-clock wall inside
pipeline.run_batch) / (the longest such wall): the share of the slowest
rank's depth-map time that the others spend waiting at the barrier after
theirs (traced runs of the folder driver; a 7/6/6/6 split of 25 views
alone gives about 0.11)."""


def read(ctx):
    walls = (getattr(ctx, "folder", None) or {}).get("run_batch_s")
    if not walls or max(walls) <= 0:
        return None
    return 1.0 - sum(walls) / len(walls) / max(walls)
