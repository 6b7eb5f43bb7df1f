"""readback_s_per_scan: the host-clock wall inside the program's
gipuma_tpu_torch.io.dmb.read_dmb during one scan (with --distributed,
cli.main reads every view's disp.dmb and normals.dmb back after the
barrier, before sharded fusion), summed over a rank's calls in the scan,
averaged over the ranks and then over the run's scans (traced runs of the
folder driver, whose profiler records the cards meanwhile).  The hook
works because cli.main imports read_dmb when it is called."""
KEY = "read_dmb"


def install(rctx):
    from gipuma_tpu_torch.io import dmb
    return rctx.time_calls(dmb, "read_dmb", KEY)


def read(ctx):
    ranks = getattr(ctx, "ranks", None)
    if not ranks:
        return None
    scans = []
    for k in range(len(ranks[0]["scans"])):
        walls = []
        for r in ranks:
            lo, hi = r["scans"][k]
            walls.append(sum(b - a for a, b in r["store"].get(KEY, [])
                             if lo <= a and b <= hi) / 1e9)
        scans.append(sum(walls) / len(walls))
    if not scans or not all(scans):
        return None
    return sum(scans) / len(scans)
