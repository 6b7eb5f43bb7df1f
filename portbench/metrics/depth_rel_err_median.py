"""depth_rel_err_median: one median of |d - d_gt| / d_gt over the pixels
of all completed views that see a surface, borders trimmed as the check
trims them."""


def read(ctx):
    if ctx.rel_err_all is None or ctx.rel_err_all.numel() == 0:
        return None
    return float(ctx.rel_err_all.median())
