"""mpix_per_s: reference-view pixels of every depth map completed in the
window, in MP, over the host-clock wall from the window's start to the
end of the last completed view (depth, normals and cost on the host;
every view's prepare_job included)."""


def read(ctx):
    if not ctx.views:
        return None
    px = sum(v.out.depth.size for v in ctx.views)
    return px / 1e6 / (ctx.views[-1].t2 - ctx.window_start)
