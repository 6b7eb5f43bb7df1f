"""sampler_roofline: the exact cost path's bilinear sampler
(csrc/sampling.cu) as a share of its roofline, in %.  Each launch's bound
is its bytes (bounds.sampler_bytes, from the launch's shapes) at the HBM
peak; every launch of the traced views is counted."""
from portbench import bounds, roofline
from portbench.peaks import PORT_KERNEL_SYMBOLS

KEY = "bilinear_sample"


def _describe(ctx, src, x, y):
    C, H, W = src.shape
    return {"n": x.numel(), "C": C, "H": H, "W": W}


def install(ctx):
    from gipuma_tpu_torch.ops import sampling
    return roofline.install(ctx, sampling, "bilinear_sample_cuda", KEY,
                            _describe)


def _bound_s(c, pk):
    return bounds.sampler_bytes(c["n"], c["C"], c["H"], c["W"]) \
        / pk["hbm_bytes_per_s"]


def read(ctx):
    return roofline.share(ctx, KEY, PORT_KERNEL_SYMBOLS[KEY], _bound_s)
