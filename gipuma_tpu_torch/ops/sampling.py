"""Image sampling — the exact cost path's bilinear sampler, kernel 3 of the
port.

Counterpart of ``gipuma_tpu/ops/sampling.py`` (``central_gradients``,
``bilinear_sample``) and of the Pallas sampler that computes the same
function (``gipuma_tpu/ops/pallas_sampling.py::_sample_kernel``):

    x  = clip(x, 0, W-1),  x0 = clip(floor(x), 0, W-2),  fx = clip(x - x0, 0, 1)
    (same for y)
    out = (v00*(1-fx) + v01*fx)*(1-fy) + (v10*(1-fx) + v11*fx)*fy

with clamp-to-edge addressing (what CUDA texture fetches at unnormalized
coordinates resolve to).  NaN coordinates give NaN samples, as jnp.clip
does, so a degenerate plane still ends as MAXCOST downstream.

On a CUDA tensor ``bilinear_sample`` launches ``csrc/sampling.cu``, on
the route that ``sampler_route`` picks by the number of position rows B
(one launch a call on any route); on a CPU tensor it runs the plain torch
version.  The JAX package's TPU gather
layouts (``pack_bilinear_taps`` / ``bilinear_sample_packed``,
``bilinear_sample_slicegather``, the Pallas block split ``split_blocks`` /
``pad_width_to_128``) exist for the TPU's gather costs and are not ported:
they compute this same function.
"""
from __future__ import annotations

import torch

from .. import kernels


def central_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """gx[y,x] = I[y,x+1] - I[y,x-1] (clamped at edges), same for gy.
    img: [..., H, W] -> (gx, gy) of the same shape."""
    right = torch.cat([img[..., :, 1:], img[..., :, -1:]], dim=-1)
    left = torch.cat([img[..., :, :1], img[..., :, :-1]], dim=-1)
    down = torch.cat([img[..., 1:, :], img[..., -1:, :]], dim=-2)
    up = torch.cat([img[..., :1, :], img[..., :-1, :]], dim=-2)
    return right - left, down - up


def bilinear_sample_plain(src_chw: torch.Tensor, x: torch.Tensor,
                          y: torch.Tensor) -> torch.Tensor:
    """Plain torch version: src [C, H, W] f32, x and y [B, ...] ->
    [B, C, ...].  The same clip, floor and lerp order as the kernel."""
    C, H, W = src_chw.shape
    B = x.shape[0]
    x = x.clamp(0.0, float(W - 1))
    y = y.clamp(0.0, float(H - 1))
    x0 = torch.floor(x).to(torch.int32).clamp(0, W - 2)
    y0 = torch.floor(y).to(torch.int32).clamp(0, H - 2)
    fx = (x - x0.to(x.dtype)).clamp(0.0, 1.0)
    fy = (y - y0.to(y.dtype)).clamp(0.0, 1.0)
    flat = src_chw.reshape(C, H * W)
    i00 = (y0.to(torch.int64) * W + x0.to(torch.int64)).reshape(-1)

    def tap(off):
        return flat[:, i00 + off].reshape((C, B) + x.shape[1:]).transpose(0, 1)

    v00, v01, v10, v11 = tap(0), tap(1), tap(W), tap(W + 1)
    fx, fy = fx[:, None], fy[:, None]
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + \
        (v10 * (1 - fx) + v11 * fx) * fy


# The kernel's routes: 0, one thread a sample; 32 and 64, a block a tile
# of that many rows b x 32 pixels (csrc/sampling.cu).
SAMPLER_ROUTES = (0, 32, 64)


def sampler_route(B: int) -> int:
    """The kernel's route for B rows of positions: the 64-row tile where B
    is a whole number of 64-offset windows (PM at box 15, increment 2),
    the 32-row tile for any other B >= 32, one thread a sample below (the
    tiles' lanes run across b, and would idle)."""
    if B >= 64 and B % 64 == 0:
        return 64
    return 32 if B >= 32 else 0


def bilinear_sample_cuda(src_chw: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """Launch csrc/sampling.cu on the route of x's rows (sampler_route):
    same contract as the plain version."""
    B = x.shape[0] if x.dim() else 0
    return bilinear_sample_on_route(src_chw, x, y, sampler_route(B))


def bilinear_sample_on_route(src_chw: torch.Tensor, x: torch.Tensor,
                             y: torch.Tensor, route: int) -> torch.Tensor:
    """bilinear_sample_cuda on a given route of SAMPLER_ROUTES, whatever
    B; every route gives the same bits.  Counts the launch in
    kernels.counts["bilinear_sample"], and a tiled one in
    ["bilinear_sample_tiled"] too."""
    if route not in SAMPLER_ROUTES:
        raise ValueError(f"bilinear_sample: route {route} is not one of "
                         f"{SAMPLER_ROUTES}")
    if src_chw.dim() != 3:
        raise ValueError(f"bilinear_sample: src must be [C, H, W], got "
                         f"{tuple(src_chw.shape)}")
    C, H, W = src_chw.shape
    if H < 2 or W < 2:
        raise ValueError(f"bilinear_sample: source {H}x{W} is below 2x2")
    kernels.check_args("bilinear_sample",
                       (("src", src_chw), ("x", x), ("y", y)))
    if x.shape != y.shape or x.dim() < 1:
        raise ValueError(f"bilinear_sample: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} must match, with a batch axis")
    B = x.shape[0]
    N = x[0].numel() if B else 0
    out = torch.empty((B, C) + tuple(x.shape[1:]), dtype=torch.float32,
                      device=x.device)
    kernels.launch("bilinear_sample", "gtt_bilinear_sample",
                   kernels.ptr(src_chw), kernels.ptr(x), kernels.ptr(y),
                   kernels.ptr(out), C, H, W, N, B, route,
                   kernels.stream_ptr(x.device),
                   also="bilinear_sample_tiled" if route else None)
    return out


def bilinear_sample(src_chw: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample src [C, H, W] at float coordinates x, y [B, ...];
    clamp to edge.  Returns [B, C, ...].  The kernel on a CUDA tensor, the
    plain version on a CPU tensor.  (The JAX package's ``bilinear_sample``
    takes [H, W, C] and returns [..., C]; the port keeps channels first,
    the layout the kernel writes.)"""
    if src_chw.device.type == "cpu":
        return bilinear_sample_plain(src_chw, x, y)
    return bilinear_sample_cuda(src_chw, x.contiguous(), y.contiguous())
