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

On a CUDA tensor ``bilinear_sample`` launches ``csrc/sampling.cu``; on a
CPU tensor it runs the plain torch version.  The JAX package's TPU gather
layouts (``pack_bilinear_taps`` / ``bilinear_sample_packed``,
``bilinear_sample_slicegather``, the Pallas block split ``split_blocks`` /
``pad_width_to_128``) exist for the TPU's gather costs and are not ported:
they compute this same function.
"""
from __future__ import annotations

import ctypes

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


def bilinear_sample_cuda(src_chw: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """Launch csrc/sampling.cu: same contract as the plain version."""
    if src_chw.dim() != 3:
        raise ValueError(f"bilinear_sample: src must be [C, H, W], got "
                         f"{tuple(src_chw.shape)}")
    C, H, W = src_chw.shape
    if H < 2 or W < 2:
        raise ValueError(f"bilinear_sample: source {H}x{W} is below 2x2")
    for name, t in (("src", src_chw), ("x", x), ("y", y)):
        if t.dtype != torch.float32:
            raise TypeError(f"bilinear_sample: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device.type != "cuda" or t.device != src_chw.device:
            raise ValueError(f"bilinear_sample: {name} must be on the "
                             f"source's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"bilinear_sample: {name} must be contiguous")
    if x.shape != y.shape or x.dim() < 1:
        raise ValueError(f"bilinear_sample: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} must match, with a batch axis")
    B = x.shape[0]
    N = x[0].numel() if B else 0
    out = torch.empty((B, C) + tuple(x.shape[1:]), dtype=torch.float32,
                      device=x.device)
    rc = _cuda_fn()(kernels.ptr(src_chw), kernels.ptr(x), kernels.ptr(y),
                    kernels.ptr(out), C, H, W, N, B,
                    kernels.stream_ptr(x.device))
    kernels.check(rc, "bilinear_sample")
    kernels.counts["bilinear_sample"] += 1
    return out


_FN = None


def _cuda_fn():
    global _FN
    if _FN is None:
        fn = kernels.library("sampling").gtt_bilinear_sample
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, cll, cll, vp]
        fn.restype = ci
        _FN = fn
    return _FN


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
