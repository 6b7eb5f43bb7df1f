"""Fused window-grads rect cost — kernel 2 of the port.

Counterpart of ``gipuma_tpu/ops/pallas_sdg_fused.py``: the bilateral-
weighted truncated color+gradient window cost of K affine disparity
candidates on one rectified pair, with source gradients taken from
neighbouring window samples (Jacobian-corrected by 1/(1-a), clamped to
|1-a| >= 0.25, and +b*gx), one-sided and doubled at the window edges under
``sdg_onesided_edges``.  Semantics: pmCost/pmCostComputation
(gipuma.cu:223-320,455-518) on the rectified grid, as documented in
gipuma_tpu/ops/rect_cost.py.

On a CUDA tensor ``fused_sdg_cost_batch`` launches ``csrc/sdg_fused.cu``;
on a CPU tensor it runs the plain torch version below: a plain affine
packed-tap gather and ``window_grads_cost``, the JAX package's unfused
window_grads arithmetic (``rect_cost._rect_pair_cost_batch_sdg``), which
the port's unfused path (``fused_window_cost=False``) shares.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..config import MAXCOST
from .rowgather import _lerp_gather, _lerp_taps


def window_geometry(params):
    """(xs_off, rows_c, xs_ext, ys_ext): the contribution columns and rows
    of the window and the sampled (extended) columns and rows."""
    vr, hrad = params.box_vrad, params.box_hrad
    inc = params.window_increment
    xs_off = list(range(-hrad, hrad + 1, inc))
    rows_c = list(range(-vr, vr + 1, inc))
    if params.sdg_onesided_edges:
        return xs_off, rows_c, xs_off, rows_c
    return (xs_off, rows_c, list(range(-hrad - inc, hrad + inc + 1, inc)),
            list(range(-vr - inc, vr + inc + 1, inc)))


def _clip(v, lo, hi):
    return torch.minimum(torch.maximum(v, lo), hi)


def window_grads_cost(ref_chw: torch.Tensor, abc_k: torch.Tensor, params,
                      smps) -> torch.Tensor:
    """The window_grads cost from the sampled window rows: smps[t] is
    [K, E, C, hr, wr], the samples of window row ys_ext[t] at the columns
    xs_ext (``window_geometry``).  The arithmetic of the JAX package's
    unfused path (``rect_cost._rect_pair_cost_batch_sdg``): source
    gradients from neighbouring samples, Jacobian-corrected by 1/(1-a)
    (|1-a| >= 0.25) and +b*gx, one-sided and doubled at the window edges
    under ``sdg_onesided_edges``.  The columns of one window row are
    computed together; their terms are added one at a time in the JAX
    package's order.  Returns [K, hr, wr], NaN or >= MAXCOST at MAXCOST."""
    ch, hr, wr = ref_chw.shape
    C = ch // 3
    K = abc_k.shape[0]
    dev = ref_chw.device
    onesided = params.sdg_onesided_edges
    xs_off, rows_c, xs_ext, ys_ext = window_geometry(params)
    ncol = len(xs_off)
    nrow = len(ys_ext) - (0 if onesided else 2)
    inv_gamma = 1.0 / params.gamma
    alpha = params.alpha
    grad_scale = 0.0625 / params.window_increment

    b = abc_k[:, 1]
    s1 = 1.0 - abc_k[:, 0]
    inv_ax = 1.0 / torch.where(s1.abs() < 0.25,
                               torch.where(s1 < 0.0, -0.25, 0.25), s1)
    # Sample columns (e, elo, ehi) of each contribution column j, and the
    # doubling of a one-sided difference.  Index tensors come from arange
    # (no host-to-device copy, so a CUDA graph can capture this).
    jj = torch.arange(ncol, device=dev)
    if onesided:
        e_t, lo_t, hi_t = jj, (jj - 1).clamp(min=0), (jj + 1).clamp(max=ncol - 1)
    else:
        e_t, lo_t, hi_t = jj + 1, jj, jj + 2
    scx = torch.where(hi_t - lo_t == 1, 2.0, 1.0)
    gx_scale = (scx[None, :, None, None] * inv_ax[:, None])[:, :, None]
    rows = torch.arange(hr, device=dev)
    cols = (torch.arange(wr, device=dev)[None, :]
            + (jj * params.window_increment + xs_off[0])[:, None]
            ).clamp(0, wr - 1)

    def _l1(x):
        return x.abs().mean(dim=-3)

    ref_center = ref_chw[:C]
    acc = torch.zeros((K, hr, wr), dtype=torch.float32, device=dev)
    for jr, dyc in enumerate(rows_c):
        if onesided:
            tlo, thi = max(jr - 1, 0), min(jr + 1, nrow - 1)
        else:
            tlo, thi = jr, jr + 2
        scy = 2.0 if thi - tlo == 1 else 1.0
        smp0 = smps[tlo]
        smp1 = smps[jr + (0 if onesided else 1)]
        smp2 = smps[thi]
        ref_w = ref_chw[:, (rows + dyc).clamp(0, hr - 1)][:, :, cols]
        ref_w = ref_w.permute(2, 0, 1, 3)                # [ncol, 3C, hr, wr]
        img_s = smp1[:, e_t]                             # [K, ncol, C, hr, wr]
        gx_s = (smp1[:, hi_t] - smp1[:, lo_t]) * gx_scale
        gy_s = (smp2[:, e_t] - smp0[:, e_t]) * scy + b[:, None, None] * gx_s
        w = torch.exp(-_l1(ref_w[:, :C] - ref_center) * inv_gamma)
        col = torch.clamp(_l1(ref_w[None, :, :C] - img_s),
                          max=params.tau_color)
        grad = torch.clamp(
            (_l1(ref_w[None, :, C:2 * C] - gx_s)
             + _l1(ref_w[None, :, 2 * C:] - gy_s)) * grad_scale,
            max=params.tau_gradient)
        term = w[None] * ((1.0 - alpha) * col + alpha * grad)
        for j in range(ncol):
            acc = acc + term[:, j]
    return torch.where(torch.isnan(acc) | (acc >= MAXCOST), MAXCOST, acc)


def fused_sdg_cost_batch_plain(ref_chw: torch.Tensor,
                               src_packed: torch.Tensor,
                               abc_k: torch.Tensor, params,
                               disp_lo, disp_hi) -> torch.Tensor:
    """Plain torch version of the fused cost: [K, Hr, Wr].  Every pixel is
    computed (hw_valid / tile_ok regions are unspecified anyway).  Samples
    take the fused kernel's association a*x + (b*y + c)."""
    ch, hr, wr = ref_chw.shape
    C = ch // 3
    K = abc_k.shape[0]
    dev = ref_chw.device
    _, _, xs_ext, ys_ext = window_geometry(params)
    E = len(xs_ext)
    lo = torch.as_tensor(disp_lo, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(disp_hi, dtype=torch.float32, device=dev)
    rows = torch.arange(hr, device=dev)
    xg = torch.arange(wr, device=dev).to(torch.float32)[None, :].expand(hr, wr)
    yg = rows.to(torch.float32)[:, None].expand(hr, wr)
    a, b, c = abc_k[:, 0], abc_k[:, 1], abc_k[:, 2]          # [K, hr, wr]
    dx_e = torch.arange(xs_ext[0], xs_ext[-1] + 1, params.window_increment,
                        dtype=torch.float32, device=dev)      # xs_ext

    def gather_row(dy: int):
        """Samples of window row dy: [K, E, C, hr, wr]."""
        src_rows = src_packed[:, (rows + dy).clamp(0, hr - 1)]  # [C, hr, W]
        W = src_rows.shape[-1]
        xse = xg[None, None] + dx_e[None, :, None, None]      # [1, E, hr, wr]
        disp = a[:, None] * xse + (b * (yg + float(dy)) + c)[:, None]
        x0, fx = _lerp_taps(xse - _clip(disp, lo, hi), W)
        return _lerp_gather(src_rows, x0.reshape(K * E, hr, wr),
                            fx.reshape(K * E, hr, wr), False
                            ).reshape(K, E, C, hr, wr)

    return window_grads_cost(ref_chw, abc_k, params,
                             [gather_row(int(dy)) for dy in ys_ext])


# Register-buffer capacities the generic CUDA kernel is instantiated for
# (E <= MAXE).
_MAXE = (4, 8, 16)


def fused_sdg_cost_batch_cuda(ref_chw: torch.Tensor,
                              src_packed: torch.Tensor,
                              abc_k: torch.Tensor, params,
                              disp_bounds: torch.Tensor,
                              hw_valid: torch.Tensor | None = None,
                              tile_ok: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Launch csrc/sdg_fused.cu.  disp_bounds: float32 [2] = (lo, hi) on the
    card, read in-kernel; hw_valid: int32 [2] (valid rows, cols) or None;
    tile_ok: int32 [ceil(Hr/8), Wr/128] or None.  Outputs outside
    hw_valid / tile_ok are unspecified."""
    ch, hr, wr = ref_chw.shape
    C = ch // 3
    K = abc_k.shape[0]
    dev = ref_chw.device
    if C not in (1, 3) or ch != 3 * C:
        raise ValueError(f"sdg_fused: 3C reference channels, C in (1, 3); "
                         f"got {ch}")
    if (src_packed.dtype != torch.int32 or src_packed.shape != (C, hr, wr)
            or ref_chw.dtype != torch.float32
            or abc_k.dtype != torch.float32 or abc_k.shape != (K, 3, hr, wr)):
        raise ValueError("sdg_fused: expected ref f32 [3C,Hr,Wr], src int32 "
                         "[C,Hr,Wr], abc f32 [K,3,Hr,Wr]; got "
                         f"{ref_chw.dtype} {tuple(ref_chw.shape)}, "
                         f"{src_packed.dtype} {tuple(src_packed.shape)}, "
                         f"{abc_k.dtype} {tuple(abc_k.shape)}")
    if (wr % 128 or wr < 2 or wr >= 2 ** 23
            or max(3 * K, ch) * hr * wr >= 2 ** 31):
        raise ValueError(f"sdg_fused: bad rect shape {hr}x{wr} (K={K}): Wr "
                         f"a multiple of 128 below 2^23, 32-bit offsets")
    for t in (ref_chw, src_packed, abc_k, disp_bounds, hw_valid, tile_ok):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError("sdg_fused: contiguous inputs on one device")
    if disp_bounds.dtype != torch.float32 or disp_bounds.numel() != 2:
        raise ValueError("sdg_fused: disp_bounds must be float32 [2]")
    if hw_valid is not None and (hw_valid.dtype != torch.int32
                                 or hw_valid.numel() != 2):
        raise ValueError("sdg_fused: hw_valid must be int32 [2]")
    tm_w = 0
    if tile_ok is not None:
        if (tile_ok.dtype != torch.int32 or tile_ok.shape[1] != wr // 128
                or tile_ok.shape[0] * 8 < hr):
            raise ValueError(f"sdg_fused: tile_ok int32 [ceil(Hr/8), Wr/128],"
                             f" got {tile_ok.dtype} {tuple(tile_ok.shape)}")
        tm_w = tile_ok.shape[1]
    xs_off, rows_c, xs_ext, ys_ext = window_geometry(params)
    E, T = len(xs_ext), len(ys_ext)
    maxe = next((m for m in _MAXE if E <= m), None)
    if maxe is None:
        raise ValueError(f"sdg_fused: {E} window columns exceed the "
                         f"kernel's register buffer ({_MAXE[-1]})")
    inc = params.window_increment
    out = torch.empty((K, hr, wr), dtype=torch.float32, device=dev)
    f = ctypes.c_float
    kernels.launch(
        "sdg_fused_cost", "gtt_sdg_fused_cost", kernels.ptr(ref_chw),
        kernels.ptr(src_packed), kernels.ptr(abc_k), kernels.ptr(disp_bounds),
        kernels.ptr(hw_valid), kernels.ptr(tile_ok), kernels.ptr(out),
        C, maxe, K, hr, wr, tm_w, T, E, len(xs_off),
        params.box_vrad, params.box_hrad, inc,
        int(bool(params.sdg_onesided_edges)),
        f(float(params.alpha)), f(1.0 - float(params.alpha)),
        f(-(1.0 / float(params.gamma)) / C), f(1.0 / C),
        f(float(params.tau_color)), f(float(params.tau_gradient)),
        f((0.0625 / inc) / C), kernels.stream_ptr(dev))
    return out


def fused_sdg_cost_batch(ref_chw: torch.Tensor, src_packed: torch.Tensor,
                         abc_k: torch.Tensor, params,
                         disp_lo=None, disp_hi=None,
                         hw_valid=None, tile_ok=None,
                         disp_bounds: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Fused window_grads cost for K candidates of one rectified pair.

    ref_chw: [3C, Hr, Wr] rectified reference channels (img, gx, gy with
        the step-`window_increment` central-difference operators);
    src_packed: [C, Hr, Wr] int32 packed bilinear tap words (pack_taps);
    abc_k: [K, 3, Hr, Wr] per-candidate affine disparity fields;
    disp_lo / disp_hi (floats or 0-d tensors) or disp_bounds (a float32 [2]
        tensor on the inputs' device, read in-kernel — no host sync):
        the disparity clamp;
    hw_valid: optional int32 [2] (valid rows, valid cols) extent;
    tile_ok: optional int32 [ceil(Hr/8), Wr/128] per-tile target mask.

    Returns [K, Hr, Wr]; outside hw_valid / tile_ok the values are
    unspecified.  The kernel on a CUDA tensor, the plain version on a CPU
    tensor.
    """
    dev = ref_chw.device
    if disp_bounds is None:
        if disp_lo is None or disp_hi is None:
            raise ValueError("fused_sdg_cost_batch needs the disparity clamp")
        disp_bounds = torch.stack([
            torch.as_tensor(disp_lo, dtype=torch.float32, device=dev),
            torch.as_tensor(disp_hi, dtype=torch.float32, device=dev)])
    if dev.type == "cpu":
        return fused_sdg_cost_batch_plain(ref_chw, src_packed, abc_k, params,
                                          disp_bounds[0], disp_bounds[1])
    if hw_valid is not None:
        hw_valid = torch.as_tensor(hw_valid, dtype=torch.int32, device=dev)
    if tile_ok is not None:
        tile_ok = tile_ok.to(torch.int32).contiguous()
    return fused_sdg_cost_batch_cuda(ref_chw, src_packed, abc_k, params,
                                     disp_bounds.to(torch.float32)
                                     .contiguous(), hw_valid, tile_ok)
