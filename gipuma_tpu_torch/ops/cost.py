"""Multiview PatchMatch photoconsistency cost — the exact cost path.

Counterpart of ``gipuma_tpu/ops/cost.py``: the bilaterally weighted,
truncated color + gradient cost (PM) and the census cost on the original
pixel grid (pmCost / censusTransform_Arma_cu, gipuma.cu:223-450), and the
best-n / all / good combination over the view axis (pmCostMultiview_cu,
gipuma.cu:720-806).  The warp is affine in the window offsets before
dehomogenization: warp(p + (dx, dy)) = u + dx*ax + dy*ay.

Layout of one evaluation: for each source view, the warped positions of
all K candidates at all O window offsets are computed at once and sampled
by ONE launch of the bilinear sampler (ops/sampling.py, kernel 3) from the
view's [3C, H, W] (image, gx, gy) channels; the window terms are then
summed over the offset axis.  On a CUDA tensor PM runs the two kernels of
``csrc/exact_cost.cu`` around the sampler, one launch each per (view,
candidate chunk): the warp prologue writes the positions
(exact_warp_coords_cuda, bit-equal to warped_coords), and the window sum
is written in place into the [V, K, H, W2] result; it adds the terms one
at a time in the JAX package's order (dx-even offsets first).  On a CPU
tensor (and for CENSUS everywhere) the torch expressions run instead,
warped_coords and a window sum over the offset axis at once: the latter
rounds in another order (the tests hold costs to 1e-4 abs).  Views run
one after another, so one view's [K, O, H, W2] intermediates are live at
a time.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import torch

from .. import kernels
from ..config import MAXCOST, AlgorithmParams, CostCombination, MatchingAlgorithm
from ..geometry import transforms as T
from . import checkerboard as cb
from .sampling import bilinear_sample

# Samples per view held at once: candidates are evaluated in chunks of at
# most this many K * O * H * W2 positions (the bench scene's K=4 propagation
# at box 11 is 22 M, one chunk).
MAX_SAMPLES = 1 << 25


class ScenePack(NamedTuple):
    """Per-run device state of one reference view.

    Scalars are 0-d tensors on the scene's device, as in the JAX package.
    The exact path's fields (ref_img .. src) are None in a lite scene (the
    rect path reads only the geometry fields)."""

    A: torch.Tensor          # [V, 3, 3] warp constants H p = A r - b (m.r)
    b: torch.Tensor          # [V, 3]
    k1inv_c0: torch.Tensor   # [3] first column of reference K^-1
    k1inv_c1: torch.Tensor   # [3]
    rays: torch.Tensor       # [H, W, 3] K1inv (x, y, 1)
    view_vec: torch.Tensor   # [H, W, 3] unit rays camera->pixel
    fx: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    alpha_focal: torch.Tensor   # fx / fy
    f: torch.Tensor             # disparity-conversion focal (= fx)
    baseline: torch.Tensor      # fake baseline 0.54
    M_inv: torch.Tensor         # [3, 3] reference camera
    P_col4: torch.Tensor        # [3]
    R_orig_inv: torch.Tensor    # [3, 3] reference camera world rotation
    depth_min: torch.Tensor
    depth_max: torch.Tensor
    view_valid: torch.Tensor    # [V] 1.0 real view / 0.0 padding
    texture_ok: torch.Tensor    # [H, W] bool
    row_offset: torch.Tensor    # int32 0-d: first image row (0 unsharded)
    global_h: torch.Tensor      # int32 0-d: image height
    # Reference image and its central gradients, edge-padded by (box_vrad,
    # box_hrad + 2) and split even/odd for window reads (PaddedEO of
    # [H, W, C] each).
    ref_img: cb.PaddedEO = None
    ref_gx: cb.PaddedEO = None
    ref_gy: cb.PaddedEO = None
    # Source views' (image, gx, gy) channels, [V, 3C, H, W] f32: the
    # sampler's layout (the JAX package keeps a 4-tap table and a 128-column
    # block split instead, for the TPU's gathers).
    src: torch.Tensor = None

    @property
    def num_views(self) -> int:
        return self.A.shape[0]

    @property
    def channels(self) -> int:
        return self.src.shape[1] // 3


def _l1(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Channel-mean absolute value (l1_norm, gipuma.cu:171-179)."""
    return x.abs().mean(dim)


def _census_bits(center, value, eps):
    """3-way intensity classification (getCTbit_cu, gipuma.cu:362-369):
    0 if center - value > eps, 2 if value - center > eps, else 1 (int8)."""
    one = torch.ones((), dtype=torch.int8, device=value.device)
    return torch.where(center - value > eps, 0 * one,
                       torch.where(value - center > eps, 2 * one, one))


def window_offsets(params: AlgorithmParams) -> list[tuple[int, int]]:
    """(dx, dy) offsets of the cost window: PM samples every
    window_increment-th pixel; CENSUS the full window at increment 1 with
    the center left out (gipuma.cu:435-439)."""
    if params.algorithm == MatchingAlgorithm.CENSUS:
        return [(dx, dy)
                for dx in range(-params.box_hrad, params.box_hrad + 1)
                for dy in range(-params.box_vrad, params.box_vrad + 1)
                if not (dx == 0 and dy == 0)]
    return params.window_offsets()


class _Warp(NamedTuple):
    """Per-candidate plane terms of one parity's active half-grid."""
    rays: torch.Tensor   # [H, W2, 3]
    mr: torch.Tensor     # [K, H, W2]  m . r
    mc0: torch.Tensor    # [K, H, W2]  m . K1inv[:, 0]
    mc1: torch.Tensor


def _plane_terms(scene: ScenePack, parity: int, n: torch.Tensor,
                 d: torch.Tensor) -> _Warp:
    rays = cb.extract(scene.rays, parity)
    m = n / d[..., None]                                  # plane vector n/d
    return _Warp(rays=rays, mr=(m * rays).sum(-1),
                 mc0=(m * scene.k1inv_c0).sum(-1),
                 mc1=(m * scene.k1inv_c1).sum(-1))


def _center(scene: ScenePack, v: int, warp: _Warp) -> torch.Tensor:
    """u [K, H, W2, 3]: the homogeneous warp of each window center."""
    return T._matvec(scene.A[v], warp.rays)[None] \
        - scene.b[v] * warp.mr[..., None]


@functools.lru_cache(maxsize=64)
def _offset_axes(offsets: tuple, dtype: torch.dtype, dev: torch.device):
    """The window offsets' dx and dy as [1, O, 1, 1] tensors on `dev`, made
    once per (offsets, dtype, device): a later evaluation copies nothing
    from the host, so a CUDA graph can capture it."""
    dxs = torch.tensor([o[0] for o in offsets], dtype=dtype, device=dev)
    dys = torch.tensor([o[1] for o in offsets], dtype=dtype, device=dev)
    return dxs[None, :, None, None], dys[None, :, None, None]


def warped_coords(scene: ScenePack, v: int, warp: _Warp, offsets
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Source-view-v positions of every candidate's window: (xw, yw), each
    [K * O, H, W2] (candidate-major), pos = (u + dx*ax) + dy*ay then
    dehomogenized, as the JAX package computes each offset's."""
    Av, bv = scene.A[v], scene.b[v]
    u = _center(scene, v, warp)
    ax = T._matvec(Av, scene.k1inv_c0) - bv * warp.mc0[..., None]
    ay = T._matvec(Av, scene.k1inv_c1) - bv * warp.mc1[..., None]
    dxs, dys = _offset_axes(tuple(map(tuple, offsets)), u.dtype, u.device)

    def comp(i):
        return (u[:, None, ..., i] + dxs * ax[:, None, ..., i]) \
            + dys * ay[:, None, ..., i]                     # [K, O, H, W2]

    pz = comp(2)
    xw = comp(0) / pz
    yw = comp(1) / pz
    K, O = xw.shape[:2]
    return xw.reshape((K * O,) + xw.shape[2:]), \
        yw.reshape((K * O,) + yw.shape[2:])


@functools.lru_cache(maxsize=64)
def _warp_table(offsets: tuple, dev: torch.device) -> torch.Tensor:
    """f32 [O, 2] (dx, dy) in the sampled list's order: the warp kernel's
    offsets, made once per (offsets, device), like _offset_axes."""
    return torch.tensor(offsets, dtype=torch.float32, device=dev)


def view_warp_terms(scene: ScenePack, v: int, rays: torch.Tensor) -> tuple:
    """View v's share of warped_coords, the same for every candidate: (A r
    [H, W2, 3], A K1inv[:, 0], A K1inv[:, 1]), each as warped_coords
    computes it."""
    Av = scene.A[v]
    return (T._matvec(Av, rays), T._matvec(Av, scene.k1inv_c0),
            T._matvec(Av, scene.k1inv_c1))


def _checked(what: str, named, ints=()) -> None:
    """Refuse a kernel argument by name: f32 (int32 for `ints`) and
    contiguous."""
    for name, t in named:
        want = torch.int32 if name in ints else torch.float32
        if t.dtype != want:
            raise TypeError(f"{what}: {name} must be {want}, got {t.dtype}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _on_card(what: str, named) -> None:
    """Refuse a kernel argument by name that is not on the first one's
    CUDA device."""
    first, dev = named[0][0], named[0][1].device
    for name, t in named:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: {name} must be on the {first}'s CUDA "
                             f"device, got {t.device}")


def exact_warp_coords_cuda(ar: torch.Tensor, ac0: torch.Tensor,
                           ac1: torch.Tensor, b: torch.Tensor,
                           mr: torch.Tensor, mc0: torch.Tensor,
                           mc1: torch.Tensor, table: torch.Tensor,
                           xw: torch.Tensor, yw: torch.Tensor) -> None:
    """Launch csrc/exact_cost.cu's warp prologue: xw, yw [kc * O, H, W2]
    (candidate-major) = warped_coords of one view, from its terms ar [H,
    W2, 3], ac0, ac1 (view_warp_terms) and b [3] (scene.b[v]), the
    candidates' plane terms mr, mc0, mc1 [kc, H, W2] (_plane_terms) and
    the offsets table [O, 2] (_warp_table).  Bit-equal to warped_coords;
    written in place, on the current stream."""
    what = "exact_warp_coords"
    named = (("ar", ar), ("ac0", ac0), ("ac1", ac1), ("b", b), ("mr", mr),
             ("mc0", mc0), ("mc1", mc1), ("table", table), ("xw", xw),
             ("yw", yw))
    _checked(what, named)
    if mr.dim() != 3:
        raise ValueError(f"{what}: mr {tuple(mr.shape)} is not [kc, H, W2]")
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"{what}: table {tuple(table.shape)} is not [O, 2] "
                         f"with O >= 1")
    (kc, H, W2), O = mr.shape, table.shape[0]
    want = {"ar": (H, W2, 3), "ac0": (3,), "ac1": (3,), "b": (3,),
            "mr": (kc, H, W2), "mc0": (kc, H, W2), "mc1": (kc, H, W2),
            "table": (O, 2), "xw": (kc * O, H, W2), "yw": (kc * O, H, W2)}
    for name, t in named:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} is not "
                             f"{list(want[name])}")
    _on_card(what, named)
    if kc == 0:
        return
    rc = _warp_fn()(*(kernels.ptr(t) for _, t in named), kc, O, H, W2,
                    kernels.stream_ptr(mr.device))
    kernels.check(rc, what)
    kernels.counts["exact_warp_coords"] += 1


def _guard(acc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Invalid-view guard (gipuma.cu:770-775): NaN or >= MAXCOST; padded
    views (valid == 0) are always invalid."""
    return torch.where(torch.isnan(acc) | (acc >= MAXCOST) | (valid == 0.0),
                       MAXCOST, acc)


def pm_reference_terms(scene: ScenePack, params: AlgorithmParams, offsets,
                       parity: int) -> tuple:
    """The reference side of the PM window sum, the same for every view and
    candidate: (wgt [O, H, W2], ref [O, C, H, W2], gx, gy)."""
    ref_win = scene.ref_img.windows(offsets, parity)         # [O, H, W2, C]
    ref_center = scene.ref_img.shifted(0, 0, parity)         # [H, W2, C]
    # Bilateral weight (weight_cu, gipuma.cu:186-193): reference only.
    wgt = torch.exp(-_l1(ref_win - ref_center, -1) * (1.0 / params.gamma))
    return (wgt, ref_win.permute(0, 3, 1, 2),
            scene.ref_gx.windows(offsets, parity).permute(0, 3, 1, 2),
            scene.ref_gy.windows(offsets, parity).permute(0, 3, 1, 2))


def pm_window_cost_plain(smp: torch.Tensor, terms: tuple,
                         params: AlgorithmParams, valid: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version of ``csrc/exact_cost.cu``: the guarded PM window sum
    [kc, H, W2] of one view's samples smp [kc * O, 3C, H, W2] (the
    sampler's output) against `terms` (pm_reference_terms); `valid` is the
    view's view_valid entry."""
    wgt, ref_win, ref_gx, ref_gy = terms
    O, C = ref_win.shape[:2]
    smp = smp.reshape((-1, O) + smp.shape[1:])
    a = params.alpha
    col = _l1(ref_win - smp[:, :, :C], 2).clamp(max=params.tau_color)
    grad = ((_l1(ref_gx - smp[:, :, C:2 * C], 2)
             + _l1(ref_gy - smp[:, :, 2 * C:], 2)) * 0.0625
            ).clamp(max=params.tau_gradient)
    return _guard((wgt * ((1.0 - a) * col + a * grad)).sum(1), valid)


# PaddedEO -> its even and odd column planes as one contiguous
# [2, H + 2pr, W2 + pc, C] tensor, made once per PaddedEO (per scene).
_REF_PLANES = weakref.WeakKeyDictionary()


def _ref_planes(eo: cb.PaddedEO) -> torch.Tensor:
    planes = _REF_PLANES.get(eo)
    if planes is None:
        planes = torch.stack([eo.E, eo.O]).contiguous()
        _REF_PLANES[eo] = planes
    return planes


@functools.lru_cache(maxsize=64)
def _offset_table(offsets: tuple, dev: torch.device) -> torch.Tensor:
    """int32 [O, 3] (dx, dy, o) in the JAX package's summation order: the
    offsets grouped by dx parity, even first, each group in list order; o
    is the offset's place in `offsets` (the sampler's order).  Made once
    per (offsets, device), like _offset_axes."""
    order = sorted(range(len(offsets)), key=lambda o: offsets[o][0] % 2)
    return torch.tensor([(offsets[o][0], offsets[o][1], o) for o in order],
                        dtype=torch.int32, device=dev)


def exact_window_cost_cuda(smp: torch.Tensor, ref: torch.Tensor,
                           gx: torch.Tensor, gy: torch.Tensor,
                           table: torch.Tensor, view_valid: torch.Tensor,
                           v: int, out: torch.Tensor, parity: int, pr: int,
                           pc: int, params: AlgorithmParams) -> None:
    """Launch csrc/exact_cost.cu: out [kc, H, W2] = the guarded PM window
    sum of view v's samples smp [kc * O, 3C, H, W2] against the reference
    planes ref, gx, gy [2, H + 2pr, W2 + pc, C] (_ref_planes), over the
    offsets of table [O, 3] (_offset_table).  Same contract as
    pm_window_cost_plain; written in place, on the current stream."""
    named = (("smp", smp), ("ref", ref), ("gx", gx), ("gy", gy),
             ("table", table), ("view_valid", view_valid), ("out", out))
    _checked("exact_window_cost", named, ints=("table",))
    O = table.shape[0]
    if smp.dim() != 4 or smp.shape[1] % 3 or O < 1 or smp.shape[0] % O:
        raise ValueError(f"exact_window_cost: samples {tuple(smp.shape)} "
                         f"are not [kc * {O}, 3C, H, W2]")
    kc, C, (H, W2) = smp.shape[0] // O, smp.shape[1] // 3, smp.shape[2:]
    if ref.shape != gx.shape or ref.shape != gy.shape or ref.dim() != 4 \
            or ref.shape[0] != 2 or ref.shape[1] != H + 2 * pr \
            or ref.shape[2] != W2 + pc or ref.shape[3] != C:
        raise ValueError(f"exact_window_cost: reference planes "
                         f"{tuple(ref.shape)}, {tuple(gx.shape)}, "
                         f"{tuple(gy.shape)} are not [2, {H + 2 * pr}, "
                         f"{W2 + pc}, {C}]")
    if tuple(out.shape) != (kc, H, W2) or not 0 <= v < view_valid.numel():
        raise ValueError(f"exact_window_cost: out {tuple(out.shape)} is not "
                         f"[{kc}, {H}, {W2}] or view {v} is out of range")
    _on_card("exact_window_cost", named)
    if kc == 0:
        return
    rc = _cuda_fn()(kernels.ptr(smp), kernels.ptr(ref), kernels.ptr(gx),
                    kernels.ptr(gy), kernels.ptr(table),
                    kernels.ptr(view_valid), kernels.ptr(out), kc, O, C, H,
                    W2, ref.shape[1], ref.shape[2], pr, pc, parity, v,
                    1.0 - params.alpha, params.alpha, 1.0 / params.gamma,
                    params.tau_color, params.tau_gradient, MAXCOST,
                    kernels.stream_ptr(smp.device))
    kernels.check(rc, "exact_window_cost")
    kernels.counts["exact_window_cost"] += 1


_FN = None
_WARP_FN = None


def _cuda_fn():
    global _FN
    if _FN is None:
        fn = kernels.library("exact_cost").gtt_exact_window_cost
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 7 + [ci] * 11 + [cf] * 6 + [vp]
        fn.restype = ci
        _FN = fn
    return _FN


def _warp_fn():
    global _WARP_FN
    if _WARP_FN is None:
        fn = kernels.library("exact_cost").gtt_exact_warp_coords
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 10 + [ci] * 4 + [vp]
        fn.restype = ci
        _WARP_FN = fn
    return _WARP_FN


def exact_window_inputs(scene: ScenePack, offsets, dev: torch.device
                        ) -> tuple:
    """The kernel's reference inputs for `offsets`: the planes of ref_img,
    ref_gx and ref_gy (_ref_planes) and the offset table (_offset_table).
    The window must fit the reference's padding (|dx| <= pc, |dy| <= pr),
    as PaddedEO.shifted needs."""
    eo = scene.ref_img
    offsets = tuple(map(tuple, offsets))
    if max(abs(dx) for dx, _ in offsets) > eo.pc \
            or max(abs(dy) for _, dy in offsets) > eo.pr:
        raise ValueError(f"exact_window_cost: the window exceeds the "
                         f"reference padding (pr {eo.pr}, pc {eo.pc})")
    return (_ref_planes(eo), _ref_planes(scene.ref_gx),
            _ref_planes(scene.ref_gy), _offset_table(offsets, dev))


def per_view_costs_batch(scene: ScenePack, params: AlgorithmParams,
                         parity: int, n: torch.Tensor, d: torch.Tensor
                         ) -> torch.Tensor:
    """Costs of K plane hypotheses against each source view.

    n: [K, H, W2, 3], d: [K, H, W2] on the parity's active half-grid.
    Returns [V, K, H, W2] with invalid (NaN / overflow / padded-view)
    entries at MAXCOST (gipuma.cu:770-775).  PM on a CUDA tensor takes the
    warp kernel (exact_warp_coords_cuda) and the window-sum kernel
    (exact_window_cost_cuda); a CPU tensor, and CENSUS, the torch
    expressions."""
    if scene.src is None:
        raise ValueError("per_view_costs needs a full scene "
                         "(build_scene(lite=False))")
    C = scene.channels
    census = params.algorithm == MatchingAlgorithm.CENSUS
    on_kernel = d.is_cuda and not census
    offsets = window_offsets(params)
    O = len(offsets)
    K, h, w2 = d.shape
    if census:
        ref_win = scene.ref_img.windows(offsets, parity)     # [O, H, W2, C]
        ref_center_m = scene.ref_img.shifted(0, 0, parity).mean(-1)
        bit_l = _census_bits(ref_center_m, ref_win.mean(-1),
                             params.census_epsilon)          # [O, H, W2]
    elif on_kernel:
        ref, gx, gy, table = exact_window_inputs(scene, offsets, d.device)
    else:
        terms = pm_reference_terms(scene, params, offsets, parity)

    chunk = max(1, MAX_SAMPLES // max(1, O * h * w2))
    warps = [_plane_terms(scene, parity, n[k0:k0 + chunk], d[k0:k0 + chunk])
             for k0 in range(0, K, chunk)]
    if on_kernel:
        # One unit's positions, a buffer every (view, chunk) reuses: the
        # sampler reads it before the next unit's warp writes it (one
        # stream).
        offs = _warp_table(tuple(map(tuple, offsets)), d.device)
        coords = d.new_empty((2, min(chunk, K) * O, h, w2))
    out = d.new_empty((scene.num_views, K, h, w2))
    for v in range(scene.num_views):
        # Census reads only the image channels; PM all 3C.
        src_v = scene.src[v, :C] if census else scene.src[v]
        if on_kernel:
            ar, ac0, ac1 = view_warp_terms(scene, v, warps[0].rays)
        for k0, warp in zip(range(0, K, chunk), warps):
            kc = warp.mr.shape[0]
            if on_kernel:
                xw, yw = coords[:, :kc * O]
                exact_warp_coords_cuda(ar, ac0, ac1, scene.b[v], warp.mr,
                                       warp.mc0, warp.mc1, offs, xw, yw)
            else:
                xw, yw = warped_coords(scene, v, warp, offsets)
            smp = bilinear_sample(src_v, xw, yw)              # [kc*O, *, H, W2]
            dst = out[v, k0:k0 + kc]
            if on_kernel:
                exact_window_cost_cuda(smp, ref, gx, gy, table,
                                       scene.view_valid, v, dst, parity,
                                       scene.ref_img.pr, scene.ref_img.pc,
                                       params)
            elif census:
                smp = smp.reshape((kc, O) + smp.shape[1:])
                # Warped center intensity (censusTransform_Arma_cu:429-430).
                u = _center(scene, v, warp)
                src_center = bilinear_sample(src_v, u[..., 0] / u[..., 2],
                                             u[..., 1] / u[..., 2]).mean(1)
                bit_r = _census_bits(src_center[:, None], smp.mean(2),
                                     params.census_epsilon)
                acc = (bit_l[None] != bit_r).to(d.dtype).sum(1)
                dst.copy_(_guard(acc, scene.view_valid[v]))
            else:
                dst.copy_(pm_window_cost_plain(smp, terms, params,
                                               scene.view_valid[v]))
    return out


def per_view_costs(scene: ScenePack, params: AlgorithmParams, parity: int,
                   n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Costs of plane hypothesis (n [H, W2, 3], d [H, W2]) against each
    source view: [V, H, W2]."""
    return per_view_costs_batch(scene, params, parity, n[None], d[None])[:, 0]


def combine_view_costs(costs: torch.Tensor, params: AlgorithmParams,
                       view_valid: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Best-n / good / all combination over the view axis of costs [V, ...]
    (invalid views already at MAXCOST).  GOOD divides by the REAL subset
    size (view_valid counts padded slots out, gipuma.cu:785-786)."""
    V = costs.shape[0]
    num_valid = (costs < MAXCOST).to(torch.int32).sum(0)
    csort = torch.sort(costs, dim=0).values

    if params.cost_comb == CostCombination.BEST_N:
        num_best = torch.clamp(num_valid, max=params.n_best)
    elif params.cost_comb == CostCombination.ALL:
        num_best = num_valid
    elif params.cost_comb == CostCombination.GOOD:
        if view_valid is None:
            n_real = torch.full((), V, dtype=torch.int32,
                                device=costs.device)
        else:
            n_real = view_valid.to(torch.int32).sum()
        num_best = torch.zeros_like(num_valid) + n_real
        csort = torch.minimum(csort, csort[0] * params.good_factor)
    else:
        raise NotImplementedError(f"cost_comb={params.cost_comb}")

    rank = torch.arange(V, dtype=torch.int32, device=costs.device).reshape(
        (V,) + (1,) * (costs.ndim - 1))
    total = torch.where(rank < num_best, csort, 0.0).sum(0)
    cost = total / torch.clamp(num_best, min=1).to(costs.dtype)
    cost = torch.where(num_best < 1, MAXCOST, cost)
    bad = torch.isnan(cost) | (cost > MAXCOST) | (cost < 0.0)
    return torch.where(bad, MAXCOST, cost)


def multiview_cost(scene: ScenePack, params: AlgorithmParams, parity: int,
                   n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Full pmCostMultiview: per-view costs then combination. [H, W2]."""
    return combine_view_costs(per_view_costs(scene, params, parity, n, d),
                              params, view_valid=scene.view_valid)


def multiview_cost_batch(scene: ScenePack, params: AlgorithmParams,
                         parity: int, n: torch.Tensor, d: torch.Tensor,
                         cand_ok: torch.Tensor | None = None,
                         cur: tuple | None = None) -> torch.Tensor:
    """multiview_cost of K stacked candidates: [K, H, W2].  Each
    candidate's cost is independent of the others', so this equals K calls
    of multiview_cost (cand_ok and cur serve only the rect path's cull)."""
    del cand_ok, cur
    return combine_view_costs(
        per_view_costs_batch(scene, params, parity, n, d), params,
        view_valid=scene.view_valid)


# The engine evaluates propagation candidates through `batch`
# (models/patchmatch._fold_better).  Refinement rounds stay sequential for
# this cost: the JAX package batches them only for the rect cost
# (config.refine_batched), see `batched_refinement`.
multiview_cost.batch = multiview_cost_batch
multiview_cost.batched_refinement = False
