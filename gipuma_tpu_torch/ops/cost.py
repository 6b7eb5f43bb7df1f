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
summed over the offset axis.  PM runs one loop over (view, candidate
chunk) of three ops, each the kernel on a CUDA tensor and its plain
version on a CPU tensor: the warp (exact_warp_coords; csrc/exact_cost.cu's
prologue, bit-equal to warped_coords), the sampler, and the window sum
(pm_window_cost; csrc/exact_cost.cu's epilogue, written in place into the
[V, K, H, W2] result).  The kernel adds the window terms one at a time in
the JAX package's order (dx-even offsets first); the plain version sums
over the offset axis at once, in another order (the tests hold costs to
1e-4 abs).  CENSUS runs the torch expressions on either device.  Views run
one after another, so one view's [K, O, H, W2] intermediates are live at
a time.
"""
from __future__ import annotations

import functools
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


def window_offsets(params: AlgorithmParams) -> tuple:
    """(dx, dy) offsets of the cost window, a tuple (it keys the offset
    tables): PM samples every window_increment-th pixel; CENSUS the full
    window at increment 1 with the center left out (gipuma.cu:435-439)."""
    if params.algorithm == MatchingAlgorithm.CENSUS:
        return tuple((dx, dy)
                     for dx in range(-params.box_hrad, params.box_hrad + 1)
                     for dy in range(-params.box_vrad, params.box_vrad + 1)
                     if not (dx == 0 and dy == 0))
    return tuple(params.window_offsets())


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
def offset_tables(offsets: tuple, dev: torch.device) -> tuple:
    """The window offsets (window_offsets' tuple) as the exact path reads
    them, made once per (offsets, device): a later evaluation copies
    nothing from the host, so a CUDA graph can capture it.  f32 [O, 2] (dx,
    dy) in the sampled list's order (the warp), and int32 [O, 3] (dx, dy,
    o) in the JAX package's summation order (the window sum): the offsets
    grouped by dx parity, even first, each group in list order, o the
    offset's place in `offsets`."""
    order = sorted(range(len(offsets)), key=lambda o: offsets[o][0] % 2)
    return (torch.tensor(offsets, dtype=torch.float32, device=dev),
            torch.tensor([(offsets[o][0], offsets[o][1], o) for o in order],
                         dtype=torch.int32, device=dev))


def warped_coords(scene: ScenePack, v: int, warp: _Warp, offsets
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Source-view-v positions of every candidate's window: (xw, yw), each
    [K * O, H, W2] (candidate-major), pos = (u + dx*ax) + dy*ay then
    dehomogenized, as the JAX package computes each offset's."""
    Av, bv = scene.A[v], scene.b[v]
    u = _center(scene, v, warp)
    ax = T._matvec(Av, scene.k1inv_c0) - bv * warp.mc0[..., None]
    ay = T._matvec(Av, scene.k1inv_c1) - bv * warp.mc1[..., None]
    table = offset_tables(offsets, u.device)[0]
    dxs, dys = table[:, 0, None, None], table[:, 1, None, None]  # [O, 1, 1]

    def comp(i):
        return (u[:, None, ..., i] + dxs * ax[:, None, ..., i]) \
            + dys * ay[:, None, ..., i]                     # [K, O, H, W2]

    pz = comp(2)
    xw = comp(0) / pz
    yw = comp(1) / pz
    K, O = xw.shape[:2]
    return xw.reshape((K * O,) + xw.shape[2:]), \
        yw.reshape((K * O,) + yw.shape[2:])


def view_warp_terms(scene: ScenePack, v: int, rays: torch.Tensor) -> tuple:
    """View v's share of warped_coords, the same for every candidate: (A r
    [H, W2, 3], A K1inv[:, 0], A K1inv[:, 1]), each as warped_coords
    computes it."""
    Av = scene.A[v]
    return (T._matvec(Av, rays), T._matvec(Av, scene.k1inv_c0),
            T._matvec(Av, scene.k1inv_c1))


def exact_warp_coords_plain(ar: torch.Tensor, ac0: torch.Tensor,
                            ac1: torch.Tensor, b: torch.Tensor,
                            mr: torch.Tensor, mc0: torch.Tensor,
                            mc1: torch.Tensor, table: torch.Tensor,
                            xw: torch.Tensor, yw: torch.Tensor) -> None:
    """Plain version of csrc/exact_cost.cu's warp prologue: the kernel's
    arithmetic in torch, term by term in its order, from its arguments
    (exact_warp_coords_cuda), written into xw, yw.  Bit-equal to
    warped_coords."""
    u = ar[None] - b * mr[..., None]                      # [kc, H, W2, 3]
    ax = ac0 - b * mc0[..., None]
    ay = ac1 - b * mc1[..., None]
    dx, dy = table[:, 0, None, None], table[:, 1, None, None]  # [O, 1, 1]

    def comp(i):
        return (u[:, None, ..., i] + dx * ax[:, None, ..., i]) \
            + dy * ay[:, None, ..., i]                     # [kc, O, H, W2]

    pz = comp(2)
    shape = pz.shape
    torch.div(comp(0), pz, out=xw.view(shape))
    torch.div(comp(1), pz, out=yw.view(shape))


def exact_warp_coords_cuda(ar: torch.Tensor, ac0: torch.Tensor,
                           ac1: torch.Tensor, b: torch.Tensor,
                           mr: torch.Tensor, mc0: torch.Tensor,
                           mc1: torch.Tensor, table: torch.Tensor,
                           xw: torch.Tensor, yw: torch.Tensor) -> None:
    """Launch csrc/exact_cost.cu's warp prologue: same contract as the
    plain version; on the current stream."""
    what = "exact_warp_coords"
    named = (("ar", ar), ("ac0", ac0), ("ac1", ac1), ("b", b), ("mr", mr),
             ("mc0", mc0), ("mc1", mc1), ("table", table), ("xw", xw),
             ("yw", yw))
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
    kernels.check_args(what, named)
    if kc == 0:
        return
    kernels.launch(what, "gtt_exact_warp_coords",
                   *(kernels.ptr(t) for _, t in named), kc, O, H, W2,
                   kernels.stream_ptr(mr.device))


def exact_warp_coords(ar: torch.Tensor, ac0: torch.Tensor,
                      ac1: torch.Tensor, b: torch.Tensor, mr: torch.Tensor,
                      mc0: torch.Tensor, mc1: torch.Tensor,
                      table: torch.Tensor, xw: torch.Tensor,
                      yw: torch.Tensor) -> None:
    """The warp op: xw, yw [kc * O, H, W2] (candidate-major) = warped_coords
    of one view, from its terms ar [H, W2, 3], ac0, ac1 (view_warp_terms)
    and b [3] (scene.b[v]), the candidates' plane terms mr, mc0, mc1 [kc,
    H, W2] (_plane_terms) and the f32 offset table [O, 2] (offset_tables),
    written in place.  The kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    warp = exact_warp_coords_plain if xw.device.type == "cpu" \
        else exact_warp_coords_cuda
    warp(ar, ac0, ac1, b, mr, mc0, mc1, table, xw, yw)


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


def exact_window_inputs(scene: ScenePack, offsets, dev: torch.device
                        ) -> tuple:
    """The window-sum kernel's reads for `offsets` (window_offsets' tuple):
    the planes of ref_img, ref_gx and ref_gy (PaddedEO.planes, which
    refuses a window past the padding) and the int32 offset table
    (offset_tables)."""
    return (scene.ref_img.planes(offsets), scene.ref_gx.planes(offsets),
            scene.ref_gy.planes(offsets), offset_tables(offsets, dev)[1])


def exact_window_cost_cuda(smp: torch.Tensor, ref: torch.Tensor,
                           gx: torch.Tensor, gy: torch.Tensor,
                           table: torch.Tensor, view_valid: torch.Tensor,
                           v: int, out: torch.Tensor, parity: int, pr: int,
                           pc: int, params: AlgorithmParams) -> None:
    """Launch csrc/exact_cost.cu: out [kc, H, W2] = the guarded PM window
    sum of view v's samples smp [kc * O, 3C, H, W2] against the reference
    planes ref, gx, gy [2, H + 2pr, W2 + pc, C] over the offsets of table
    [O, 3] (exact_window_inputs).  Same contract as pm_window_cost_plain;
    written in place, on the current stream."""
    what = "exact_window_cost"
    O = table.shape[0]
    if smp.dim() != 4 or smp.shape[1] % 3 or O < 1 or smp.shape[0] % O:
        raise ValueError(f"{what}: samples {tuple(smp.shape)} are not "
                         f"[kc * {O}, 3C, H, W2]")
    kc, C, (H, W2) = smp.shape[0] // O, smp.shape[1] // 3, smp.shape[2:]
    if ref.shape != gx.shape or ref.shape != gy.shape or ref.dim() != 4 \
            or ref.shape[0] != 2 or ref.shape[1] != H + 2 * pr \
            or ref.shape[2] != W2 + pc or ref.shape[3] != C:
        raise ValueError(f"{what}: reference planes {tuple(ref.shape)}, "
                         f"{tuple(gx.shape)}, {tuple(gy.shape)} are not "
                         f"[2, {H + 2 * pr}, {W2 + pc}, {C}]")
    if tuple(out.shape) != (kc, H, W2) or not 0 <= v < view_valid.numel():
        raise ValueError(f"{what}: out {tuple(out.shape)} is not "
                         f"[{kc}, {H}, {W2}] or view {v} is out of range")
    kernels.check_args(what, (("smp", smp), ("ref", ref), ("gx", gx),
                              ("gy", gy), ("table", table),
                              ("view_valid", view_valid), ("out", out)),
                       ints=("table",))
    if kc == 0:
        return
    kernels.launch(what, "gtt_exact_window_cost", kernels.ptr(smp),
                   kernels.ptr(ref), kernels.ptr(gx), kernels.ptr(gy),
                   kernels.ptr(table), kernels.ptr(view_valid),
                   kernels.ptr(out), kc, O, C, H, W2, ref.shape[1],
                   ref.shape[2], pr, pc, parity, v, 1.0 - params.alpha,
                   params.alpha, 1.0 / params.gamma, params.tau_color,
                   params.tau_gradient, MAXCOST,
                   kernels.stream_ptr(smp.device))


class PMWindow(NamedTuple):
    """What one call's PM window sums read besides the samples, built once
    before its loop (pm_window).  `reads`: on a CUDA device the reference
    planes and the int32 offset table (exact_window_inputs), on the CPU
    pm_reference_terms."""
    reads: tuple
    scene: ScenePack
    params: AlgorithmParams
    parity: int


def pm_window(scene: ScenePack, params: AlgorithmParams, offsets,
              parity: int, dev: torch.device) -> PMWindow:
    """The PMWindow of one call on device `dev`."""
    reads = pm_reference_terms(scene, params, offsets, parity) \
        if dev.type == "cpu" else exact_window_inputs(scene, offsets, dev)
    return PMWindow(reads, scene, params, parity)


def pm_window_cost(smp: torch.Tensor, win: PMWindow, v: int,
                   out: torch.Tensor) -> None:
    """The window op: out [kc, H, W2] = the guarded PM window sum of view
    v's samples smp [kc * O, 3C, H, W2] (the sampler's output), written in
    place.  The kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    sc = win.scene
    if out.device.type == "cpu":
        out.copy_(pm_window_cost_plain(smp, win.reads, win.params,
                                       sc.view_valid[v]))
    else:
        exact_window_cost_cuda(smp, *win.reads, sc.view_valid, v, out,
                               win.parity, sc.ref_img.pr, sc.ref_img.pc,
                               win.params)


def _plane_chunks(scene: ScenePack, parity: int, n: torch.Tensor,
                  d: torch.Tensor, O: int) -> list:
    """(k0, plane terms) of each chunk of the K candidates: at most
    MAX_SAMPLES positions (kc * O * H * W2) a chunk, one candidate at
    least."""
    K, h, w2 = d.shape
    chunk = max(1, MAX_SAMPLES // max(1, O * h * w2))
    return [(k0, _plane_terms(scene, parity, n[k0:k0 + chunk],
                              d[k0:k0 + chunk]))
            for k0 in range(0, K, chunk)]


def _census_costs(scene: ScenePack, params: AlgorithmParams, parity: int,
                  n: torch.Tensor, d: torch.Tensor, offsets) -> torch.Tensor:
    """per_view_costs_batch for CENSUS: the torch expressions on either
    device (warped_coords, the sampler on the image channels, the census
    bits of the window against its center)."""
    C, O = scene.channels, len(offsets)
    ref_win = scene.ref_img.windows(offsets, parity)         # [O, H, W2, C]
    ref_center_m = scene.ref_img.shifted(0, 0, parity).mean(-1)
    bit_l = _census_bits(ref_center_m, ref_win.mean(-1),
                         params.census_epsilon)              # [O, H, W2]
    chunks = _plane_chunks(scene, parity, n, d, O)
    out = d.new_empty((scene.num_views,) + tuple(d.shape))
    for v in range(scene.num_views):
        src_v = scene.src[v, :C]
        for k0, warp in chunks:
            kc = warp.mr.shape[0]
            xw, yw = warped_coords(scene, v, warp, offsets)
            smp = bilinear_sample(src_v, xw, yw)
            smp = smp.reshape((kc, O) + smp.shape[1:])
            # Warped center intensity (censusTransform_Arma_cu:429-430).
            u = _center(scene, v, warp)
            src_center = bilinear_sample(src_v, u[..., 0] / u[..., 2],
                                         u[..., 1] / u[..., 2]).mean(1)
            bit_r = _census_bits(src_center[:, None], smp.mean(2),
                                 params.census_epsilon)
            acc = (bit_l[None] != bit_r).to(d.dtype).sum(1)
            out[v, k0:k0 + kc].copy_(_guard(acc, scene.view_valid[v]))
    return out


def per_view_costs_batch(scene: ScenePack, params: AlgorithmParams,
                         parity: int, n: torch.Tensor, d: torch.Tensor
                         ) -> torch.Tensor:
    """Costs of K plane hypotheses against each source view.

    n: [K, H, W2, 3], d: [K, H, W2] on the parity's active half-grid.
    Returns [V, K, H, W2] with invalid (NaN / overflow / padded-view)
    entries at MAXCOST (gipuma.cu:770-775).  PM runs three ops per (view,
    candidate chunk), each the kernel on a CUDA tensor and the plain
    version on a CPU tensor: the warp (exact_warp_coords), the sampler
    (bilinear_sample) and the window sum (pm_window_cost).  CENSUS runs
    the torch expressions (_census_costs)."""
    if scene.src is None:
        raise ValueError("per_view_costs needs a full scene "
                         "(build_scene(lite=False))")
    offsets = window_offsets(params)
    if params.algorithm == MatchingAlgorithm.CENSUS:
        return _census_costs(scene, params, parity, n, d, offsets)
    O = len(offsets)
    win = pm_window(scene, params, offsets, parity, d.device)
    chunks = _plane_chunks(scene, parity, n, d, O)
    table = offset_tables(offsets, d.device)[0]
    # One unit's positions, a buffer every (view, chunk) reuses: the
    # sampler reads it before the next unit's warp writes it (one stream).
    coords = d.new_empty((2, chunks[0][1].mr.shape[0] * O) + d.shape[1:])
    out = d.new_empty((scene.num_views,) + tuple(d.shape))
    for v in range(scene.num_views):
        ar, ac0, ac1 = view_warp_terms(scene, v, chunks[0][1].rays)
        for k0, warp in chunks:
            kc = warp.mr.shape[0]
            xw, yw = coords[:, :kc * O]
            exact_warp_coords(ar, ac0, ac1, scene.b[v], warp.mr, warp.mc0,
                              warp.mc1, table, xw, yw)
            pm_window_cost(bilinear_sample(scene.src[v], xw, yw), win, v,
                           out[v, k0:k0 + kc])
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
