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
summed over the offset axis.  The JAX package scans the offsets and adds
the terms one at a time (dx-even offsets first); the vectorised sum rounds
in another order (the tests hold costs to 1e-4 abs).  Views run one after
another, so one view's [K, O, H, W2] intermediates are live at a time.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

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


def per_view_costs_batch(scene: ScenePack, params: AlgorithmParams,
                         parity: int, n: torch.Tensor, d: torch.Tensor
                         ) -> torch.Tensor:
    """Costs of K plane hypotheses against each source view.

    n: [K, H, W2, 3], d: [K, H, W2] on the parity's active half-grid.
    Returns [V, K, H, W2] with invalid (NaN / overflow / padded-view)
    entries at MAXCOST (gipuma.cu:770-775)."""
    if scene.src is None:
        raise ValueError("per_view_costs needs a full scene "
                         "(build_scene(lite=False))")
    C = scene.channels
    census = params.algorithm == MatchingAlgorithm.CENSUS
    offsets = window_offsets(params)
    O = len(offsets)
    K, h, w2 = d.shape
    ref_win = scene.ref_img.windows(offsets, parity)         # [O, H, W2, C]
    ref_center = scene.ref_img.shifted(0, 0, parity)         # [H, W2, C]
    if census:
        ref_center_m = ref_center.mean(-1)
        bit_l = _census_bits(ref_center_m, ref_win.mean(-1),
                             params.census_epsilon)          # [O, H, W2]
    else:
        a = params.alpha
        # Bilateral weight (weight_cu, gipuma.cu:186-193): reference only.
        wgt = torch.exp(-_l1(ref_win - ref_center, -1) * (1.0 / params.gamma))
        ref_win = ref_win.permute(0, 3, 1, 2)                # [O, C, H, W2]
        ref_gx = scene.ref_gx.windows(offsets, parity).permute(0, 3, 1, 2)
        ref_gy = scene.ref_gy.windows(offsets, parity).permute(0, 3, 1, 2)

    chunk = max(1, MAX_SAMPLES // max(1, O * h * w2))
    warps = [_plane_terms(scene, parity, n[k0:k0 + chunk], d[k0:k0 + chunk])
             for k0 in range(0, K, chunk)]
    out = []
    for v in range(scene.num_views):
        # Census reads only the image channels; PM all 3C.
        src_v = scene.src[v, :C] if census else scene.src[v]
        accs = []
        for warp in warps:
            kc = warp.mr.shape[0]
            xw, yw = warped_coords(scene, v, warp, offsets)
            smp = bilinear_sample(src_v, xw, yw)              # [kc*O, *, H, W2]
            smp = smp.reshape((kc, O) + smp.shape[1:])
            if census:
                # Warped center intensity (censusTransform_Arma_cu:429-430).
                u = _center(scene, v, warp)
                src_center = bilinear_sample(src_v, u[..., 0] / u[..., 2],
                                             u[..., 1] / u[..., 2]).mean(1)
                bit_r = _census_bits(src_center[:, None], smp.mean(2),
                                     params.census_epsilon)
                acc = (bit_l[None] != bit_r).to(d.dtype).sum(1)
            else:
                col = _l1(ref_win - smp[:, :, :C], 2).clamp(
                    max=params.tau_color)
                grad = ((_l1(ref_gx - smp[:, :, C:2 * C], 2)
                         + _l1(ref_gy - smp[:, :, 2 * C:], 2)) * 0.0625
                        ).clamp(max=params.tau_gradient)
                acc = (wgt * ((1.0 - a) * col + a * grad)).sum(1)
            accs.append(acc)
        acc = torch.cat(accs)
        # Invalid-view guard (gipuma.cu:770-775): NaN or >= MAXCOST; padded
        # views are always invalid.
        acc = torch.where(torch.isnan(acc) | (acc >= MAXCOST)
                          | (scene.view_valid[v] == 0.0), MAXCOST, acc)
        out.append(acc)
    return torch.stack(out)


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
