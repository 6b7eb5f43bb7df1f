"""View-sharded consistency fusion over torch.distributed ranks.

Counterpart of ``gipuma_tpu/fusion/sharded.py:38-153``.  fusion/fuse.py
keeps every view's depth map on one device; here the VIEW axis of the
consistency check is sharded over the ranks of a mesh axis:

* every rank holds an [N/k, H, W] block of the (depth, normal) table (the
  view axis padded with empty views to a multiple of k) and, in the sign
  of its depths, its block of the greedy used-marks;
* for each reference view i (host loop, fusibile's greedy order): the
  owner of view i contributes its valid-and-unused mask, summed over the
  axis (one [H, W] all-reduce); every rank projects view i's points into
  its own views and sums its partial counts and point / normal sums; the
  partials are combined by ONE [H, W, 7] all-reduce (counts are small
  integers, exact in f32); each rank marks the consumed pixels of its own
  views.

Semantics equal fuse_depthmaps' (same greedy order, same accept rule; the
partial sums are added in another order).  Every rank returns the whole
cloud.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import FusionParams
from ..geometry.camera import FAKE_BASELINE, decompose_projection
from ..parallel.mesh import axis
from .fuse import OUTPUT_BUDGET_BYTES, _back_project, _project


def fuse_depthmaps_sharded(depths: np.ndarray, normals: np.ndarray,
                           Ps: Sequence[np.ndarray], params: FusionParams,
                           mesh, axis_name: str = "view",
                           colors: np.ndarray | None = None,
                           f: float | None = None,
                           baseline: float = FAKE_BASELINE, device=None):
    """fuse_depthmaps with the view axis sharded over `mesh[axis_name]`
    (mesh None: one rank), on `device` (None: the card).

    Every rank passes the same arguments.  Returns (points [M,3], normals
    [M,3], colors [M,3]) numpy arrays, equal to fuse_depthmaps'."""
    from ..pipeline import resolve_device
    device = resolve_device(device)
    ax = axis(mesh, axis_name)
    depths = np.asarray(depths, np.float32)
    normals = np.asarray(normals, np.float32)
    N, h, w = depths.shape
    k = ax.size
    n_loc = -(-N // k)
    lo = ax.index * n_loc
    mine = list(range(lo, min(N, lo + n_loc)))

    P64 = np.stack([np.asarray(p, np.float64) for p in Ps])
    M_inv_all = np.linalg.inv(P64[:, :, :3]).astype(np.float32)
    if f is None:
        f = float(decompose_projection(P64[0])[0][0, 0])
    cos_thresh = float(np.cos(np.radians(params.normal_thresh)))
    fb = float(f) * float(baseline)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    # This rank's block, padded with empty views (depth 0: never valid).
    dep_l = np.zeros((n_loc, h, w), np.float32)
    nrm_l = np.zeros((n_loc, h, w, 3), np.float32)
    dep_l[:len(mine)] = depths[mine]
    nrm_l[:len(mine)] = normals[mine]
    # (d, n) per pixel; the sign of d carries the greedy used-marks.
    packed = torch.cat([t(dep_l)[..., None], t(nrm_l)], dim=-1).reshape(
        n_loc, h * w, 4).contiguous()
    P_l = t(P64[mine].astype(np.float32))
    Minv_l = t(M_inv_all[mine])
    p4_l = t(P64[mine, :, 3].astype(np.float32))
    xg = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    yg = torch.arange(h, device=device, dtype=torch.float32)[:, None]

    keeps, fXs, fns = [], [], []
    out_pts, out_nrm, out_keep = [], [], []
    chunk = max(1, min(N, OUTPUT_BUDGET_BYTES // (h * w * 28)))

    def flush():
        keep_c = torch.stack(keeps)
        out_pts.append(torch.stack(fXs)[keep_c].cpu().numpy())
        out_nrm.append(torch.stack(fns)[keep_c].cpu().numpy())
        out_keep.extend(keep_c.cpu().numpy())
        keeps.clear()
        fXs.clear()
        fns.clear()

    with torch.no_grad():
        for i in range(N):
            Mi = t(M_inv_all[i])
            p4i = t(P64[i, :, 3].astype(np.float32))
            di = t(depths[i])
            ni = t(normals[i])
            Xi = _back_project(Mi, p4i, di, xg, yg)
            # View i's valid-and-unused pixels, from its owner (used_i).
            own = torch.zeros((h, w), dtype=torch.float32, device=device)
            if i in mine:
                own = (packed[i - lo, :, 0].reshape(h, w) > 0).to(
                    torch.float32)
            valid_i = ax.all_reduce(own) > 0
            part = torch.zeros((h, w, 7), dtype=torch.float32, device=device)
            hits = []
            for jl, j in enumerate(mine):
                if j == i:          # a view never confirms itself
                    continue
                xi_, yi_, d_proj, inside = _project(P_l[jl], Xi, h, w)
                lin = (yi_ * w + xi_).reshape(-1)
                g = packed[jl].index_select(0, lin).reshape(h, w, 4)
                d_j = g[..., 0]             # < 0 where invalid OR consumed
                n_j = g[..., 1:4]
                X_j = _back_project(Minv_l[jl], p4_l[jl], d_j,
                                    xi_.to(torch.float32),
                                    yi_.to(torch.float32))
                dot = ni[..., 0] * n_j[..., 0] + ni[..., 1] * n_j[..., 1] \
                    + ni[..., 2] * n_j[..., 2]
                ok = (inside & valid_i & (d_j > 0)
                      & (torch.abs(fb / d_j - fb / d_proj)
                         < params.disp_thresh)
                      & (dot > cos_thresh))
                okf = ok[..., None]
                part += torch.cat([ok.to(torch.float32)[..., None],
                                   torch.where(okf, X_j, 0.0),
                                   torch.where(okf, n_j, 0.0)], dim=-1)
                hits.append((jl, lin, ok))
            tot = ax.all_reduce(part)
            count = tot[..., 0]
            keep = valid_i & (count >= params.num_consistent)
            fused_X = (Xi + tot[..., 1:4]) / (count + 1.0)[..., None]
            an = ni + tot[..., 4:7]
            fused_n = an / torch.clamp(
                torch.linalg.vector_norm(an, dim=-1, keepdim=True),
                min=1e-12)
            keep_f = keep.reshape(-1)
            for jl, lin, ok in hits:
                marks = torch.where(ok.reshape(-1) & keep_f, -1.0,
                                    float("inf"))
                packed[jl, :, 0].scatter_reduce_(0, lin, marks,
                                                 reduce="amin")
            if i in mine:
                d_i = packed[i - lo, :, 0]
                d_i.copy_(torch.where(keep_f, -1.0, d_i))
            keeps.append(keep)
            fXs.append(fused_X)
            fns.append(fused_n)
            if len(keeps) == chunk:
                flush()
        if keeps:
            flush()

    out_col = []
    for i in range(N):
        if colors is not None:
            ci = np.asarray(colors[i])
            if ci.ndim == 2:
                ci = np.repeat(ci[..., None], 3, axis=-1)
            out_col.append(ci[out_keep[i]])
        else:
            out_col.append(np.full((int(out_keep[i].sum()), 3), 255.0,
                                   np.float32))
    return (np.concatenate(out_pts), np.concatenate(out_nrm),
            np.concatenate(out_col))
