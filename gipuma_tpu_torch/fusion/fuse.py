"""Consistency-based depth-map fusion — the capability the reference
delegates to the out-of-tree `fusibile` binary (invoked by every script,
e.g. scripts/dtu_fast.sh:56-57 with --disp_thresh --normal_thresh
--num_consistent).

Counterpart of ``gipuma_tpu/fusion/fuse.py:35-209``, as torch on the
device.  Semantics (interface parity with fusibile's flags):
  For each view i (greedy, in order) and each of its valid pixels:
    * back-project to a world point X;
    * project X into every other view j; at the hit pixel q compare
        - disparity difference |disp(depth_j(q)) - disp(depth_of_X_in_j)|
          < disp_thresh   (disparity = f*baseline/depth, the same fake-
          baseline convention as the PatchMatch stage), and
        - angle(normal_i(p), normal_j(q)) < normal_thresh degrees;
    * if at least `num_consistent` other views agree, emit one fused point
      (mean of the view's own and the consistent views' world points,
      normalised sum of their normals) and mark the consumed pixels in the
      other views as used so each surface point is emitted once.

As in the JAX package: the world points of every view are computed once;
the per-view (d, n) channels are one packed [N, H*W, 4] table, gathered
once per view pair; X_j is recomputed from the gathered depth; the greedy
used-mask lives in the sign of the packed depth (consumed pixels become
-1), marked with an ``amin`` scatter, idempotent under duplicate hits.
The JAX package scans the views inside one executable per chunk; here the
view loops are Python loops of tensor ops, and the output chunk is sized
by OUTPUT_BUDGET_BYTES.  The 3x3 products are written
as elementwise sums in the einsums' order (no matmul, so no TF32).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import FusionParams
from ..geometry.camera import FAKE_BASELINE, decompose_projection

# Live output of one chunk of reference views (keep bool + X f32x3 + n
# f32x3 = 28 bytes per pixel), fetched to the host between chunks: at 49
# views x 1200x1600 the all-views output would be > 2 GB.
OUTPUT_BUDGET_BYTES = 256 << 20


def _matvec3(M: torch.Tensor, v0, v1, v2) -> torch.Tensor:
    """[..., 3] = M [3, 3] applied to the vector (v0, v1, v2), summed in
    index order."""
    return torch.stack([M[i, 0] * v0 + M[i, 1] * v1 + M[i, 2] * v2
                        for i in range(3)], dim=-1)


def _back_project(M_inv: torch.Tensor, p4: torch.Tensor, d: torch.Tensor,
                  x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """World points of depths d at pixels (x, y): M_inv (d*[x, y, 1] - p4)."""
    return _matvec3(M_inv, d * x - p4[0], d * y - p4[1], d - p4[2])


def _project(P: torch.Tensor, X: torch.Tensor, h: int, w: int):
    """Project world points X [..., 3] with P; returns (xi, yi, depth,
    inside): integer pixel coords rounded half-to-even and clipped to the
    image (0 where the projection is not finite, so every index is in
    range), the depth in view P, and whether the point lands inside."""
    q = [P[i, 0] * X[..., 0] + P[i, 1] * X[..., 1] + P[i, 2] * X[..., 2]
         + P[i, 3] for i in range(3)]
    depth = q[2]
    x = q[0] / depth
    y = q[1] / depth
    xi = torch.clamp(torch.round(torch.nan_to_num(x)), 0, w - 1).to(
        torch.int64)
    yi = torch.clamp(torch.round(torch.nan_to_num(y)), 0, h - 1).to(
        torch.int64)
    inside = ((x >= -0.5) & (x <= w - 0.5) & (y >= -0.5) & (y <= h - 0.5)
              & (depth > 0) & torch.isfinite(x) & torch.isfinite(y))
    return xi, yi, depth, inside


def fuse_depthmaps(depths: np.ndarray, normals: np.ndarray,
                   Ps: Sequence[np.ndarray], params: FusionParams,
                   colors: np.ndarray | None = None,
                   f: float | None = None,
                   baseline: float = FAKE_BASELINE, device=None):
    """Fuse per-view depth maps into one consistent point cloud, on
    `device` (None: the card).

    depths [N,H,W] (0 = invalid), normals [N,H,W,3] world-frame unit
    normals, Ps: N original (un-rebased) 3x4 projections, colors optional
    [N,H,W] or [N,H,W,3]; f the focal length of the disparity test (None:
    K[0,0] of view 0).  Returns (points [M,3], normals [M,3], colors
    [M,3]) numpy arrays, view by view in order, pixels row-major."""
    from ..pipeline import resolve_device
    device = resolve_device(device)
    dep = torch.as_tensor(np.asarray(depths, np.float32), device=device)
    nrm = torch.as_tensor(np.asarray(normals, np.float32), device=device)
    N, h, w = dep.shape
    P64 = np.stack([np.asarray(p, np.float64) for p in Ps])
    M_inv = torch.as_tensor(np.linalg.inv(P64[:, :, :3]).astype(np.float32),
                            device=device)
    p4 = torch.as_tensor(P64[:, :, 3].astype(np.float32), device=device)
    Pt = torch.as_tensor(P64.astype(np.float32), device=device)
    if f is None:
        f = float(decompose_projection(P64[0])[0][0, 0])
    cos_thresh = float(np.cos(np.radians(params.normal_thresh)))
    fb = float(f) * float(baseline)

    xg = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    yg = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    with torch.no_grad():
        # World points per view (computed once).
        X_all = torch.stack([_back_project(M_inv[i], p4[i], dep[i], xg, yg)
                             for i in range(N)])             # [N, H, W, 3]
        # (d, n) per pixel, one 16-byte row per gather; the sign of d
        # carries the greedy used-mask.
        packed = torch.cat([dep[..., None], nrm], dim=-1).reshape(
            N, h * w, 4).contiguous()

        chunk = max(1, min(N, OUTPUT_BUDGET_BYTES // (h * w * 28)))
        out_pts, out_nrm, out_col = [], [], []
        for c0 in range(0, N, chunk):
            keeps, fXs, fns = [], [], []
            for i in range(c0, min(N, c0 + chunk)):
                keep, fX, fn = _fuse_view(i, packed, X_all, nrm, Pt, M_inv,
                                          p4, params, fb, cos_thresh, xg, yg)
                keeps.append(keep)
                fXs.append(fX)
                fns.append(fn)
            keep_c = torch.stack(keeps)
            pts_c = torch.stack(fXs)[keep_c].cpu().numpy()
            nrm_c = torch.stack(fns)[keep_c].cpu().numpy()
            keep_np = keep_c.cpu().numpy()
            out_pts.append(pts_c)
            out_nrm.append(nrm_c)
            for k, i in enumerate(range(c0, c0 + keep_np.shape[0])):
                if colors is not None:
                    ci = np.asarray(colors[i])
                    if ci.ndim == 2:
                        ci = np.repeat(ci[..., None], 3, axis=-1)
                    out_col.append(ci[keep_np[k]])
                else:
                    out_col.append(np.full((int(keep_np[k].sum()), 3), 255.0,
                                           np.float32))
    return (np.concatenate(out_pts), np.concatenate(out_nrm),
            np.concatenate(out_col))


def _fuse_view(i: int, packed: torch.Tensor, X_all: torch.Tensor,
               nrm: torch.Tensor, Pt, M_inv, p4, params: FusionParams,
               fb: float, cos_thresh: float, xg, yg):
    """Consistency of reference view i against every other view, then the
    greedy marks in `packed` (in place).  Returns (keep [H, W], fused X
    [H, W, 3], fused n [H, W, 3])."""
    N, h, w = X_all.shape[:3]
    Xi = X_all[i]
    ni = nrm[i]
    valid_i = packed[i, :, 0].reshape(h, w) > 0
    count = torch.zeros((h, w), dtype=torch.int32, device=Xi.device)
    acc_X = Xi.clone()
    acc_n = ni.clone()
    hits = []
    for j in range(N):
        if j == i:          # a view never confirms itself
            continue
        xi_, yi_, d_proj, inside = _project(Pt[j], Xi, h, w)
        lin = (yi_ * w + xi_).reshape(-1)
        g = packed[j].index_select(0, lin).reshape(h, w, 4)
        d_j = g[..., 0]                 # < 0 where invalid OR consumed
        n_j = g[..., 1:4]
        # Back-project the hit pixel of view j at its own depth.
        X_j = _back_project(M_inv[j], p4[j], d_j, xi_.to(torch.float32),
                            yi_.to(torch.float32))
        dot = ni[..., 0] * n_j[..., 0] + ni[..., 1] * n_j[..., 1] \
            + ni[..., 2] * n_j[..., 2]
        ok = (inside & valid_i & (d_j > 0)
              & (torch.abs(fb / d_j - fb / d_proj) < params.disp_thresh)
              & (dot > cos_thresh))
        count += ok.to(torch.int32)
        acc_X += torch.where(ok[..., None], X_j, 0.0)
        acc_n += torch.where(ok[..., None], n_j, 0.0)
        hits.append((j, lin, ok))
    keep = valid_i & (count >= params.num_consistent)
    fused_X = acc_X / (count + 1).to(torch.float32)[..., None]
    fused_n = acc_n / torch.clamp(
        torch.linalg.vector_norm(acc_n, dim=-1, keepdim=True), min=1e-12)
    # Mark consumed pixels: -1 at the hit slots of the kept pixels (amin is
    # idempotent under duplicate hits), and view i's own kept pixels.
    keep_f = keep.reshape(-1)
    for j, lin, ok in hits:
        marks = torch.where(ok.reshape(-1) & keep_f, -1.0, float("inf"))
        packed[j, :, 0].scatter_reduce_(0, lin, marks, reduce="amin")
    d_i = packed[i, :, 0]
    d_i.copy_(torch.where(keep_f, -1.0, d_i))
    return keep, fused_X, fused_n
