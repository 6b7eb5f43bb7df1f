"""The plain reference of depth-map fusion the benchmark holds the program's
fused cloud against.

Plain PyTorch, written from fusibile's rule as the program states it (its
``fusion/fuse.py`` docstring; the reference scripts hand fusibile
``--disp_thresh --normal_thresh --num_consistent``, scripts/dtu_fast.sh):

* the views are taken greedily in folder order; a view's pixel takes part
  while its depth is positive and no earlier fused point has used it;
* each such pixel of view i is back-projected to its world point X
  (X = M^-1 (d [x, y, 1] - p4) for P = [M | p4]) and projected into every
  other view j, rounded half to even to the nearest pixel q;
* view j agrees where X lands inside it, q is unused, j's depth d_j(q) is
  positive, the disparities f * baseline / d_j(q) and f * baseline /
  depth_j(X) differ by less than ``disp_thresh``, and the two normals meet
  at less than ``normal_thresh`` degrees;
* a pixel with at least ``num_consistent`` agreeing views gives one point,
  the mean of X and the agreeing views' back-projected points, with the
  normalised sum of the normals; its pixel and the agreeing pixels q are
  used from then on.

Points come out view by view, pixels in row-major order.  ``dtype`` is the
precision of every step (float64 for the reference; the control runs it a
step below the program's float32).  It imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _back_project(Minv: torch.Tensor, p4: torch.Tensor, d: torch.Tensor,
                  x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """World points [n, 3] of depths d at pixels (x, y)."""
    rhs = torch.stack([d * x - p4[0], d * y - p4[1], d - p4[2]], dim=-1)
    return rhs @ Minv.T


def _pixel(x: torch.Tensor, n: int) -> torch.Tensor:
    """The nearest pixel index (half to even) of coordinates x, clipped to
    [0, n - 1]; 0 where x is not a number."""
    x = torch.round(torch.nan_to_num(x).clamp(-1, n))
    return x.long().clamp(0, n - 1)


def fuse(depths: np.ndarray, normals: np.ndarray, Ps, p: dict, f: float,
         dtype=torch.float64, device="cpu"
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fuse depths [N, H, W] (<= 0: no depth) and world normals [N, H, W, 3]
    of views with projections Ps (3x4) under the fusion settings `p`
    (``disp_thresh``, ``normal_thresh``, ``num_consistent``, ``baseline``)
    and focal length f.  Returns (points [M, 3], normals [M, 3]) in
    `dtype` on `device`."""
    N, h, w = np.shape(depths)
    P64 = torch.as_tensor(np.stack([np.asarray(q, np.float64) for q in Ps]),
                          device=device)
    Minv = torch.linalg.inv(P64[:, :, :3]).to(dtype)
    P = P64.to(dtype)
    D = torch.as_tensor(np.asarray(depths), device=device).to(dtype)
    D = D.reshape(N, -1)
    Nr = torch.as_tensor(np.asarray(normals), device=device).to(dtype)
    Nr = Nr.reshape(N, -1, 3)
    used = torch.zeros((N, h * w), dtype=torch.bool, device=device)
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    xs, ys = xs.reshape(-1).to(dtype), ys.reshape(-1).to(dtype)
    fb = torch.tensor(f * p["baseline"], dtype=dtype, device=device)
    thresh = torch.tensor(p["disp_thresh"], dtype=dtype, device=device)
    cos_t = torch.tensor(math.cos(math.radians(p["normal_thresh"])),
                         dtype=dtype, device=device)
    out_X, out_n = [], []
    for i in range(N):
        d_i, n_i = D[i], Nr[i]
        valid = (d_i > 0) & ~used[i]
        X_i = _back_project(Minv[i], P[i, :, 3], d_i, xs, ys)
        count = torch.zeros(h * w, dtype=torch.int64, device=device)
        sum_X, sum_n = X_i.clone(), n_i.clone()
        hits = []
        for j in range(N):
            if j == i:
                continue
            q = X_i @ P[j, :, :3].T + P[j, :, 3]
            x, y, z = q[:, 0] / q[:, 2], q[:, 1] / q[:, 2], q[:, 2]
            inside = ((x >= -0.5) & (x <= w - 0.5) & (y >= -0.5)
                      & (y <= h - 0.5) & (z > 0) & torch.isfinite(x)
                      & torch.isfinite(y))
            xi = _pixel(x, w)
            yi = _pixel(y, h)
            lin = yi * w + xi
            d_j, n_j = D[j, lin], Nr[j, lin]
            ok = (inside & valid & ~used[j, lin] & (d_j > 0)
                  & ((fb / d_j - fb / z).abs() < thresh)
                  & ((n_i * n_j).sum(-1) > cos_t))
            X_j = _back_project(Minv[j], P[j, :, 3], d_j, xi.to(dtype),
                                yi.to(dtype))
            count += ok
            sum_X += torch.where(ok[:, None], X_j, 0.0)
            sum_n += torch.where(ok[:, None], n_j, 0.0)
            hits.append((j, lin, ok))
        keep = valid & (count >= p["num_consistent"])
        for j, lin, ok in hits:
            used[j, lin[ok & keep]] = True
        used[i] |= keep
        X = sum_X / (count + 1).to(dtype)[:, None]
        n = sum_n / torch.linalg.vector_norm(sum_n, dim=-1,
                                             keepdim=True).clamp(min=1e-12)
        out_X.append(X[keep])
        out_n.append(n[keep])
    return torch.cat(out_X), torch.cat(out_n)
