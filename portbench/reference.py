"""The plain reference the benchmark holds the program's outputs against.

Plain NumPy and PyTorch, written from the method's description (Galliani
et al., ICCV 2015; the reference CLI's selectViews, main.cpp:430-499, and
pmCost / pmCostMultiview, gipuma.cu:223-320 and 720-806), for the
benchmark's own cameras (K, R, C as the rig generator made them) and
images.  It imports nothing of the program and takes nothing the program
made: the program's depth and normal maps are read only to be judged.

* ``select_views``: the source views whose central viewing ray meets the
  reference's at an angle strictly inside (min_angle, max_angle), capped
  at max_views by a permutation of NumPy's ``default_rng(seed)`` (the
  reproducible stand-in for the reference CLI's time-seeded shuffle).
* ``pm_cost``: the bilaterally weighted, truncated colour + gradient cost
  of given planes at given pixels, summed over the sampled window offsets,
  per source view, combined as the mean of the ``n_best`` lowest valid
  costs.  Geometry is computed in float64, photometry in ``dtype``
  (float64 for the reference; a lower precision for the control).
"""
from __future__ import annotations

import math

import numpy as np
import torch

MAXCOST = 1000.0


def central_ray(K: np.ndarray, R: np.ndarray, w: int, h: int) -> np.ndarray:
    """World direction of the ray through the image centre (w/2, h/2)."""
    v = R.T @ np.linalg.inv(K) @ np.array([w / 2.0, h / 2.0, 1.0])
    return v / np.linalg.norm(v)


def select_views(cams: list, ref: int, w: int, h: int, p: dict
                 ) -> tuple[list[int], float, float]:
    """(subset, depth_min, depth_max) of reference view `ref`.

    The subset indexes the folder reordered with `ref` first, the others
    after it in folder order.  The depth range is the configuration's
    (both configurations fix it)."""
    order = [ref] + [i for i in range(len(cams)) if i != ref]
    v_ref = central_ray(cams[ref].K, cams[ref].R, w, h)
    lo, hi = math.radians(p["min_angle"]), math.radians(p["max_angle"])
    subset = []
    for k in range(1, len(order)):
        c = cams[order[k]]
        ang = math.acos(float(np.clip(np.dot(v_ref, central_ray(c.K, c.R, w, h)),
                                      -1.0, 1.0)))
        if lo < ang < hi:
            subset.append(k)
    if len(subset) >= p["max_views"]:
        rng = np.random.default_rng(p["selection_seed"])
        subset = [int(v) for v in rng.permutation(subset)[:p["max_views"]]]
    return subset, float(p["depth_min"]), float(p["depth_max"])


def selection_angles(cams: list, ref: int, w: int, h: int) -> list[float]:
    """Degrees between the reference's central ray and each other view's."""
    v_ref = central_ray(cams[ref].K, cams[ref].R, w, h)
    out = []
    for i, c in enumerate(cams):
        if i != ref:
            d = float(np.clip(np.dot(v_ref, central_ray(c.K, c.R, w, h)),
                              -1.0, 1.0))
            out.append(math.degrees(math.acos(d)))
    return out


def gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central differences I[x+1] - I[x-1], edges clamped: (gx, gy)."""
    h, w = img.shape
    xs = torch.arange(w, device=img.device)
    ys = torch.arange(h, device=img.device)
    gx = img[:, (xs + 1).clamp(max=w - 1)] - img[:, (xs - 1).clamp(min=0)]
    gy = img[(ys + 1).clamp(max=h - 1)] - img[(ys - 1).clamp(min=0)]
    return gx, gy


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             dtype) -> torch.Tensor:
    """Bilinear sample of img [H, W] at (x, y), clamped to the edge."""
    h, w = img.shape
    x = x.clamp(0.0, w - 1.0)
    y = y.clamp(0.0, h - 1.0)
    x0 = torch.floor(x).clamp(0, w - 2)
    y0 = torch.floor(y).clamp(0, h - 2)
    fx = (x - x0).clamp(0.0, 1.0).to(dtype)
    fy = (y - y0).clamp(0.0, 1.0).to(dtype)
    x0, y0 = x0.long(), y0.long()
    im = img.to(dtype)
    v00, v01 = im[y0, x0], im[y0, x0 + 1]
    v10, v11 = im[y0 + 1, x0], im[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def window_offsets(p: dict) -> list[tuple[int, int]]:
    """Every `increment`-th offset of the box, from -radius to +radius."""
    r = (p["box"] - 1) // 2
    steps = range(-r, r + 1, p["increment"])
    return [(dx, dy) for dx in steps for dy in steps]


def planes_from_outputs(cam, px: torch.Tensor, py: torch.Tensor,
                        depth: torch.Tensor, normal_w: torch.Tensor):
    """The plane each judged pixel states: its 3-D point (from the z-depth)
    and its world normal.  Returns (X [N, 3], n [N, 3]) in world frame."""
    dev = px.device
    Kinv = torch.as_tensor(np.linalg.inv(cam.K), device=dev)
    Rt = torch.as_tensor(cam.R.T.copy(), device=dev)
    C = torch.as_tensor(cam.C, device=dev)
    pix = torch.stack([px, py, torch.ones_like(px)], -1)
    d = pix @ (Rt @ Kinv).T
    return C + depth[:, None] * d, normal_w


def pm_cost(cams: list, images: list, ref: int, subset_views: list[int],
            px: torch.Tensor, py: torch.Tensor, X: torch.Tensor,
            n: torch.Tensor, p: dict, dtype=torch.float64) -> torch.Tensor:
    """Multi-view PM cost at pixels (px, py) of view `ref` of the planes
    through X [N, 3] with normals n [N, 3] (world frame), against the
    source views `subset_views` (folder indices).  Returns [N] float64."""
    dev = px.device
    f64 = torch.float64
    offs = window_offsets(p)
    cam = cams[ref]
    h, w = images[ref].shape
    Kinv = torch.as_tensor(np.linalg.inv(cam.K), device=dev)
    Rt = torch.as_tensor(cam.R.T.copy(), device=dev)
    Cr = torch.as_tensor(cam.C, device=dev)
    ref_img = torch.as_tensor(images[ref], device=dev, dtype=f64)
    rgx, rgy = gradients(ref_img)
    xi, yi = px.round().long(), py.round().long()
    centre = ref_img[yi, xi].to(dtype)
    nX = (n * X).sum(-1)
    per_view = []
    for v in subset_views:
        sc = cams[v]
        Pv = torch.as_tensor(sc.P, device=dev)
        src = torch.as_tensor(images[v], device=dev, dtype=f64)
        sgx, sgy = gradients(src)
        acc = torch.zeros(px.shape, dtype=dtype, device=dev)
        for dx, dy in offs:
            qx = (xi + dx).clamp(0, w - 1)
            qy = (yi + dy).clamp(0, h - 1)
            # The window pixel's ray, met with the plane, projected into v.
            ray = torch.stack([px + dx, py + dy, torch.ones_like(px)], -1) \
                @ (Rt @ Kinv).T
            t = (nX - (n * Cr).sum(-1)) / (n * ray).sum(-1)
            Xq = Cr + t[:, None] * ray
            uvw = torch.cat([Xq, torch.ones_like(t)[:, None]], -1) @ Pv.T
            u, vv = uvw[:, 0] / uvw[:, 2], uvw[:, 1] / uvw[:, 2]
            r_i = ref_img[qy, qx].to(dtype)
            wgt = torch.exp(-(r_i - centre).abs() / p["gamma"])
            col = (r_i - bilinear(src, u, vv, dtype)).abs().clamp(
                max=p["tau_color"])
            grad = (((rgx[qy, qx].to(dtype) - bilinear(sgx, u, vv, dtype)).abs()
                     + (rgy[qy, qx].to(dtype) - bilinear(sgy, u, vv, dtype)).abs())
                    * 0.0625).clamp(max=p["tau_gradient"])
            acc = acc + wgt * ((1.0 - p["alpha"]) * col + p["alpha"] * grad)
        acc = acc.to(f64)
        per_view.append(torch.where(torch.isnan(acc) | (acc >= MAXCOST),
                                    MAXCOST, acc))
    costs = torch.stack(per_view)                       # [V, N]
    valid = (costs < MAXCOST).sum(0)
    nb = valid.clamp(max=p["n_best"])
    srt = torch.sort(costs, dim=0).values
    rank = torch.arange(costs.shape[0], device=dev)[:, None]
    total = torch.where(rank < nb, srt, 0.0).sum(0)
    out = total / nb.clamp(min=1)
    return torch.where(nb < 1, MAXCOST, out)


def round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded through `dtype` and back (the control's precision)."""
    return x.to(dtype).to(x.dtype)
