"""The comparison that decides ``correct``.

Every completed view's outputs (view subset, depth range, depth, normals,
cost) are judged against the plain reference (``reference.py``) and the
analytic ground truth (``scene.ground_truth``):

* ``views_wrong``: completed views whose source-view subset or depth range
  differs from the reference's view selection (exact; limit 0).
* ``depth_err``: over a sample of the completed views drawn from the seed,
  the worst view's median relative depth error against the ground truth,
  on the pixels that see a surface, borders trimmed.
* ``cost_gap``: over a sample of pixels of the sampled views,
  the ``cost_quantile`` quantile of |program cost - reference cost| of the
  plane the program states at that pixel (its depth and normal).

The control (``control_outputs``) puts the reference in the program's
place, computed in bfloat16, one precision step below the exact path's
float32: ground-truth depth and normals rounded to it, and the cost of the
planes they state computed with the photometry in it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import reference as ref_mod
from .scene import ground_truth

CONTROL_DTYPE = torch.bfloat16


@dataclasses.dataclass
class ViewOutput:
    """One completed view as the judged side reports it."""

    ref: int
    subset: list
    depth_min: float
    depth_max: float
    depth: np.ndarray        # [H, W], 0 where the side gives no depth
    normals: np.ndarray      # [H, W, 3] world frame
    cost: np.ndarray | None  # [H, W] or None (computed on demand)


def rel_errors(scene, out: ViewOutput, device, trim: int) -> torch.Tensor:
    """|d - d_gt| / d_gt at the view's pixels that see a surface."""
    gt, _ = ground_truth(scene, out.ref, device)
    s = slice(trim, -trim)
    gt = gt[s, s]
    d = torch.as_tensor(out.depth, device=device, dtype=torch.float64)[s, s]
    m = torch.isfinite(gt)
    return (d[m] - gt[m]).abs() / gt[m]


def sample_views(n_done: int, k: int, rng: np.random.Generator) -> list[int]:
    """Positions in the completed list of the views the check samples."""
    if n_done <= k:
        return list(range(n_done))
    return sorted(rng.choice(n_done, size=k, replace=False).tolist())


def sample_pixels(out: ViewOutput, n: int, trim: int,
                  rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    h, w = out.depth.shape
    inner = np.zeros((h, w), dtype=bool)
    inner[trim:h - trim, trim:w - trim] = True
    ys, xs = np.nonzero(inner & (out.depth > 0))
    if len(ys) > n:
        pick = rng.choice(len(ys), size=n, replace=False)
        ys, xs = ys[pick], xs[pick]
    return ys, xs


def folder_index(n_views: int, ref: int, subset: list[int]) -> list[int]:
    """Folder indices of a subset given in the reordered (ref-first) list."""
    others = [i for i in range(n_views) if i != ref]
    return [others[k - 1] for k in subset]


def plane_cost(scene, out: ViewOutput, ys, xs, p: dict, device,
               dtype=torch.float64) -> torch.Tensor:
    """The reference's multi-view cost of the planes `out` states at (ys, xs),
    against the reference's own view subset."""
    subset, _, _ = ref_mod.select_views(scene.cameras, out.ref, scene.width,
                                        scene.height, p)
    views = folder_index(len(scene.cameras), out.ref, subset)
    px = torch.as_tensor(xs, device=device, dtype=torch.float64)
    py = torch.as_tensor(ys, device=device, dtype=torch.float64)
    depth = torch.as_tensor(out.depth[ys, xs], device=device,
                            dtype=torch.float64)
    nrm = torch.as_tensor(out.normals[ys, xs], device=device,
                          dtype=torch.float64)
    X, n = ref_mod.planes_from_outputs(scene.cameras[out.ref], px, py, depth,
                                       nrm)
    return ref_mod.pm_cost(scene.cameras, scene.images, out.ref, views, px, py,
                           X, n, p, dtype=dtype)


def judge(scene, outs: list[ViewOutput], cfg: dict, seed: int,
          device, cost_of=None) -> dict:
    """The numbers compared, for the outputs `outs` of one run.

    cost_of(out, ys, xs) gives the judged side's cost at those pixels
    (default: its cost map)."""
    chk = cfg["check"]
    p = cfg["method"]
    rng = np.random.default_rng([seed, 2])
    wrong = 0
    for o in outs:
        want = ref_mod.select_views(scene.cameras, o.ref, scene.width,
                                    scene.height, p)
        got = (list(o.subset), float(o.depth_min), float(o.depth_max))
        wrong += int(got != (list(want[0]), want[1], want[2]))
    picked = sample_views(len(outs), chk["views"], rng)
    medians = []
    for k in picked:
        e = rel_errors(scene, outs[k], device, chk["trim"])
        medians.append(float(e.median()) if e.numel() else float("inf"))
    nums = {"views_wrong": wrong,
            "depth_err": max(medians) if medians else float("inf")}
    gaps = []
    for k in picked:
        o = outs[k]
        ys, xs = sample_pixels(o, chk["pixels"], chk["trim"], rng)
        want = plane_cost(scene, o, ys, xs, p, device)
        got = (torch.as_tensor(o.cost[ys, xs], device=device,
                               dtype=torch.float64)
               if cost_of is None else cost_of(o, ys, xs))
        gaps.append((got - want).abs())
    g = torch.cat(gaps) if gaps else torch.zeros(1, device=device)
    nums["cost_gap"] = float(torch.quantile(g, chk["cost_quantile"])) \
        if g.numel() else float("inf")
    return nums


def control_outputs(scene, refs: list[int], cfg: dict, device):
    """The control's outputs for the reference views `refs`: the
    reference in the program's place at the precision one step below the
    exact path's (``CONTROL_DTYPE``), and its cost
    function."""
    low = CONTROL_DTYPE
    p = cfg["method"]
    outs = []
    for r in refs:
        gt, gtn = ground_truth(scene, r, device)
        hit = torch.isfinite(gt)
        d = torch.where(hit, ref_mod.round_to(torch.where(hit, gt, 0.0), low),
                        0.0)
        n = ref_mod.round_to(gtn, low)
        subset, dmin, dmax = ref_mod.select_views(scene.cameras, r,
                                                  scene.width, scene.height, p)
        outs.append(ViewOutput(r, subset, dmin, dmax,
                               d.cpu().numpy(), n.cpu().numpy(), None))

    def cost_of(out, ys, xs):
        return plane_cost(scene, out, ys, xs, p, device, dtype=low)

    return outs, cost_of


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number with no limit set cannot pass."""
    rows, ok = {}, True
    for name, value in nums.items():
        lim = limits.get(name, {}).get("limit")
        rows[name] = {"value": value, "limit": lim}
        if lim is None or not (value <= lim):
            ok = False
    return ok, rows
