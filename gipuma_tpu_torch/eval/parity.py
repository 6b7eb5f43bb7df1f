"""Exact-vs-rect accuracy parity harness.

Counterpart of ``gipuma_tpu/eval/parity.py`` on the port's engine, on
``device`` (None: the card).  Runs the SAME synthetic scene through both cost engines at a preset's
parameters (box size, iterations, n_best, depth range — config.PRESETS)
with identical seeds, and reports an error-budget table:

* each engine's depth error vs the analytic ground truth
  (median / p99 / max relative error),
* the pixelwise depth gap between the engines (the engines share init and
  refinement draws, so the gap isolates the cost-path deviations the rect
  design documents: rect-frame windows/gradients, nearest-pixel centering,
  bf16 tap packing),
* normal angular errors vs the known plane normal.

The rows and their markdown have the JAX package's keys and layout;
`tests/test_torch_parity.py` holds them to the JAX tests' thresholds, and
`chip_smoke.py` runs them on the card.  The engines share a seed: each run
starts from a fresh torch.Generator seeded from params.seed, so the exact
and rect runs draw the same numbers as far as their draws coincide.
"""
from __future__ import annotations

import numpy as np

import torch

from ..config import PRESETS
from ..geometry.camera import FAKE_BASELINE
from ..models.patchmatch import finalize, make_generator, run_patchmatch
from ..models.rect_scene import build_rect_scene
from ..models.scene import build_scene
from ..ops.cost import multiview_cost
from ..ops.rect_cost import rect_multiview_cost
from ..utils.synthetic import plane_scene


def _run(scene, params, cost_fn, device):
    """Init + params.iterations iterations from a generator seeded with
    params.seed; returns finalize's (depth, normals, cost) on the host."""
    with torch.no_grad():
        st = run_patchmatch(scene, params, make_generator(params.seed, device),
                            cost_fn)
        return tuple(t.cpu().numpy() for t in finalize(st, scene))


def _depth_stats(depth, gt, border):
    s = np.s_[border:-border, border:-border]
    d = np.asarray(depth)[s]
    g = np.asarray(gt)[s]
    ok = d > 0
    rel = np.abs(d[ok] - g[ok]) / g[ok]
    return {"median": float(np.median(rel)),
            "p99": float(np.quantile(rel, 0.99)),
            "max": float(rel.max()),
            "valid_frac": float(ok.mean())}


def _normal_stats(normals, n_gt, border):
    s = np.s_[border:-border, border:-border]
    nn = np.asarray(normals)[s]
    dots = np.clip(np.abs(nn @ np.asarray(n_gt, np.float64)), 0.0, 1.0)
    ang = np.degrees(np.arccos(dots))
    return {"median_deg": float(np.median(ang)),
            "p99_deg": float(np.quantile(ang, 0.99))}


def run_preset_parity(preset: str, h: int, w: int,
                      iterations: int | None = None, num_cams: int = 4,
                      seed: int = 0, border: int = 12,
                      texture: str = "sos",
                      two_stage: bool = False, device=None) -> dict:
    """Exact + rect runs of one preset on a matched synthetic plane scene.

    The scene's depth/radius are scaled to the preset's depth range
    (DTU presets live at mm scale, Middlebury at unit scale) so the
    disparity schedule and refinement steps exercise the preset's real
    operating point."""
    from ..pipeline import resolve_device
    device = resolve_device(device)
    base = PRESETS[preset]
    assert base.depth_min > 0, f"preset {preset} has no fixed depth range"
    depth_mid = 0.5 * (base.depth_min + base.depth_max)
    images, rig, gt, (n_w, _) = plane_scene(
        num_cams=num_cams, h=h, w=w, focal=1.25 * w,
        plane_depth=depth_mid, slant=(0.2, -0.1), radius=depth_mid / 4.0,
        texture=texture)
    params = base.replace(
        seed=seed, view_selection=False,
        iterations=base.iterations if iterations is None else iterations,
        pyramid_levels=1)
    params = params.with_depth_range(base.depth_min, base.depth_max,
                                     rig.f, FAKE_BASELINE)
    subset = list(range(1, num_cams))

    with torch.no_grad():
        exact_scene = build_scene(images, rig, subset, params,
                                  base.depth_min, base.depth_max,
                                  device=device)
    d_e, n_e, _ = _run(exact_scene, params, multiview_cost, device)

    with torch.no_grad():
        rect_scene, info = build_rect_scene(images, rig, subset, params,
                                            base.depth_min, base.depth_max,
                                            device=device)
    # two_stage applies only to the rect engine (the semantics deviation
    # under study: sparse-winner-only full evaluation + strided screening
    # views — the exact production configuration bench.py runs).
    rect_params = params.replace(rect_two_stage_cull=two_stage,
                                 cull_view_stride=2 if two_stage else 1)
    d_r, n_r, _ = _run(rect_scene, rect_params, rect_multiview_cost, device)

    s = np.s_[border:-border, border:-border]
    de = np.asarray(d_e)[s]
    dr = np.asarray(d_r)[s]
    g = np.asarray(gt)[s]
    ok = (de > 0) & (dr > 0)
    gap = np.abs(dr[ok] - de[ok]) / g[ok]

    return {
        "preset": preset + ("+cull" if two_stage else ""),
        "shape": (h, w),
        "texture": texture,
        "iterations": params.iterations,
        "box": (params.box_hsize, params.box_vsize),
        "exact": _depth_stats(d_e, gt, border),
        "rect": _depth_stats(d_r, gt, border),
        "gap": {"median": float(np.median(gap)),
                "p99": float(np.quantile(gap, 0.99)),
                "max": float(gap.max())},
        "exact_normals": _normal_stats(n_e, n_w, border),
        "rect_normals": _normal_stats(n_r, n_w, border),
        "rect_pairs": [p.get("rect_shape") for p in info["pairs"]],
    }


def run_cull_hard_scene(kind: str, h: int = 64, w: int = 96,
                        num_cams: int = 5, seed: int = 0, border: int = 10,
                        iterations: int = 4, device=None) -> dict:
    """Two-stage-cull quality gate on HARD scene families (VERDICT r4
    item 4): the slanted-plane gates alone don't exercise where a sparse
    3x3 screen on strided views is most likely to mispick.  Runs the rect
    engine with the cull OFF and ON (the production cull_view_stride=2
    configuration) on:

    * "two_plane" — an occluding depth discontinuity
      (utils/synthetic.two_plane_scene, noise texture);
    * "textureless_patch" — a flat constant-intensity patch where every
      candidate costs the same (stats split into textured region vs
      patch);
    * "low_contrast" — ~5x lower texture modulation (5x less photometric
      evidence for the ranking).

    This is what licenses the deviation from the reference's
    all-candidates-full loop (gipuma.cu:832-874); the JAX package's
    tests/test_cull_hard_scenes.py gates its rows, and
    tests/test_torch_parity.py holds the port's to the same gates."""
    from ..pipeline import resolve_device
    from ..utils.synthetic import two_plane_scene

    device = resolve_device(device)

    depth_min, depth_max = 3.0, 8.0
    region_mask = None          # True = the region stats are computed on
    if kind == "two_plane":
        images, rig, gt, near_mask = two_plane_scene(
            num_cams=num_cams, h=h, w=w, focal=1.25 * w, texture="noise")
        # Secondary region: a band around the discontinuity column, where
        # occlusion makes sparse screening most error-prone.
        edge = np.abs(np.diff(near_mask.astype(np.int8), axis=1)) > 0
        band = np.zeros_like(near_mask)
        cols = np.nonzero(edge.any(axis=0))[0]
        for c in cols:
            band[:, max(0, c - 8):c + 9] = True
        region_mask = band
    elif kind in ("textureless_patch", "low_contrast"):
        tex = ("noise_patch" if kind == "textureless_patch"
               else "noise_lc")
        images, rig, gt, (n_w, _) = plane_scene(
            num_cams=num_cams, h=h, w=w, focal=1.25 * w, plane_depth=5.0,
            slant=(0.2, -0.1), texture=tex)
        if kind == "textureless_patch":
            # The patch in reference-image coords (the texture flattens
            # |x|<0.55, |y|<0.4 in depth-normalized world coords).
            from ..utils.synthetic import intersect_plane, make_ring_P
            Ps = make_ring_P(num_cams, h, w, 1.25 * w, target_depth=5.0)
            n = np.array([0.2, -0.1, 1.0])
            n /= np.linalg.norm(n)
            X, _ = intersect_plane(Ps[0], h, w, n,
                                   -n @ np.array([0.0, 0.0, 5.0]))
            region_mask = ((np.abs(X[..., 0]) < 0.55)
                           & (np.abs(X[..., 1]) < 0.4))
    else:
        raise ValueError(kind)

    params = PRESETS["middlebury"].replace(
        seed=seed, view_selection=False, iterations=iterations,
        pyramid_levels=1, box_hsize=9, box_vsize=9)
    params = params.with_depth_range(depth_min, depth_max, rig.f,
                                     FAKE_BASELINE)
    subset = list(range(1, num_cams))
    with torch.no_grad():
        rect_scene, _ = build_rect_scene(images, rig, subset, params,
                                         depth_min, depth_max, device=device)

    def run(two_stage: bool):
        p = params.replace(rect_two_stage_cull=two_stage,
                           cull_view_stride=2 if two_stage else 1)
        return _run(rect_scene, p, rect_multiview_cost, device)[0]

    d_plain = run(False)
    d_cull = run(True)

    s = np.s_[border:-border, border:-border]
    g = np.asarray(gt)

    def stats(d, mask=None):
        m = np.ones_like(g, bool) if mask is None else mask
        m = m[s] & (d[s] > 0)
        rel = np.abs(d[s][m] - g[s][m]) / g[s][m]
        if rel.size == 0:
            return {"median": float("nan"), "p99": float("nan")}
        return {"median": float(np.median(rel)),
                "p99": float(np.quantile(rel, 0.99))}

    inv = None if region_mask is None else ~region_mask
    return {
        "kind": kind, "shape": (h, w), "iterations": iterations,
        "plain": stats(d_plain), "cull": stats(d_cull),
        "plain_region": stats(d_plain, region_mask),
        "cull_region": stats(d_cull, region_mask),
        "plain_outside": stats(d_plain, inv),
        "cull_outside": stats(d_cull, inv),
    }


def format_hard_scene_markdown(rows: list[dict]) -> str:
    """Render the hard-scene cull-gate rows (PARITY.md section)."""
    lines = [
        "## Two-stage-cull gate on hard scenes (round 5)",
        "",
        "The production cull (sparse 3x3 screen at stride-2 views, full",
        "window for the per-pixel winner only) gated on the scene families",
        "where screening mispicks are most likely: an occluding depth",
        "discontinuity, a textureless patch, and a low-contrast texture.",
        "`region` = discontinuity band / textureless patch; `outside` =",
        "the rest.  Gated in CI by tests/test_cull_hard_scenes.py.",
        "",
        "| scene | shape | plain med/p99 | cull med/p99 "
        "| plain region | cull region | plain outside | cull outside |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        def fmt(st):
            if st is None or not np.isfinite(st.get("median", np.nan)):
                return "—"
            return f"{st['median']:.2e} / {st['p99']:.2e}"
        lines.append(
            "| {k} | {sh} | {p} | {c} | {pr} | {cr} | {po} | {co} |"
            .format(k=r["kind"], sh="x".join(map(str, r["shape"])),
                    p=fmt(r["plain"]), c=fmt(r["cull"]),
                    pr=fmt(r["plain_region"]), cr=fmt(r["cull_region"]),
                    po=fmt(r["plain_outside"]), co=fmt(r["cull_outside"])))
    lines.append("")
    return "\n".join(lines)


def format_markdown(rows: list[dict]) -> str:
    """Render parity rows as the PARITY.md error-budget table."""
    lines = [
        "# Accuracy parity: rect fast path vs exact oracle engine",
        "",
        "Both engines run the full preset schedule (config.PRESETS) on a",
        "matched synthetic slanted-plane scene with identical seeds; the",
        "analytic plane depth is the ground truth.  `gap` is the pixelwise",
        "relative depth difference between the two engines — the isolated",
        "effect of the rect path's documented deviations (rect-frame",
        "windows/gradients, nearest-pixel centering, bf16 tap packing).",
        "Generated by `scripts/parity_presets.py`; the middlebury and",
        "dtu_fast rows are gated in CI (tests/test_parity_presets.py).",
        "",
        "| preset | texture | shape | box | iters | exact med/p99 "
        "| rect med/p99 | gap med/p99 | exact n med° | rect n med° |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            "| {preset} | {tex} | {sh} | {bx} | {it} "
            "| {em:.2e} / {ep:.2e} | {rm:.2e} / {rp:.2e} "
            "| {gm:.2e} / {gp:.2e} | {en:.2f} | {rn:.2f} |".format(
                preset=r["preset"], tex=r.get("texture", "sos"),
                sh="x".join(map(str, r["shape"])),
                bx="x".join(map(str, r["box"])), it=r["iterations"],
                em=r["exact"]["median"], ep=r["exact"]["p99"],
                rm=r["rect"]["median"], rp=r["rect"]["p99"],
                gm=r["gap"]["median"], gp=r["gap"]["p99"],
                en=r["exact_normals"]["median_deg"],
                rn=r["rect_normals"]["median_deg"]))
    lines.append("")
    return "\n".join(lines)
