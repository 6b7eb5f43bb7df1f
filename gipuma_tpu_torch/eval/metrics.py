"""Ground-truth evaluation metrics — capability of groundTruthUtils.h:22-139
(computeError / computeNormalError): error rates at two disparity/depth
tolerances, non-occluded and valid-masked variants, and angular normal
errors, plus error-map images for debugging.

A numpy copy of ``gipuma_tpu/eval/metrics.py:32-127``: host-side
reductions over one map each (numpy in, numpy out); the port keeps its
own.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DepthErrorReport:
    error_rate: float            # fraction with |d - gt| >= tol (gt valid)
    error_rate_tol2: float       # same at the second tolerance
    error_rate_nocc: float       # non-occluded pixels only (NaN if no mask)
    error_rate_valid: float      # only pixels the algorithm marked valid
    mean_abs_error: float
    valid_fraction: float        # fraction of gt-valid pixels with output
    # The reference's five error visualizations (main.cpp:1123-1139,
    # groundTruthUtils.h:22-95): two tolerances x overall/non-occluded,
    # plus the algorithm-valid-masked map.  All bool [H, W]; the nocc maps
    # are None without an occlusion mask.
    error_map: np.ndarray        # at tol, all gt-valid pixels
    error_map_tol2: np.ndarray | None = None
    error_map_nocc: np.ndarray | None = None
    error_map_nocc_tol2: np.ndarray | None = None
    error_map_masked: np.ndarray | None = None


def depth_error(depth: np.ndarray, gt: np.ndarray, tol: float,
                tol2: float | None = None,
                occlusion_mask: np.ndarray | None = None,
                valid: np.ndarray | None = None) -> DepthErrorReport:
    """Per-pixel absolute-difference error rates (computeError capability).

    gt <= 0 or non-finite marks pixels without ground truth.  `occlusion
    mask` True = occluded.  `valid` True = algorithm output valid (e.g.
    cost < threshold).
    """
    depth = np.asarray(depth, np.float64)
    gt = np.asarray(gt, np.float64)
    has_gt = np.isfinite(gt) & (gt > 0)
    diff = np.abs(depth - gt)
    bad = (diff >= tol) | ~np.isfinite(depth)
    tol2 = tol2 if tol2 is not None else 2 * tol
    bad2 = (diff >= tol2) | ~np.isfinite(depth)

    def rate(err, mask):
        m = has_gt & mask
        return float(err[m].mean()) if m.any() else float("nan")

    all_mask = np.ones_like(has_gt)
    nocc = (~occlusion_mask if occlusion_mask is not None else None)
    out_valid = (valid if valid is not None
                 else np.isfinite(depth) & (depth > 0))
    return DepthErrorReport(
        error_rate=rate(bad, all_mask),
        error_rate_tol2=rate(bad2, all_mask),
        error_rate_nocc=(rate(bad, nocc) if nocc is not None else float("nan")),
        error_rate_valid=rate(bad, out_valid),
        mean_abs_error=float(diff[has_gt & np.isfinite(diff)].mean())
        if has_gt.any() else float("nan"),
        valid_fraction=float(out_valid[has_gt].mean()) if has_gt.any() else 0.0,
        error_map=bad & has_gt,
        error_map_tol2=bad2 & has_gt,
        error_map_nocc=(bad & has_gt & nocc) if nocc is not None else None,
        error_map_nocc_tol2=(bad2 & has_gt & nocc) if nocc is not None
        else None,
        error_map_masked=bad & has_gt & out_valid,
    )


@dataclasses.dataclass
class NormalErrorReport:
    error_rate_02: float   # fraction with angular error >= 0.2 rad
    error_rate_03: float   # ... >= 0.3 rad
    mean_angle_rad: float
    angle_map: np.ndarray  # [H, W] radians


def normal_error(normals: np.ndarray, gt_normals: np.ndarray,
                 mask: np.ndarray | None = None) -> NormalErrorReport:
    """Angular error between unit normal maps (computeNormalError capability,
    tolerances 0.2/0.3 rad as in groundTruthUtils.h:96-135)."""
    n = np.asarray(normals, np.float64)
    g = np.asarray(gt_normals, np.float64)
    valid = (np.isfinite(n).all(-1) & np.isfinite(g).all(-1)
             & (np.linalg.norm(g, axis=-1) > 1e-6))
    if mask is not None:
        valid &= mask
    dot = np.clip(np.abs((n * g).sum(-1)
                         / np.maximum(np.linalg.norm(n, axis=-1)
                                      * np.linalg.norm(g, axis=-1), 1e-12)),
                  -1.0, 1.0)
    ang = np.arccos(dot)
    ang_v = ang[valid]
    return NormalErrorReport(
        error_rate_02=float((ang_v >= 0.2).mean()) if valid.any() else float("nan"),
        error_rate_03=float((ang_v >= 0.3).mean()) if valid.any() else float("nan"),
        mean_angle_rad=float(ang_v.mean()) if valid.any() else float("nan"),
        angle_map=np.where(valid, ang, np.nan),
    )


def accuracy_completeness(points: np.ndarray, gt_points: np.ndarray,
                          max_dist: float = np.inf,
                          sample: int | None = 50000,
                          seed: int = 0) -> tuple[float, float]:
    """DTU-style point-cloud metrics: accuracy = median distance from
    reconstruction to GT, completeness = median distance from GT to
    reconstruction (both optionally subsampled for tractability)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    P = np.asarray(points, np.float64)
    G = np.asarray(gt_points, np.float64)
    if sample and len(P) > sample:
        P = P[rng.choice(len(P), sample, replace=False)]
    if sample and len(G) > sample:
        G = G[rng.choice(len(G), sample, replace=False)]
    d_acc = cKDTree(G).query(P, k=1)[0]
    d_comp = cKDTree(P).query(G, k=1)[0]
    d_acc = d_acc[d_acc <= max_dist]
    d_comp = d_comp[d_comp <= max_dist]
    return float(np.median(d_acc)), float(np.median(d_comp))
