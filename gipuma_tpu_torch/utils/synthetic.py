"""Synthetic calibrated scenes with analytic ground truth.

The reference has no tests (SURVEY.md §4); its correctness oracle was manual
GT evaluation.  We build a proper pyramid instead, starting from scenes where
the exact depth map is known analytically: textured 3D planes rendered into
N calibrated views.  A correct PatchMatch must (a) give near-zero cost to the
true plane and (b) recover the depth map from random init.
"""
from __future__ import annotations

import numpy as np

from ..geometry.camera import Rig, build_rig


def look_at_R(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World->camera rotation for a camera at `eye` looking at `target`."""
    z = target - eye
    z = z / np.linalg.norm(z)
    up = np.array([0.0, -1.0, 0.0])
    if abs(np.dot(up, z)) > 0.99:
        up = np.array([1.0, 0.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)


def make_ring_P(num_cams: int, h: int, w: int, focal: float,
                radius: float = 0.4, target_depth: float = 5.0,
                jitter: float = 0.0, rng=None) -> list[np.ndarray]:
    """Projection matrices for a small ring of inward-looking cameras.

    Camera 0 sits at the origin looking +z; the others are spread on an arc
    around it, all aimed at (0, 0, target_depth)."""
    rng = rng or np.random.default_rng(0)
    K = np.array([[focal, 0.0, w / 2.0],
                  [0.0, focal, h / 2.0],
                  [0.0, 0.0, 1.0]])
    target = np.array([0.0, 0.0, target_depth])
    Ps = []
    for i in range(num_cams):
        if i == 0:
            eye = np.zeros(3)
        else:
            ang = 2.0 * np.pi * (i - 1) / max(num_cams - 1, 1)
            eye = np.array([radius * np.cos(ang), radius * np.sin(ang), 0.0])
            if jitter:
                eye = eye + rng.normal(scale=jitter, size=3)
        R = look_at_R(eye, target)
        t = -R @ eye
        Ps.append(K @ np.hstack([R, t[:, None]]))
    return Ps


def texture_fn(X: np.ndarray) -> np.ndarray:
    """Smooth analytic texture over 3D points [..., 3] -> intensity 0..255.

    Low-frequency so that bilinear resampling error stays small in tests."""
    x, y = X[..., 0], X[..., 1]
    v = (np.sin(3.1 * x) * np.cos(2.7 * y)
         + 0.6 * np.sin(7.3 * x + 1.0) * np.sin(5.9 * y + 2.0)
         + 0.3 * np.sin(13.0 * x * y + 0.5))
    return (v * 0.25 + 0.5) * 255.0


_NOISE_SEED = 20260821
_NOISE_BANK = None


def texture_fn_noise(X: np.ndarray) -> np.ndarray:
    """Band-limited APERIODIC noise texture over 3D points -> 0..255.

    48 random-direction random-phase Fourier components with frequency
    magnitudes log-uniform over the same band as `texture_fn`'s components
    (2.5-13 rad/unit) — a dense, non-axis-aligned spectrum with no
    near-periodicity.  This is the de-aliased texture class PARITY.md's
    round-3 root-cause note calls for: the near-periodic sum-of-sinusoids
    `texture_fn` produces warp-ambiguous local minima at full scale
    (depth-compensated tilted planes), which is a property of that scene
    family, not of the engines.  Deterministic (fixed seed)."""
    global _NOISE_BANK
    if _NOISE_BANK is None:
        rng = np.random.default_rng(_NOISE_SEED)
        K = 48
        dirs = rng.normal(size=(K, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        mags = np.exp(rng.uniform(np.log(2.5), np.log(13.0), K))
        _NOISE_BANK = ((dirs * mags[:, None]).astype(np.float64),
                       rng.uniform(0.0, 2.0 * np.pi, K))
    F, ph = _NOISE_BANK
    v = np.zeros(X.shape[:-1], np.float64)
    for k0 in range(0, len(F), 8):         # chunk: [h, w, 8] temporaries
        v += np.sin(X @ F[k0:k0 + 8].T + ph[k0:k0 + 8]).sum(-1)
    v /= np.sqrt(len(F) / 2.0)             # ~unit variance
    return np.clip(128.0 + 52.0 * v, 0.0, 255.0)


def texture_fn_noise_lc(X: np.ndarray) -> np.ndarray:
    """Low-contrast variant of the noise texture (~5x lower modulation):
    the hard-scene cull gate's low-texture-evidence family — sparse
    screening has 5x less photometric signal to rank candidates with."""
    v = (texture_fn_noise(X) - 128.0) / 52.0
    return np.clip(128.0 + 10.0 * v, 0.0, 255.0)


def texture_fn_noise_patch(X: np.ndarray) -> np.ndarray:
    """Noise texture with a TEXTURELESS square patch (constant intensity)
    around the scene center (depth-normalized world coords) — exercises
    flat-region behavior: inside the patch every candidate costs the
    same, so screening mispicks are maximally likely there."""
    v = texture_fn_noise(X)
    flat = (np.abs(X[..., 0]) < 0.55) & (np.abs(X[..., 1]) < 0.4)
    return np.where(flat, 128.0, v)


TEXTURES = {"sos": texture_fn, "noise": texture_fn_noise,
            "noise_lc": texture_fn_noise_lc,
            "noise_patch": texture_fn_noise_patch}


def intersect_plane(P: np.ndarray, h: int, w: int,
                    n_world: np.ndarray, d_world: float) -> tuple[np.ndarray, np.ndarray]:
    """Ray/plane intersection for every pixel of camera P.

    Plane: n . X + d = 0 in world coordinates.  Returns (X [h,w,3],
    depth [h,w] along the camera z axis)."""
    M = P[:, :3]
    p4 = P[:, 3]
    M_inv = np.linalg.inv(M)
    C = -M_inv @ p4                      # camera center
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1)
    dirs = pix @ M_inv.T                 # ray directions (unnormalized)
    denom = dirs @ n_world
    tparam = -(d_world + C @ n_world) / denom
    X = C + tparam[..., None] * dirs
    # Depth = third row of P applied to X (w-coordinate; H&Z p.162).
    depth = X @ P[2, :3] + P[2, 3]
    return X, depth


def plane_scene(num_cams: int = 4, h: int = 64, w: int = 80,
                focal: float = 120.0, plane_n=(0.0, 0.0, 1.0),
                plane_depth: float = 5.0,
                slant: tuple[float, float] = (0.0, 0.0),
                radius: float = 0.4, texture: str = "sos"):
    """Render a textured (optionally slanted) plane into `num_cams` views.

    Returns (images list [h,w] float32, rig, gt_depth [h,w] for camera 0,
    plane (n_world, d_world)).
    plane passes through (0, 0, plane_depth); `slant` tilts the normal;
    `radius` is the camera-ring radius in world units (match it to
    plane_depth for realistic triangulation angles — e.g. DTU-like mm
    scenes want radius ~ depth/4, not the unit-scene default).

    The texture is evaluated in DEPTH-NORMALIZED world coordinates so its
    spatial frequency relative to the pixel grid is scale-invariant:
    without this, mm-scale scenes (plane_depth ~600) alias the analytic
    texture into per-pixel noise.
    """
    n = np.array([slant[0], slant[1], 1.0])
    n = n / np.linalg.norm(n)
    d = -n @ np.array([0.0, 0.0, plane_depth])

    Ps = make_ring_P(num_cams, h, w, focal, target_depth=plane_depth,
                     radius=radius)
    tex_scale = 5.0 / plane_depth   # unit scene (depth 5) = identity
    tex = TEXTURES[texture]
    images = []
    gt_depth = None
    for i, P in enumerate(Ps):
        X, depth = intersect_plane(P, h, w, n, d)
        images.append(tex(X * tex_scale).astype(np.float32))
        if i == 0:
            gt_depth = depth.astype(np.float32)
    rig = build_rig(Ps)
    return images, rig, gt_depth, (n, d)


def two_plane_scene(num_cams: int = 5, h: int = 64, w: int = 80,
                    focal: float = 120.0, depth_near: float = 4.0,
                    depth_far: float = 6.0, split: float = 0.45,
                    texture: str = "sos"):
    """A scene with a depth discontinuity: a near plane occupies the left
    `split` fraction of the reference view, a far plane the rest.  Exercises
    occlusion boundaries and propagation across discontinuities.

    Returns (images, rig, gt_depth for camera 0, near_mask).  Rendering
    handles occlusion exactly: for each pixel the nearer plane intersection
    wins; the near plane is finite (a vertical slab in world space), the
    far plane infinite.
    """
    n = np.array([0.0, 0.0, 1.0])
    d_near = -depth_near
    d_far = -depth_far

    # World x extent of the near slab: covers rays through reference pixels
    # x < split*w at depth_near.
    Ps = make_ring_P(num_cams, h, w, focal, target_depth=depth_far)
    K = Ps[0][:, :3]
    x_edge = (split * w - K[0, 2]) / K[0, 0] * depth_near

    images, gt_depth, near_mask = [], None, None
    for i, P in enumerate(Ps):
        Xn, dn = intersect_plane(P, h, w, n, d_near)
        Xf, df = intersect_plane(P, h, w, n, d_far)
        near_valid = (Xn[..., 0] <= x_edge) & (dn > 0)
        use_near = near_valid & ((dn < df) | (df <= 0))
        X = np.where(use_near[..., None], Xn, Xf)
        depth = np.where(use_near, dn, df)
        tex = TEXTURES[texture](X)
        # Distinguish the two surfaces slightly so the discontinuity has
        # image evidence.
        tex = np.where(use_near, tex * 0.85 + 20.0, tex)
        images.append(tex.astype(np.float32))
        if i == 0:
            gt_depth = depth.astype(np.float32)
            near_mask = use_near
    rig = build_rig(Ps)
    return images, rig, gt_depth, near_mask


def plane_scene_for_rig(Ps, h: int, w: int, plane_depth: float,
                        slant: tuple[float, float] = (0.0, 0.0),
                        ref: int = 0, texture: str = "sos"):
    """plane_scene for an arbitrary calibrated rig (such as a real DTU
    camera geometry): render the analytic texture plane placed
    `plane_depth` along the reference camera's principal axis, its normal
    tilted by `slant` in the reference camera frame.

    Returns (images [h,w] float32 list, gt_depth for camera `ref`,
    (n_world, d_world)).
    """
    from ..geometry.camera import decompose_projection

    P0 = np.asarray(Ps[ref], np.float64)
    K0, R0, t0 = decompose_projection(P0)[:3]
    M_inv = np.linalg.inv(P0[:, :3])
    C0 = -M_inv @ P0[:, 3]
    z = R0[2] / np.linalg.norm(R0[2])          # principal axis (world)
    n_cam = np.array([slant[0], slant[1], 1.0])
    n_cam /= np.linalg.norm(n_cam)
    n = R0.T @ n_cam
    point = C0 + plane_depth * z
    d = -n @ point

    tex_scale = 5.0 / plane_depth   # depth-normalized texture frequency
    tex = TEXTURES[texture]
    images, gt_depth = [], None
    for i, P in enumerate(Ps):
        X, depth = intersect_plane(np.asarray(P, np.float64), h, w, n, d)
        images.append(tex(X * tex_scale).astype(np.float32))
        if i == ref:
            gt_depth = depth.astype(np.float32)
    return images, gt_depth, (n, d)
