"""RectScene construction: per-pair rectification + permutation tables.

Counterpart of ``gipuma_tpu/models/rect_scene.py:74-999``.  One-time host
(numpy) setup per reference view; for every selected source view:

1. rectify the (reference, source) pair (geometry/rectify.py) and choose a
   shared rect window covering both warped image footprints plus the cost
   window margin;
2. warp both images into the window (numpy bilinear; the JAX package uses
   cv2 when it imports, the port never does).  The window_grads layout
   ships the images and expands gradient channels and packed source taps
   on the device (``_expand_sdg_device``); the full-channel, grad_fwd and
   f32 layouts stack the gradient channels on the host and pack the source
   taps there (``pack_taps``) or keep them f32;
3. fold the window origin into the plane->disparity map L;
4. build the static 2-pass permutation tables (ops/permute2d.py) and the
   tile masks of the skip machinery.

Raises RectifyUnsupported when no pair can be row-rectified; single
unsupported pairs become invalid views (config.rect_drop_unsupported_views).
Under config.rect_quantize_shapes the scene's shapes round up to coarse
buckets, merged across a scan by a ShapeBucketLedger, with zero-work dummy
views padding the view count.  With config.cull_downscale > 1 (and the
two-stage cull) a nested screening scene is built at 1/cull_downscale of
the resolution over the strided view subset and attached as
``scene.cull``.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from ..config import AlgorithmParams
from ..geometry.camera import Rig
from ..geometry.rectify import rectified_bounds, rectify_pair
from ..ops.permute2d import (build_permute_masks, build_tables,
                             tile_span_blocks)
from ..ops.rect_cost import RectScene
from ..ops.rowgather import _to_i32, pack_taps
from .scene import build_scene, pad_scene_views


class ShapeBucketLedger:
    """Scan-level shape ratchet (config.rect_quantize_shapes), the JAX
    package's ``ShapeBucketLedger`` (rect_scene.py:45-71).

    There it makes every reference view of a scan reuse one compiled
    executable set; the card compiles nothing per shape, and the port
    keeps the ledger so a scan's scenes have the JAX package's shapes and
    ``info["shape_bucket"]``.  run_batch threads one ledger through every
    prepare_job: each scene ratchets its quantized bucket into the entry
    for its image shape and builds at the merged maximum.  Thread-safe:
    run_batch prepares one view ahead on a planner thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._m: dict = {}

    def apply(self, key, bucket: dict) -> dict:
        """Merge `bucket` (monotone static dims) into the entry for `key`
        (elementwise max) and return the merged floor."""
        with self._lock:
            cur = self._m.setdefault(key, dict(bucket))
            for k, v in bucket.items():
                cur[k] = max(cur[k], v)
            return dict(cur)


def _dummy_pair(t):
    """Zero-work placeholder pair (dropped views / view-count padding):
    zero valid extent (hw_valid = (0, 128)), zero tile masks, 8x8 null
    permutation tables.  Its view is invalid (view_valid = 0), and the
    cost loop launches no kernel for an invalid view."""
    return (np.zeros((t[0].shape[0], 8, 128), np.asarray(t[0]).dtype),
            np.zeros((t[1].shape[0], 8, 128), np.asarray(t[1]).dtype),
            np.zeros((3, 3)),
            build_tables(np.zeros((8, 8)), np.zeros((8, 8)), 8, 8),
            build_tables(np.zeros((8, 8)), np.zeros((8, 8)), 8, 8),
            0, 128, 0, (0.0, 1.0), np.zeros((1, 1), np.int32),
            np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int32))


def _gauss_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian anti-alias prefilter for downscaled cull builds ([H, W] or
    [H, W, C] f32): the JAX package's separable numpy convolution (it
    prefers cv2.GaussianBlur when cv2 imports; the port never does), kernel
    radius ceil(3*sigma), edge-replicated borders."""
    if sigma <= 0:
        return img
    rad = max(1, int(np.ceil(3.0 * sigma)))
    xs = np.arange(-rad, rad + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    pad = [(rad, rad), (0, 0)] + [(0, 0)] * (img.ndim - 2)
    a = np.pad(img, pad, mode="edge")
    a = sum(k[i] * a[i:i + img.shape[0]] for i in range(2 * rad + 1))
    pad = [(0, 0), (rad, rad)] + [(0, 0)] * (img.ndim - 2)
    a = np.pad(a, pad, mode="edge")
    return sum(k[i] * a[:, i:i + img.shape[1]] for i in range(2 * rad + 1))


def _gather_reach(hrad: int, params: AlgorithmParams) -> int:
    """Horizontal gather reach (px) of the fused window-cost kernel for a
    window of half-size `hrad`: the outermost sampled column, plus the
    extension-ring increment when gradients come from a ring of extra
    samples rather than doubled one-sided in-window differences
    (ops/pallas_sdg_fused.py XS_EXT)."""
    return hrad + (params.window_increment
                   if params.window_grads
                   and not params.sdg_onesided_edges else 0)


def _np_warp_channels(img: np.ndarray, T: np.ndarray, hr: int, wr: int,
                      lo: np.ndarray, grad_fwd: bool = False,
                      grads: bool = True, grad_step: int = 1) -> np.ndarray:
    """Inverse-warp img [H, W, C] into the rect window and stack gradient
    channels -> [3C, hr, wr] ([C, hr, wr] when grads=False).  The JAX
    package's pure-numpy branch (it prefers cv2.warpPerspective when cv2
    imports; the port never does): bilinear clamp-to-edge, the arithmetic
    in float64 (float32 coordinates and taps, float64 weights), as there.
    gx is the step-`grad_step` central difference, or under grad_fwd the
    2x forward difference matching the in-kernel gx = 2*(v1 - v0) of the
    grad_fwd gather; gy is the step-`grad_step` central difference."""
    h, w = img.shape[:2]
    C = img.shape[2]
    Tinv = np.linalg.inv(np.asarray(T, np.float64))
    # Homography evaluation is separable: three rank-1 grids in float64
    # (precision for the coordinates), bilinear arithmetic in float32.
    xs = np.arange(wr, dtype=np.float64) + lo[0]
    ys = np.arange(hr, dtype=np.float64) + lo[1]
    qx = Tinv[0, 0] * xs[None, :] + (Tinv[0, 1] * ys + Tinv[0, 2])[:, None]
    qy = Tinv[1, 0] * xs[None, :] + (Tinv[1, 1] * ys + Tinv[1, 2])[:, None]
    qz = Tinv[2, 0] * xs[None, :] + (Tinv[2, 1] * ys + Tinv[2, 2])[:, None]
    inv = 1.0 / qz
    xw = np.clip((qx * inv).astype(np.float32), 0.0, np.float32(w - 1))
    yw = np.clip((qy * inv).astype(np.float32), 0.0, np.float32(h - 1))
    x0 = np.minimum(xw.astype(np.int32), w - 2)      # floor: xw >= 0
    y0 = np.minimum(yw.astype(np.int32), h - 2)
    fx = np.clip(xw - x0, 0.0, 1.0)[..., None]
    fy = np.clip(yw - y0, 0.0, 1.0)[..., None]
    flat = img.reshape(-1, C)
    i00 = y0.astype(np.int64) * w + x0
    v00 = flat[i00.ravel()].reshape(hr, wr, C)
    v01 = flat[(i00 + 1).ravel()].reshape(hr, wr, C)
    v10 = flat[(i00 + w).ravel()].reshape(hr, wr, C)
    v11 = flat[(i00 + w + 1).ravel()].reshape(hr, wr, C)
    top = v00 + fx * (v01 - v00)
    bot = v10 + fx * (v11 - v10)
    warped = top + fy * (bot - top)              # [hr, wr, C]
    chw = np.moveaxis(warped, -1, 0)             # [C, hr, wr]
    if not grads:
        return chw
    s = grad_step
    if grad_fwd:
        gx = np.empty_like(chw)
        gx[..., :-1] = 2.0 * (chw[..., 1:] - chw[..., :-1])
        gx[..., -1:] = gx[..., -2:-1]
    else:
        pad = np.concatenate([np.repeat(chw[..., :1], s, axis=-1), chw,
                              np.repeat(chw[..., -1:], s, axis=-1)], axis=-1)
        gx = pad[..., 2 * s:] - pad[..., :-2 * s]
    pad = np.concatenate([np.repeat(chw[..., :1, :], s, axis=-2), chw,
                          np.repeat(chw[..., -1:, :], s, axis=-2)], axis=-2)
    gy = pad[..., 2 * s:, :] - pad[..., :-2 * s, :]
    return np.concatenate([chw, gx, gy], axis=0)         # [3C, hr, wr]


class RectifyUnsupported(ValueError):
    """This rig/pair cannot use the rectified fast path."""


def _affine_fill(vals_y, vals_x, valid, step: int = 16):
    """Replace INVALID grid entries of a sampled 2-D map by a global
    affine (least-squares) fit of its valid samples.

    vals_y/vals_x: [H, W] map outputs; valid: [H, W] bool.  Returns new
    (vals_y, vals_x).  Why: permutation tables are built from projective
    maps whose raw values blow up / flip sign across the horizon line
    (qz -> 0) outside the image footprint, and constant fills jump against
    real values — both create in-tile index spans that grow with
    resolution and break the scratch-window gather bound
    (ops/permute2d.tile_span_blocks).  Non-target slots are never read
    back, so any SMOOTH values work; the affine trend of the map keeps
    the table's local slope (and therefore the span) near the footprint's
    own."""
    H, W = vals_y.shape
    sy, sx = np.mgrid[0:H:step, 0:W:step]
    v = valid[::step, ::step]
    if v.sum() < 8:
        return vals_y, vals_x
    A = np.stack([sx[v], sy[v], np.ones(int(v.sum()))], axis=-1)
    cy, *_ = np.linalg.lstsq(A, vals_y[::step, ::step][v], rcond=None)
    cx, *_ = np.linalg.lstsq(A, vals_x[::step, ::step][v], rcond=None)
    ax = np.arange(W, dtype=np.float64)
    ay = np.arange(H, dtype=np.float64)
    fit_y = (cy[1] * ay + cy[2])[:, None] + (cy[0] * ax)[None, :]
    fit_x = (cx[1] * ay + cx[2])[:, None] + (cx[0] * ax)[None, :]
    return (np.where(valid, vals_y, fit_y),
            np.where(valid, vals_x, fit_x))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _pad_hw(a: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Edge-replicate the trailing [h, w] dims out to [th, tw]."""
    out = np.zeros(a.shape[:-2] + (th, tw), a.dtype)
    ah, aw = a.shape[-2], a.shape[-1]
    out[..., :ah, :aw] = a
    out[..., ah:, :aw] = a[..., -1:, :]
    out[..., :, aw:] = out[..., :, aw - 1:aw]
    return out


def _land(y, x, k: int, h: int, w: int):
    """Coordinates where pixel (y, x) of an [h, w] array lands after
    torch.rot90(a, k) (counter-clockwise).  Accepts real-valued coords."""
    k %= 4
    if k == 0:
        return y, x
    if k == 1:
        return (w - 1) - x, y
    if k == 2:
        return (h - 1) - y, (w - 1) - x
    return x, (h - 1) - y


def _unland(yk, xk, k: int, h: int, w: int):
    """Inverse of `_land`: original (y, x) given rotated coords."""
    k %= 4
    if k == 0:
        return yk, xk
    if k == 1:
        return xk, (w - 1) - yk
    if k == 2:
        return (h - 1) - yk, (w - 1) - xk
    return (h - 1) - xk, yk


def _map_slopes(T_ref: np.ndarray, k: int, h: int, w: int):
    """Slopes of the (k-rotated reference pixel) -> rect map, sampled on a
    stride-4 grid over the valid reference region.

    Returns (du, dv, dyr): signed d(rect_x)/d(p_col), signed
    d(rect_y)/d(p_col), and |d(rect_y)/d(p_row)| — the quantities that
    decide nearest-neighbor table contention (see build_rect_scene)."""
    s_sq = max(h, w)
    ss = np.arange(0, s_sq - 1, 4, dtype=np.float64)
    sk, lk = np.meshgrid(ss, ss, indexing="ij")

    def rect_xy(skk, lkk):
        yy, xx = _unland(skk, lkk, k, h, w)
        q = np.stack([xx, yy, np.ones_like(xx)], -1) @ T_ref.T
        return q[..., 0] / q[..., 2], q[..., 1] / q[..., 2], yy, xx

    x0, y0, yy, xx = rect_xy(sk, lk)
    ok = (yy >= 0) & (yy <= h - 2) & (xx >= 0) & (xx <= w - 2)
    if not ok.any():
        raise ValueError("no valid reference pixels in the rotated grid")
    x_r, y_r, _, _ = rect_xy(sk + 1.0, lk)
    x_c, y_c, _, _ = rect_xy(sk, lk + 1.0)
    du = (x_c - x0)[ok]
    dv = (y_c - y0)[ok]
    dyr = np.abs(y_r - y0)[ok]
    return du, dv, dyr


# Linear part of `_land` acting on (x, y) direction vectors.
_ROT_LIN = {
    0: np.array([[1.0, 0.0], [0.0, 1.0]]),
    1: np.array([[0.0, 1.0], [-1.0, 0.0]]),
    2: np.array([[-1.0, 0.0], [0.0, -1.0]]),
    3: np.array([[0.0, -1.0], [1.0, 0.0]]),
}


def _pick_rotation(T_inv: np.ndarray, center: np.ndarray) -> int:
    """k*90 deg pre-rotation minimizing the residual in-plane rotation of
    the rect->reference map (measured at the rect window center via the
    polar-decomposition angle of the Jacobian)."""
    def refxy(p):
        q = T_inv @ np.array([p[0], p[1], 1.0])
        return q[:2] / q[2]

    p0 = refxy(center)
    jx = refxy(center + [1.0, 0.0]) - p0
    jy = refxy(center + [0.0, 1.0]) - p0
    J = np.stack([jx, jy], axis=1)        # d(ref x,y) / d(rect x,y)
    best_k, best_a = 0, np.inf
    for k in range(4):
        Jk = _ROT_LIN[k] @ J
        ang = abs(np.arctan2(Jk[1, 0] - Jk[0, 1], Jk[0, 0] + Jk[1, 1]))
        if ang < best_a:
            best_k, best_a = k, ang
    return best_k


def _expand_sdg_device(ref_img: torch.Tensor, src_img: torch.Tensor,
                       inc: int):
    """Expand the rect images into the window_grads cost inputs on their
    device.  ref_img/src_img: [V, C, Hrp, Wrp] f16 (edge-replicated into
    the pad region).  Returns (ref_chw [V, 3C] f32 = [img, gx, gy] with the
    step-`inc` central differences, src_packed [V, C] int32 bf16 tap pairs,
    rounded half-to-even exactly as ops/rowgather.pack_taps)."""
    r = ref_img.to(torch.float32)
    H, W = r.shape[-2:]
    rows = torch.arange(H, device=r.device)
    cols = torch.arange(W, device=r.device)
    gy = (r[..., (rows + inc).clamp(max=H - 1), :]
          - r[..., (rows - inc).clamp(min=0), :])
    gx = (r[..., (cols + inc).clamp(max=W - 1)]
          - r[..., (cols - inc).clamp(min=0)])
    ref_chw = torch.cat([r, gx, gy], dim=1)

    s = src_img.to(torch.float32)
    v1 = torch.cat([s[..., 1:], s[..., -1:]], dim=-1)

    def bf16_hi(f):
        b = f.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFFFFFF) >> 16

    return ref_chw, _to_i32((bf16_hi(s) << 16) | bf16_hi(v1))


def build_rect_scene(images: Sequence[np.ndarray], rig: Rig,
                     view_subset: Sequence[int], params: AlgorithmParams,
                     depth_min: float, depth_max: float,
                     base=None, max_blowup: float = 8.0,
                     ledger: ShapeBucketLedger | None = None,
                     rect_scale: float = 1.0,
                     routing_strict: bool = True,
                     device=None) -> tuple[RectScene, dict]:
    """Build the rect-path scene on `device`; returns (RectScene, info).

    `base` lets callers reuse an existing ScenePack (build_scene
    otherwise).  max_blowup: reject pairs whose rect window exceeds this
    multiple of the image area.  ledger: a ShapeBucketLedger shared across
    a scan (config.rect_quantize_shapes).  rect_scale < 1 builds
    downscaled rect grids (config.cull_downscale's screening scene): the
    density normalization and the routing slope targets scale together.
    routing_strict=False accepts whatever plane-routing exactness the
    first build attempt yields (cull scenes: mispicks are ranking noise)
    instead of retrying and raising.  device: None means the card (it
    raises when CUDA is absent); pass "cpu" explicitly for the CPU.

    With config.rect_two_stage_cull + cull_downscale > 1 (and rect_scale
    == 1), a nested cull RectScene is built over the cull_view_stride view
    subset at rect_scale = 1/cull_downscale with the cull window geometry
    and attached as `scene.cull` (info["cull"] holds its info, or
    {"error": ...} when it cannot be built; the sparse pass then reads
    the strided views of this scene, as in the JAX package)."""
    from ..pipeline import resolve_device
    device = resolve_device(device)
    if base is None:
        base = build_scene(images, rig, view_subset, params,
                           depth_min, depth_max, lite=True, device=device)
    ref_img = np.asarray(images[0], np.float32)
    if ref_img.ndim == 2:
        ref_img = ref_img[..., None]
    h, w = ref_img.shape[:2]
    margin = max(params.box_hrad, params.box_vrad) + 2
    ref_cam = rig.cameras[0]
    # Rect layouts: window_grads (packed image words, gradients from window
    # samples), grad_fwd (packed [img, gy] words), or full channels
    # ([img, gx, gy], packed or f32).
    sdg = params.pack_taps and params.window_grads
    gfwd = params.pack_taps and params.grad_fwd_pack and not sdg

    def build_pair(v):
        cam = rig.cameras[v]
        try:
            rect = rectify_pair(ref_cam.K, cam.K, cam.R, cam.t)
            # Density normalization: scale K_new so the reference image's
            # rectified footprint holds as many pixels as the image itself.
            # Keeps the (pixel-unit) cost window the same physical size as
            # the reference engine's, and removes oversampling waste.
            corners = np.array([[0, 0, 1], [w - 1, 0, 1],
                                [w - 1, h - 1, 1], [0, h - 1, 1]], float)
            q = corners @ rect.T_ref.T
            q = q[:, :2] / q[:, 2:3]
            area = 0.5 * abs(sum(
                q[i, 0] * q[(i + 1) % 4, 1] - q[(i + 1) % 4, 0] * q[i, 1]
                for i in range(4)))
            s = float(np.clip(np.sqrt(h * w / max(area, 1.0)),
                              0.25, 4.0)) * rect_scale
            K_base = np.diag([s, s, 1.0]) @ rect.K_new
            rect = rectify_pair(ref_cam.K, cam.K, cam.R, cam.t, K_new=K_base)
        except ValueError as e:
            raise RectifyUnsupported(f"view {v}: {e}") from e

        # Pre-rotation: the rect<->reference maps of off-axis baselines
        # contain up to 180 deg of in-plane rotation; rotating the reference
        # grid by k*90 deg (exact array op at runtime) keeps the residual
        # within +-45 deg.
        lo_r0, hi_r0 = rectified_bounds(rect.T_ref, w, h)
        center0 = 0.5 * (np.asarray(lo_r0) + np.asarray(hi_r0))
        k_rot = _pick_rotation(np.linalg.inv(rect.T_ref), center0)
        s_sq = max(h, w)

        # EXACT plane routing (the rect path's correctness cornerstone).
        # Reference pixel p reads its cost back from target rect pixel
        # q(p) = round(rect position of p); q(p) must hold the cost of p's
        # OWN candidate plane.  Nearest-neighbor 2-pass tables guarantee
        # this only if (a) targets are unique, (b) the return table has no
        # slot contention, (c) the forward table delivers m_p to q(p)
        # conflict-free.  All three hold by construction when the
        # (rotated-)reference -> rect map has slopes >= ~1 in both table
        # directions; we enforce that by post-scaling K_new with
        # S = [[a, b, 0], [0, c, 0], [0, 0, 1]] (a shear in x keeps rows
        # epipolar-aligned; c supersamples rows; a supersamples columns
        # only when shear alone cannot fix the column slope).  Exactness is
        # asserted on the built tables below; violations retry with
        # inflated slopes, then raise RectifyUnsupported.
        # Slope targets use a low quantile, not the min: extreme projective
        # corners would otherwise blow the supersampling factor for the
        # whole window; the few corner pixels whose slopes stay < 1 are
        # counted against the routing-exactness budget below instead.
        # Downscaled builds scale the slope targets with the resolution:
        # enforcing slopes >= 1 at rect_scale 0.5 would supersample right
        # back to full resolution.
        slope_req = float(params.rect_slope_req) * rect_scale
        routing_budget = float(params.rect_routing_budget)
        scale_cap = 2.5
        du, dv, dyr = _map_slopes(rect.T_ref, k_rot, h, w)
        c_scale = float(np.clip(
            slope_req / max(np.quantile(dyr, 0.02), 1e-3), 1.0, scale_cap))
        # Shear choice is AREA-aware, with the TRUE sheared bounding box:
        # the stored window is the bbox of the (ref ∪ src) rectified
        # footprints, and for a residually-ROTATED footprint the right
        # shear x' = a*(x + b*y) SHRINKS the bbox (it re-aligns the quad's
        # long direction with the columns) — the dominant term of the
        # rect grid's pixel inflation.  Measure the bbox width of the 8
        # corner points under each candidate shear exactly instead of the
        # old (w0 + |b|*h0) growth heuristic, which forbade exactly the
        # shears that help.
        cq_r = corners @ rect.T_ref.T
        cq_r = cq_r[:, :2] / cq_r[:, 2:3]
        cq_s = corners @ rect.T_src.T
        cq_s = cq_s[:, :2] / cq_s[:, 2:3]
        c8 = np.concatenate([cq_r, cq_s], axis=0)           # [8, 2]
        bs = np.linspace(-2.0, 2.0, 161)
        # Subsample the slope field for the shear search: the 0.02
        # quantile over ~8k points matches the full grid to ~1e-3 and the
        # [161, n] quantile dominated DTU-scale prep at full n (~160k).
        sl_stride = max(1, du.size // 8192)
        du_s = du[::sl_stride].astype(np.float32)
        dv_s = dv[::sl_stride].astype(np.float32)
        col_slope = np.quantile(
            np.abs(du_s[None] + bs[:, None].astype(np.float32) * dv_s[None]),
            0.02, axis=1)
        a_need = np.clip(slope_req / np.maximum(col_slope, 1e-3),
                         1.0, scale_cap)
        u = c8[None, :, 0] + bs[:, None] * c8[None, :, 1]   # [nb, 8]
        width = a_need * (u.max(axis=1) - u.min(axis=1))
        # Among b's that reach the slope target (after a), prefer least
        # width (height is b-independent, so width ∝ area).
        reach = col_slope * a_need >= slope_req - 1e-6
        if reach.any():
            cand = np.where(reach, width, np.inf)
        else:
            cand = np.where(col_slope * a_need
                            >= (col_slope * a_need).max() - 1e-6,
                            width, np.inf)
        bi = int(np.argmin(cand))
        b_shear = float(bs[bi])
        a_scale = float(a_need[bi])

        built = None
        last_err = "?"
        for attempt in range(3):
            # x' = a*(x + b*y): the shear is scaled WITH a so the slope
            # model a*|du + b*dv| above matches the matrix exactly.
            S = np.array([[a_scale, a_scale * b_shear, 0.0],
                          [0.0, c_scale, 0.0],
                          [0.0, 0.0, 1.0]])
            try:
                rect = rectify_pair(ref_cam.K, cam.K, cam.R, cam.t,
                                    K_new=S @ K_base)
            except ValueError as e:
                raise RectifyUnsupported(f"view {v}: {e}") from e

            lo_r, hi_r = rectified_bounds(rect.T_ref, w, h)
            # Source footprint over the SOURCE image's own dims (they can
            # differ from the reference's under band cropping,
            # parallel/tiled_rect.py).
            h_s, w_s = np.asarray(images[v]).shape[:2]
            lo_s, hi_s = rectified_bounds(rect.T_src, w_s, h_s)
            # Rows: the reference footprint only (cost windows are centered
            # on reference pixels; rows the reference never reaches are
            # dead work).  Columns: the union (source samples land anywhere
            # in the source footprint).
            lo = np.array([np.floor(min(lo_r[0], lo_s[0])),
                           np.floor(lo_r[1])]) - margin
            hi = np.array([np.ceil(max(hi_r[0], hi_s[0])),
                           np.ceil(hi_r[1])]) + margin
            hr = int(hi[1] - lo[1]) + 1
            wr = _round_up(int(hi[0] - lo[0]) + 1, 128)
            # Distortion guard: the REFERENCE footprint QUAD area (density-
            # normalized, then deliberately supersampled by a*c) should stay
            # near the image area; a large excess means near-epipole
            # distortion that the clipped density normalization could not
            # remove.  Quad area, not bbox: the shear tilts the footprint
            # without inflating it.
            cq = corners @ rect.T_ref.T
            cq = cq[:, :2] / cq[:, 2:3]
            quad = 0.5 * abs(sum(
                cq[i, 0] * cq[(i + 1) % 4, 1] - cq[(i + 1) % 4, 0] * cq[i, 1]
                for i in range(4)))
            if quad > max_blowup * h * w * a_scale * c_scale:
                raise RectifyUnsupported(
                    f"view {v}: rect ref footprint {quad:.0f}px^2 exceeds "
                    f"{max_blowup}x the image area — epipole too close to "
                    f"the image")
            if hr * wr > 4.0 * max_blowup * h * w * a_scale * c_scale:
                raise RectifyUnsupported(
                    f"view {v}: rect window {hr}x{wr} too large (bbox "
                    f"blow-up) for the {max_blowup}x budget")

            T_inv = np.linalg.inv(rect.T_ref)

            # Rect-pixel pre-images on the k-rotated reference grid.
            # Rank-1 separable homography evaluation (row/col 1-D parts
            # instead of an [hr, wr, 3] stack @ matmul — the full-size f64
            # temporaries dominated prep at DTU scale).
            xg = np.arange(wr, dtype=np.float64) + lo[0]
            yg = np.arange(hr, dtype=np.float64) + lo[1]
            qx = T_inv[0, 0] * xg[None, :] + \
                (T_inv[0, 1] * yg + T_inv[0, 2])[:, None]
            qy_h = T_inv[1, 0] * xg[None, :] + \
                (T_inv[1, 1] * yg + T_inv[1, 2])[:, None]
            qz = T_inv[2, 0] * xg[None, :] + \
                (T_inv[2, 1] * yg + T_inv[2, 2])[:, None]
            inv_z = 1.0 / qz
            xr = qx * inv_z
            yr = qy_h * inv_z
            in_ref = ((xr > -0.5) & (xr < w - 0.5)
                      & (yr > -0.5) & (yr < h - 0.5))
            yk, xk = _land(yr, xr, k_rot, h, w)

            # Reference-pixel rect positions (k-rotated full grid; the
            # compressed half-grid's active-x zigzag breaks smoothness, so
            # the cost_fn un-rotates and compresses afterwards).
            # _unland is an affine coordinate permutation, so both the
            # un-rotated coords and the homography numerators are rank-1
            # separable in (sk, lk) — probe the three basis points instead
            # of building [s_sq, s_sq, 3] stacks (prep hot path).
            ss = np.arange(s_sq, dtype=np.float64)
            y00, x00 = _unland(0.0, 0.0, k_rot, h, w)
            y10, x10 = _unland(1.0, 0.0, k_rot, h, w)
            y01, x01 = _unland(0.0, 1.0, k_rot, h, w)
            cys, cyl = y10 - y00, y01 - y00
            cxs, cxl = x10 - x00, x01 - x00
            yy = (y00 + cys * ss)[:, None] + (cyl * ss)[None, :]
            xx = (x00 + cxs * ss)[:, None] + (cxl * ss)[None, :]
            orig_ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            Tr = rect.T_ref

            def _q(j):
                rs = (Tr[j, 0] * cxs + Tr[j, 1] * cys) * ss
                cs = (Tr[j, 0] * cxl + Tr[j, 1] * cyl) * ss + (
                    Tr[j, 0] * x00 + Tr[j, 1] * y00 + Tr[j, 2])
                return rs[:, None] + cs[None, :]

            with np.errstate(invalid="ignore", divide="ignore"):
                qa_inv = 1.0 / _q(2)
                xl = _q(0) * qa_inv - lo[0]
                yl = _q(1) * qa_inv - lo[1]
            sk = np.broadcast_to(np.arange(s_sq)[:, None], (s_sq, s_sq))
            lk = np.broadcast_to(np.arange(s_sq)[None, :], (s_sq, s_sq))
            # Smooth (affine-trend) fill for slots outside the image:
            # raw projective values explode near the horizon and constant
            # fills jump — both blow the per-tile span at scale.
            yl, xl = _affine_fill(yl, xl, orig_ok)
            qy = np.clip(np.round(yl).astype(np.int64), 0, hr - 1)
            qx = np.clip(np.round(xl).astype(np.int64), 0, wr - 1)

            n_valid = int(orig_ok.sum())

            # (a) duplicate read-back targets: the later writer wins the
            # fwd slot, the other p reads a neighbor-plane cost.
            flat_q = (qy * wr + qx)[orig_ok]
            n_dup = flat_q.size - len(np.unique(flat_q))

            # (b) return table: p -> q(p) slot contention.
            ret = build_tables(qy, qx, hr, wr, valid=orig_ok,
                               fill_mode="affine")
            n_bad_ret = int(ret.affected[orig_ok].sum())

            # (c) forward table: deliver m_p to q(p); ONLY targets are
            # writers (non-target rect pixels' m is never read back — their
            # slots take the smooth fill, keeping gather spans bounded).
            tgt = np.zeros((hr, wr), bool)
            # Base = the rect -> rotated-reference map with its
            # beyond-the-footprint values replaced by the affine trend
            # (the projective pre-image flips sign across the horizon
            # line, which would put full-grid jumps inside tiles).
            yk_s, xk_s = _affine_fill(yk, xk, in_ref)
            R_f = np.clip(np.round(yk_s), 0, s_sq - 1)
            C_f = np.clip(np.round(xk_s), 0, s_sq - 1)
            tgt[qy[orig_ok], qx[orig_ok]] = True
            R_f[qy[orig_ok], qx[orig_ok]] = sk[orig_ok]
            C_f[qy[orig_ok], qx[orig_ok]] = lk[orig_ok]
            fwd = build_tables(R_f, C_f, s_sq, s_sq, valid=tgt,
                               fill_mode="affine")
            n_bad_fwd = int(fwd.affected[tgt].sum())

            bad_frac = (n_dup + n_bad_ret + n_bad_fwd) / max(n_valid, 1)
            if bad_frac <= routing_budget or not routing_strict:
                built = (rect, lo, hr, wr, in_ref, orig_ok, fwd, ret,
                         tgt, bad_frac, (qy, qx, R_f, C_f))
                break
            last_err = (f"plane routing {bad_frac:.2%} inexact "
                        f"(dup {n_dup}, ret {n_bad_ret}, fwd {n_bad_fwd})")
            c_scale = min(c_scale * 1.2, 4.0)
            a_scale = min(a_scale * 1.2, 4.0)
        if built is None:
            raise RectifyUnsupported(f"view {v}: {last_err}")
        (rect, lo, hr, wr, in_ref, orig_ok, fwd, ret, tgt, bad_frac,
         tbl_inputs) = built

        src_img = np.asarray(images[v], np.float32)
        if src_img.ndim == 2:
            src_img = src_img[..., None]

        if sdg:
            # Warp only the two images; the gradient channels and the tap
            # packing are expanded on the device (_expand_sdg_device).
            ref_rect = _np_warp_channels(ref_img, rect.T_ref, hr, wr, lo,
                                         grads=False)
            src_rect = _np_warp_channels(src_img, rect.T_src, hr, wr, lo,
                                         grads=False)
        else:
            ref_rect = _np_warp_channels(ref_img, rect.T_ref, hr, wr, lo,
                                         grad_fwd=gfwd)
            src_rect = _np_warp_channels(src_img, rect.T_src, hr, wr, lo)
            if params.pack_taps:
                # Both bilinear taps as bf16 pairs in one int32 word; under
                # grad_fwd only the [img, gy] words (gx comes from the
                # image taps in the gather).
                if gfwd:
                    cc = src_rect.shape[0] // 3
                    src_rect = pack_taps(np.concatenate(
                        [src_rect[:cc], src_rect[2 * cc:]], axis=0))
                else:
                    src_rect = pack_taps(src_rect)

        # abc_local = L @ m with the window origin folded in:
        # disp = a*x̂g + b*ŷg + c and x̂g = x̂ + lo_x  =>  c' = c + a*lo_x + b*lo_y.
        L_global = -(rect.f_new * rect.baseline) * rect.M.T
        shift = np.array([[1.0, 0.0, 0.0],
                          [0.0, 1.0, 0.0],
                          [lo[0], lo[1], 1.0]])
        L_local = shift @ L_global

        # Disparity clamp for cost evaluation (rect pixels): the depth range
        # maps to [f_new*B/depth_max, f_new*B/depth_min]; the margin admits
        # slanted-window extrapolation beyond the center disparity (window
        # reach (hrad+inc) px times the plane's |disparity slope|, which the
        # cost's gradient correction clamps at ~0.75 — see rect_cost).  The
        # clamp range feeds the static gather-span bound below: a tight
        # margin is a direct kernel speedup (one fewer 128-lane span block
        # is ~25% of the fused kernel's gather work at dino scale).
        fb = rect.f_new * rect.baseline
        dmargin = float(params.disp_clamp_margin)
        d_lo = fb / depth_max - dmargin
        d_hi = fb / depth_min + dmargin

        # Permutation-table span bound, per pair: a too-distorted map
        # cannot use the scratch-window gather (ops/permute2d).
        def _span(f, r):
            return max(tile_span_blocks(f.c1),
                       tile_span_blocks(f.r, transposed=True),
                       tile_span_blocks(r.c1),
                       tile_span_blocks(r.r, transposed=True))

        span_p = _span(fwd, ret)
        if span_p > 6:
            # The cheap affine fill rarely (never on the tested rigs)
            # inflates the span; when it does, pay for the per-column
            # inverse-interpolation fill before giving up on the pair.
            qy_i, qx_i, R_fi, C_fi = tbl_inputs
            ret = build_tables(qy_i, qx_i, hr, wr, valid=orig_ok)
            fwd = build_tables(R_fi, C_fi, s_sq, s_sq, valid=tgt)
            span_p = _span(fwd, ret)
        if span_p > 6:
            raise RectifyUnsupported(
                f"view {v}: permutation tables need {span_p} 128-col "
                "blocks per tile (map too distorted for the "
                "scratch-window gather)")

        # Fused-kernel and permutation tile masks, all derived from the
        # read-back-target set (see ops/permute2d.build_permute_masks for
        # the three mask geometries and their skip contracts).
        tile_ok, fwd2_ok, ret2_ok = build_permute_masks(
            tgt, hr, wr, s_sq, k_rot, h, w)

        pair = (ref_rect, src_rect, L_local, fwd, ret, hr, wr,
                k_rot, (d_lo, d_hi), tile_ok, fwd2_ok, ret2_ok)
        pinfo = {
            "view": v, "rect_shape": (hr, wr), "rot_k": k_rot,
            "scales": (round(a_scale, 3), round(b_shear, 3),
                       round(c_scale, 3)),
            "span_perm": span_p,
            # Fraction of rect tiles holding read-back targets (the fused
            # kernel evaluates only these under rect_footprint_skip).
            "tile_ok_frac": float(tile_ok.mean()),
            # Plane-routing exactness, verified at build (<= 0.5%).
            "routing_bad_frac": bad_frac,
            "fwd_affected_frac": float(fwd.affected[tgt].mean()),
            "ret_affected_frac": float(ret.affected[orig_ok].mean()),
        }
        return pair, pinfo

    def build_pair_safe(v):
        try:
            return build_pair(v)
        except RectifyUnsupported as e:
            return None, {"view": v, "error": str(e)}

    # Pairs are independent; numpy releases the GIL on the big ops.
    with ThreadPoolExecutor(max_workers=min(4, len(view_subset))) as ex:
        built_pairs = list(ex.map(build_pair_safe, view_subset))

    # Unsupported pairs become INVALID views (view_valid = 0, zero extent =
    # zero kernel work) instead of failing the whole reference view
    # (config.rect_drop_unsupported_views).
    dropped = [pi for p, pi in built_pairs if p is None]
    good = [p for p, _ in built_pairs if p is not None]
    if dropped and (not params.rect_drop_unsupported_views or not good):
        raise RectifyUnsupported("; ".join(d["error"] for d in dropped))
    if dropped:
        print(f"[gipuma_tpu_torch] rect path: dropping "
              f"{len(dropped)}/{len(view_subset)} unsupported view(s) "
              f"{[d['view'] for d in dropped]} (invalid-view cost)")
        dummy = _dummy_pair(good[0])
        built_pairs = [(p if p is not None else dummy, pi)
                       for p, pi in built_pairs]
        vv = base.view_valid.clone()
        vv[[i for i, (p, _) in enumerate(built_pairs) if p is dummy]] = 0.0
        base = base._replace(view_valid=vv)

    per_pair = [p for p, _ in built_pairs]
    info = {"pairs": [pi for _, pi in built_pairs],
            "dropped_views": [d["view"] for d in dropped]}

    hrp = _round_up(max(p[5] for p in good), 8)
    wrp = max(p[6] for p in good)
    s_sq = max(h, w)
    max_range = max(p[8][1] - p[8][0] for p in good)
    span_perm = max(pi["span_perm"] for _, pi in built_pairs
                    if "span_perm" in pi)

    if params.rect_quantize_shapes:
        # Shape quantization, as in the JAX package (rect_scene.py:
        # 800-827): round the rect pads, the view count (zero-work dummy
        # views), the clamp range feeding the gather-span bound and the
        # permutation span up to coarse buckets, merged across the scan by
        # the ledger.  Padded rows, columns and views are skipped work.
        hrp = _round_up(hrp, _round_up(max(
            8, int(params.rect_quantum_rows)), 8))
        wrp = _round_up(wrp, _round_up(max(
            128, int(params.rect_quantum_cols)), 128))
        q = max(1.0, float(params.rect_quantum_range))
        max_range = float(np.ceil(max_range / q) * q)
        span_perm = _round_up(span_perm, 2)
        vt = max(len(per_pair),
                 int(params.rect_pad_views_to) or int(params.max_views))
        if ledger is not None:
            fl = ledger.apply(
                (h, w, round(rect_scale, 4)),
                dict(hrp=hrp, wrp=wrp, max_range=max_range,
                     span_perm=span_perm, views=vt))
            hrp, wrp, vt = fl["hrp"], fl["wrp"], fl["views"]
            max_range, span_perm = fl["max_range"], fl["span_perm"]
        if vt > len(per_pair):
            per_pair = per_pair + [_dummy_pair(good[0])] * (vt
                                                            - len(per_pair))
            base = pad_scene_views(base, vt)
    info["shape_bucket"] = dict(hrp=hrp, wrp=wrp, views=len(per_pair),
                                max_range=max_range, span_perm=span_perm)

    def assemble(arrs, th, tw, f16_ok=False) -> torch.Tensor:
        """Zero-pad each [..., h, w] array to [th, tw], stack over a new
        view axis and ship once: integer words as int32, floats as
        float32.  As the JAX package ships them: float32 arrays round
        through f16 where f16_ok (float64 ones — the numpy warp's — and
        tables do not; the tables' f16 / int16 transfer there carries the
        same integers)."""
        a0 = np.asarray(arrs[0])
        dt = np.int32 if a0.dtype.kind in "iu" else np.float32
        out = np.zeros((len(arrs),) + a0.shape[:-2] + (th, tw), dt)
        for i, a in enumerate(arrs):
            a = np.asarray(a)
            if f16_ok and a.dtype == np.float32:
                a = a.astype(np.float16)
            out[i, ..., :a.shape[-2], :a.shape[-1]] = a
        return torch.from_numpy(out).to(device)

    if sdg:
        # Ship the two f16 images per pair (edge-replicated into the pad)
        # and expand to [img, gx, gy] ref channels + packed src words on
        # the device.
        ref_f16 = torch.from_numpy(np.stack([_pad_hw(
            np.asarray(p[0], np.float16), hrp, wrp) for p in per_pair])
        ).to(device)
        src_f16 = torch.from_numpy(np.stack([_pad_hw(
            np.asarray(p[1], np.float16), hrp, wrp) for p in per_pair])
        ).to(device)
        ref_rect, src_rect = _expand_sdg_device(
            ref_f16, src_f16, inc=params.window_increment)
    else:
        ref_rect = assemble([p[0] for p in per_pair], hrp, wrp, f16_ok=True)
        src_rect = assemble([p[1] for p in per_pair], hrp, wrp,
                            f16_ok=not params.pack_taps)
    L = torch.as_tensor(np.stack([p[2] for p in per_pair]),
                        dtype=torch.float32, device=device)
    fwd_c1 = assemble([p[3].c1 for p in per_pair], s_sq, wrp)
    fwd_r = assemble([p[3].r for p in per_pair], hrp, wrp)
    ret_c1 = assemble([p[4].c1 for p in per_pair], hrp, s_sq)
    ret_r = assemble([p[4].r for p in per_pair], s_sq, s_sq)
    rot_host = tuple(int(p[7]) for p in per_pair)
    valid_host = tuple(bool(v) for v in base.view_valid.tolist())
    rot_k = torch.as_tensor(rot_host, dtype=torch.int32, device=device)
    disp_bounds = torch.as_tensor(
        np.asarray([p[8] for p in per_pair], np.float32), device=device)
    hw_valid = torch.as_tensor(
        np.asarray([(p[5], p[6]) for p in per_pair], np.int32),
        device=device)

    def masks(idx, th, tw):
        out = np.zeros((len(per_pair), th, tw), np.int32)
        for i, p in enumerate(per_pair):
            m = p[idx]
            out[i, :m.shape[0], :m.shape[1]] = m
        return torch.from_numpy(out).to(device)

    # Per-view tile masks, zero-padded onto the common tile grids (zeros =
    # skip; pad rows/cols and dummy views do no work).
    s8, s128 = -(-s_sq // 8), -(-s_sq // 128)
    tile_ok = masks(9, hrp // 8, wrp // 128)
    fwd2_ok = masks(10, wrp // 8, -(-hrp // 128))
    ret2_ok = masks(11, s8, s128)

    # Static gather-span bounds, kept in spans.shape as in the JAX package
    # (TPU scratch-window sizes; the CUDA kernels read true samples).
    reach = _gather_reach(params.box_hrad, params)
    if params.rect_two_stage_cull:
        reach = max(reach, _gather_reach(
            int(params.cull_box) // 2,
            params.replace(window_increment=int(params.cull_increment))))
    span_sample = int(np.ceil((132.0 + 2 * reach + max_range) / 128.0)) + 1
    spans = torch.zeros((span_sample, span_perm), dtype=torch.int8,
                        device=device)

    scene = RectScene(base=base, ref_rect=ref_rect, src_rect=src_rect, L=L,
                      fwd_c1=fwd_c1, fwd_r=fwd_r, ret_c1=ret_c1, ret_r=ret_r,
                      rot_k=rot_k, disp_bounds=disp_bounds, spans=spans,
                      hw_valid=hw_valid, tile_ok=tile_ok,
                      fwd2_ok=fwd2_ok, ret2_ok=ret2_ok, rot_k_host=rot_host,
                      valid_host=valid_host)
    info["rect_shape_padded"] = (hrp, wrp)
    info["spans"] = (span_sample, span_perm)

    # Nested screening scene (config.cull_downscale): downscaled rect grids
    # over the strided view subset, built with the cull window geometry so
    # its gradient channels, spans and masks match the sparse pass.  A
    # build that cannot rectify leaves the sparse pass on the strided views
    # of this scene (ops/rect_cost._slice_views), as in the JAX package.
    cds = int(params.cull_downscale)
    if (rect_scale == 1.0 and cds > 1 and params.rect_two_stage_cull
            and params.pack_taps and params.window_grads):
        stride = max(1, int(params.cull_view_stride))
        sub_c = list(view_subset)[::stride]
        vt_main = max(len(view_subset),
                      int(params.rect_pad_views_to) or int(params.max_views))
        params_c = params.replace(
            box_hsize=int(params.cull_box), box_vsize=int(params.cull_box),
            window_increment=int(params.cull_increment),
            rect_two_stage_cull=False, cull_downscale=1,
            rect_pad_views_to=-(-vt_main // stride))
        # Anti-alias prefilter: the downscaled warp decimates the images
        # ~cds-fold, and point sampling would alias.  sigma =
        # 0.5*sqrt(cds^2 - 1), the standard pyramid prefilter; the state
        # grid is unchanged, only the warped rect channels see the blur.
        sigma = 0.5 * float(np.sqrt(cds * cds - 1.0))
        images_c = [_gauss_blur(np.asarray(im, np.float32), sigma)
                    for im in images]
        try:
            cull_scene, cull_info = build_rect_scene(
                images_c, rig, sub_c, params_c, depth_min, depth_max,
                base=None, max_blowup=max_blowup, ledger=ledger,
                rect_scale=1.0 / cds, routing_strict=False, device=device)
            scene = scene._replace(cull=cull_scene)
            info["cull"] = cull_info
        except RectifyUnsupported as e:
            info["cull"] = {"error": str(e)}
    return scene, info
