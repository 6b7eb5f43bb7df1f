"""Coarse-to-fine (pyramid) PatchMatch.

Counterpart of ``gipuma_tpu/models/pyramid.py``: the early iterations run
on 2x-downsampled images, where propagation covers the same physical
distance at a quarter of the sampling cost; each finer level starts from
the upsampled coarser plane field (utils/checkpoint._warm_start_impl —
normals and plane distances are resolution-independent world
quantities).  The reference has no pyramid (it runs every iteration at
full resolution, gipuma.cu:1911-1941).

Levels run on either cost path; a level whose rig cannot be rectified
falls back to the exact path.  Scene builds start on background threads
(``prepare_pyramid(lazy=True)``), so the fine level's build overlaps the
coarse level's device work.  One torch.Generator feeds every level in
turn, in place of the JAX package's per-level ``jax.random.split``.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from ..config import AlgorithmParams
from ..geometry.camera import FAKE_BASELINE, build_rig
from ..ops.cost import multiview_cost
from .patchmatch import finalize, make_generator, run_patchmatch
from .scene import build_scene, ensure_even_width


def downscale2(img: np.ndarray) -> np.ndarray:
    """2x box-filter downscale ([H, W] or [H, W, C]); odd tails cropped."""
    img = np.asarray(img, np.float32)
    h2 = (img.shape[0] // 2) * 2
    w2 = (img.shape[1] // 2) * 2
    im = img[:h2, :w2]
    return 0.25 * (im[0::2, 0::2] + im[1::2, 0::2]
                   + im[0::2, 1::2] + im[1::2, 1::2])


def upsample2_to(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest 2x upsample, cropped/edge-padded to exactly [h, w, ...]."""
    up = np.repeat(np.repeat(a, 2, axis=0), 2, axis=1)
    up = up[:h, :w]
    pad = [(0, h - up.shape[0]), (0, w - up.shape[1])]
    pad += [(0, 0)] * (up.ndim - 2)
    return np.pad(up, pad, mode="edge")


def _up2(a: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """upsample2_to on the device: nearest 2x, cropped / edge-padded to
    exactly [h, w, ...]."""
    up = a.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)[:h, :w]
    ri = torch.arange(h, device=a.device).clamp(max=up.shape[0] - 1)
    ci = torch.arange(w, device=a.device).clamp(max=up.shape[1] - 1)
    return up[ri][:, ci]


def _handoff(state_c, scene_c, scene_f, params_f: AlgorithmParams,
            gen: torch.Generator, cost_fn):
    """Level hand-off on the device: finalize the coarse level, upsample
    depth and world normals 2x, and warm-start the fine level (with the
    coarse cost carried in under config.pyramid_carry_cost, skipping two
    K=1 multiview evaluations)."""
    from ..utils.checkpoint import _warm_start_impl
    depth_c, n_world_c, cost_c = finalize(state_c, scene_c)
    h, w = scene_f.rays.shape[:2]
    cost_up = _up2(cost_c, h, w) if params_f.pyramid_carry_cost else None
    return _warm_start_impl(scene_f, params_f, gen, _up2(depth_c, h, w),
                            _up2(n_world_c, h, w), cost_fn=cost_fn,
                            cost_init=cost_up)


def _level_scene(images_l, rig_l, subset, params_l, depth_min, depth_max,
                 device, ledger=None):
    """(scene, cost_fn) of one level: the rect scene where the level's
    params ask for it and the rig can be rectified, else the exact one.
    ledger: the scan's ShapeBucketLedger (config.rect_quantize_shapes)."""
    if params_l.cost_path == "rect":
        from ..ops.rect_cost import rect_multiview_cost
        from .rect_scene import RectifyUnsupported, build_rect_scene
        # The rect path reads only the base scene's geometry fields.
        base = build_scene(images_l, rig_l, subset, params_l, depth_min,
                           depth_max, lite=True, device=device)
        try:
            scene, _ = build_rect_scene(images_l, rig_l, subset, params_l,
                                        depth_min, depth_max, base=base,
                                        ledger=ledger, device=device)
            return scene, rect_multiview_cost
        except RectifyUnsupported as e:
            print(f"[gipuma_tpu_torch] rect path unavailable at pyramid "
                  f"level ({e}); exact cost path")
    scene = build_scene(images_l, rig_l, subset, params_l, depth_min,
                        depth_max, lite=False, device=device)
    return scene, multiview_cost


def _level_params(params: AlgorithmParams, lvl: int, levels: int,
                 f_l: float, depth_min: float, depth_max: float
                 ) -> AlgorithmParams:
    """Parameters of pyramid level `lvl` (0 = full resolution)."""
    if lvl == levels - 1:
        # The coarsest level starts from random planes.
        params_l = params.replace(iterations=params.iterations,
                                  cull_downscale=1)
    else:
        # Warm-started finer level: the schedule trims (config.pyramid_fine_*).
        params_l = params.replace(
            iterations=params.pyramid_fine_iterations,
            far_propagation=(params.far_propagation
                             and params.pyramid_fine_far),
            refine_rounds_cap=params.pyramid_fine_refine_rounds)
    if lvl > 0 and params.pyramid_coarse_box > 0:
        # Downsampled levels: a smaller pixel window still spans a larger
        # physical footprint (config.pyramid_coarse_box).
        params_l = params_l.replace(
            box_hsize=min(params.pyramid_coarse_box, params.box_hsize),
            box_vsize=min(params.pyramid_coarse_box, params.box_vsize))
    return params_l.with_depth_range(depth_min, depth_max, f_l,
                                     FAKE_BASELINE)


def prepare_pyramid(images: Sequence[np.ndarray],
                    P_matrices: Sequence[np.ndarray],
                    names: Sequence[str], subset: Sequence[int],
                    params: AlgorithmParams, depth_min: float,
                    depth_max: float, lazy: bool = False, device=None,
                    ledger=None):
    """Build every level's scene (coarsest first) on `device` (None: the
    card).  Returns a list of (scene, cost_fn, params_l, (h_l, w_l)); with
    lazy=True, futures of those (run_pyramid takes either), the builds
    running on two background threads.  ledger: the scan's
    ShapeBucketLedger (config.rect_quantize_shapes), keyed per level by
    the level's image shape."""
    from ..pipeline import resolve_device
    device = resolve_device(device)
    levels = max(1, params.pyramid_levels)
    by_level = {0: [np.asarray(im, np.float32) for im in images]}
    for lvl in range(1, levels):
        by_level[lvl] = [downscale2(im) for im in by_level[lvl - 1]]
    prep_in = []
    for lvl in range(levels - 1, -1, -1):
        il = [ensure_even_width(im) for im in by_level[lvl]]
        rig_l = build_rig(P_matrices, names,
                          cam_scale=params.cam_scale * (2 ** lvl))
        prep_in.append((il, rig_l, _level_params(params, lvl, levels, rig_l.f,
                                                 depth_min, depth_max)))

    def level_item(il, rig_l, params_l):
        with torch.no_grad():
            scene, cost_fn = _level_scene(il, rig_l, subset, params_l,
                                          depth_min, depth_max, device,
                                          ledger)
        return scene, cost_fn, params_l, il[0].shape[:2]

    ex = ThreadPoolExecutor(max_workers=2)
    futures = [ex.submit(level_item, *item) for item in prep_in]
    ex.shutdown(wait=not lazy)
    if lazy:
        return futures
    return [f.result() for f in futures]


def run_pyramid(prep, gen: torch.Generator, as_numpy: bool = True):
    """Run the prepared levels (coarsest first, resolved tuples or
    futures); returns (depth, normals_world, cost) at full resolution, as
    numpy arrays or (as_numpy=False) device tensors."""
    if not prep:
        raise ValueError("run_pyramid: empty prep (no pyramid levels)")
    state = prev_scene = scene = None
    with torch.no_grad():
        for item in prep:
            scene, cost_fn, params_l, _ = (
                item.result() if hasattr(item, "result") else item)
            if state is not None:
                state = _handoff(state, prev_scene, scene, params_l, gen,
                                cost_fn)
            state = run_patchmatch(scene, params_l, gen, cost_fn=cost_fn,
                                   state=state)
            prev_scene = scene
        depth, normals, cost = finalize(state, scene)
    if not as_numpy:
        return depth, normals, cost
    return depth.cpu().numpy(), normals.cpu().numpy(), cost.cpu().numpy()


def run_patchmatch_pyramid(images: Sequence[np.ndarray],
                           P_matrices: Sequence[np.ndarray],
                           names: Sequence[str], subset: Sequence[int],
                           params: AlgorithmParams, depth_min: float,
                           depth_max: float, device=None):
    """Full coarse-to-fine run on `device` (None: the card); returns
    (depth, normals_world, cost) numpy.  `params.pyramid_levels` levels:
    the coarsest runs `params.iterations` random-init iterations, each
    finer level `params.pyramid_fine_iterations` warm-started ones."""
    from ..pipeline import resolve_device
    device = resolve_device(device)
    return run_pyramid(
        prepare_pyramid(images, P_matrices, names, subset, params,
                        depth_min, depth_max, lazy=True, device=device),
        make_generator(params.seed, device))
