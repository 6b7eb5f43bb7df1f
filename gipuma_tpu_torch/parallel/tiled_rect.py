"""Tile x view composition on the rectified path.

Counterpart of ``gipuma_tpu/parallel/tiled_rect.py``.  One depth-map job is
sharded two ways at once:

* ``tile`` axis — horizontal row bands of the reference image.  Each band
  is a rect sub-scene of its own (per-pair tables built from a row-cropped
  reference camera), so a rank holds only its band's rect imagery, tables
  and slice of every source view's rect storage;
* ``view`` axis — the source views of the multiview cost inside each band
  (parallel/sharded.view_sharded_cost_fn), one all-gather per evaluation.

Every band carries ``margin`` extra rows on each side (the propagation
reach and the cost window's vertical reach).  Before every propagation
sub-sweep the overlap rows are overwritten with the neighbouring band's
owned boundary rows (``batch_isend_irecv`` on the tile group), so the owned
rows read the planes a single-band sweep would; the final stitch drops
the overlap rows.  Geometry stays global: band ScenePacks keep the whole
rig's cameras and address pixels by global y (ScenePack.row_offset,
negative for band 0's top margin, whose rows every propagation check
rejects).  Only the rect tables see the cropped camera.

Deviations from a single-band run, as in the JAX package: per-band
rectification windows, and per-band random streams for the init and the
refinement (``tiled.tile_generator(params.seed, tile index)``).  Tile
generators are equal on the ranks of one tile, so the view group's states
stay equal.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import AlgorithmParams
from ..geometry.camera import Rig
from ..models.patchmatch import (CLOSE_OFFSETS, FAR_OFFSETS, PMState,
                                 finalize, init_state, propagation_sweep,
                                 refinement_sweep)
from ..models.rect_scene import build_rect_scene
from ..models.scene import build_scene
from ..ops.cost import ScenePack
from ..ops.rect_cost import RectScene
from .mesh import axis
from .sharded import local_views, pad_rect_scene_views, view_sharded_cost_fn
from .tiled import tile_generator


def _crop_ref_rig(rig: Rig, r0: int) -> Rig:
    """A rig whose reference camera sees rows shifted by -r0 (a pure row
    crop: K' = S K with S = [[1,0,0],[0,1,-r0],[0,0,1]]).  Source cameras
    keep their intrinsics: only the reference K enters the rectification
    homography."""
    S = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, -float(r0)], [0.0, 0.0, 1.0]])
    ref = rig.cameras[0]
    Kc = S @ ref.K
    ref_c = dataclasses.replace(ref, K=Kc, K_inv=np.linalg.inv(Kc))
    return dataclasses.replace(rig, cameras=[ref_c] + list(rig.cameras[1:]),
                               K_ref=S @ rig.K_ref,
                               K_ref_inv=np.linalg.inv(S @ rig.K_ref))


def _slice_pack_rows(pack: ScenePack, idx: np.ndarray, r0: int) -> ScenePack:
    """Band view of a lite ScenePack: its per-pixel rows gathered by the
    (clamped) global index, row_offset set so pixels keep their global y."""
    rows = torch.as_tensor(np.asarray(idx), device=pack.rays.device)
    return pack._replace(
        rays=pack.rays[rows], view_vec=pack.view_vec[rows],
        texture_ok=pack.texture_ok[rows],
        row_offset=torch.tensor(int(r0), dtype=torch.int32,
                                device=pack.rays.device))


def _edge_pad(a: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """`a` grown to `size` along `dim` by repeating its last slice."""
    if a.shape[dim] == size:
        return a
    idx = torch.arange(size, device=a.device).clamp(max=a.shape[dim] - 1)
    return a.index_select(dim, idx)


def _zero_pad(a: torch.Tensor | None, sizes: dict) -> torch.Tensor | None:
    """`a` grown with zeros to sizes[dim] along each dim named."""
    if a is None:
        return None
    shape = list(a.shape)
    for dim, size in sizes.items():
        shape[dim] = size
    if tuple(shape) == tuple(a.shape):
        return a
    out = a.new_zeros(shape)
    out[tuple(slice(0, n) for n in a.shape)] = a
    return out


def _repad_rect(scene: RectScene, hrp: int, wrp: int) -> RectScene:
    """A band RectScene's rect-shaped arrays grown to a common [hrp, wrp].

    Permutation tables grow by edge replication, as in the JAX package;
    imagery and the tile masks (tile_ok [V, Hrp/8, Wrp/128], fwd2_ok [V,
    Wrp/8, ceil(Hrp/128)]: zero = the kernels skip the tile) with zeros.
    The port keeps no first-pass or scratch-span masks to pad."""
    h0, w0 = scene.ref_rect.shape[-2:]
    if (h0, w0) == (hrp, wrp):
        return scene
    return scene._replace(
        ref_rect=_zero_pad(scene.ref_rect, {2: hrp, 3: wrp}),
        src_rect=_zero_pad(scene.src_rect, {2: hrp, 3: wrp}),
        fwd_c1=_edge_pad(scene.fwd_c1, 2, wrp),
        fwd_r=_edge_pad(_edge_pad(scene.fwd_r, 1, hrp), 2, wrp),
        ret_c1=_edge_pad(scene.ret_c1, 1, hrp),
        tile_ok=_zero_pad(scene.tile_ok, {1: hrp // 8, 2: wrp // 128}),
        fwd2_ok=_zero_pad(scene.fwd2_ok, {1: wrp // 8, 2: -(-hrp // 128)}))


class TiledRectPrep(NamedTuple):
    """Host-built state of a tile(x view)-sharded rect run."""

    scenes: list             # one RectScene per band, at a common shape
    full_base: ScenePack     # unsharded lite pack (for finalize)
    params: AlgorithmParams
    n_tiles: int
    margin: int
    h: int                   # original image height (before band padding)
    h_pad: int
    w: int
    info: list


def required_band_margin(params: AlgorithmParams) -> int:
    """The least legal band overlap (rows per side), even: the far
    propagation reach (5 px + 1) and the rect cost window's vertical read
    reach across the seam (box_vrad plus the window_grads ring)."""
    reach = params.box_vrad + (params.window_increment
                               if params.window_grads else 0)
    m = max(6, reach)
    return m + (m % 2)


def prepare_tiled_rect(images: Sequence[np.ndarray], rig: Rig,
                       view_subset: Sequence[int], params: AlgorithmParams,
                       depth_min: float, depth_max: float, n_tiles: int,
                       margin: int | None = None,
                       device=None) -> TiledRectPrep:
    """Build the rect scenes of `n_tiles` row bands on `device` (None: the
    card).  The image height is padded with edge rows to a band multiple;
    the stitched output is cropped back.  margin None derives the band
    overlap from the params (required_band_margin)."""
    from ..pipeline import resolve_device
    device = resolve_device(device)
    req = required_band_margin(params)
    if margin is None:
        margin = req
    if margin % 2 or margin < req:
        raise ValueError(f"margin {margin} must be even (checkerboard "
                         f"parity) and >= {req} (far-propagation reach 6 "
                         "and the rect cost window's vertical read reach)")
    ref = np.asarray(images[0], np.float32)
    h, w = ref.shape[:2]
    h_loc = -(-h // n_tiles)
    h_loc += h_loc % 2
    h_pad = h_loc * n_tiles
    if h_pad != h:
        ref = np.concatenate(
            [ref, np.repeat(ref[-1:], h_pad - h, axis=0)], axis=0)
    imgs = [ref] + [np.asarray(im) for im in images[1:]]

    full_base = build_scene(imgs, rig, list(view_subset), params,
                            depth_min, depth_max, lite=True, device=device)
    # global_h stays the ORIGINAL h: candidates in the band-padding rows
    # must fail the propagation y <= global_h - 1 check as single-band
    # bottom-edge candidates do.
    full_base = full_base._replace(
        global_h=torch.tensor(h, dtype=torch.int32, device=device))

    bands, infos = [], []
    for b in range(n_tiles):
        r0 = b * h_loc - margin
        idx = np.clip(np.arange(r0, (b + 1) * h_loc + margin), 0, h_pad - 1)
        band_base = _slice_pack_rows(full_base, idx, r0)
        # cull_downscale=1: the band runners run no two-stage cull, so no
        # band builds a nested screening scene.
        scene_b, info_b = build_rect_scene(
            [ref[idx]] + imgs[1:], _crop_ref_rig(rig, r0), list(view_subset),
            params.replace(cull_downscale=1), depth_min, depth_max,
            base=band_base, device=device)
        bands.append(scene_b)
        infos.append(info_b)

    hrp = max(s.ref_rect.shape[-2] for s in bands)
    wrp = max(s.ref_rect.shape[-1] for s in bands)
    ss = max(s.spans.shape[0] for s in bands)
    sp = max(s.spans.shape[1] for s in bands)
    spans = torch.zeros((ss, sp), dtype=torch.int8, device=device)
    bands = [_repad_rect(s, hrp, wrp)._replace(spans=spans) for s in bands]
    return TiledRectPrep(scenes=bands, full_base=full_base, params=params,
                         n_tiles=n_tiles, margin=margin, h=h, h_pad=h_pad,
                         w=w, info=infos)


def _exchange_overlap(planes: torch.Tensor, m: int, tile) -> torch.Tensor:
    """Each band's `m` overlap rows (top and bottom) overwritten with the
    neighbouring band's adjacent owned rows; bands at the image's edges
    keep their own (the global checks reject those rows)."""
    if tile.size == 1:
        return planes
    he = planes.shape[0]
    from_up, from_dn = tile.neighbour_exchange(planes[m:2 * m],
                                               planes[he - 2 * m:he - m])
    top = planes[:m] if from_up is None else from_up
    bot = planes[-m:] if from_dn is None else from_dn
    return torch.cat([top, planes[m:-m], bot], dim=0)


@torch.no_grad()
def run_patchmatch_tiled_rect(prep: TiledRectPrep, mesh,
                              tile_axis: str = "tile",
                              view_axis: str = "view") -> PMState:
    """PatchMatch with the bands over `tile_axis` and each band's source
    views over `view_axis`, the host loop of sub-sweeps.  Every rank
    returns the stitched state ([h, w] arrays, overlap rows dropped, band
    padding cropped)."""
    tile, view = axis(mesh, tile_axis), axis(mesh, view_axis)
    if tile.size != prep.n_tiles:
        raise ValueError(f"prep built {prep.n_tiles} bands but the mesh has "
                         f"{tile.size} tile shards")
    params, m = prep.params, prep.margin
    scene = local_views(pad_rect_scene_views(prep.scenes[tile.index],
                                             view.size), view)
    cost_fn = view_sharded_cost_fn(view, rect=True)
    gen = tile_generator(params.seed, tile.index, scene.rays.device)
    st = init_state(scene, params, gen, cost_fn)
    sweeps = (CLOSE_OFFSETS,) + ((FAR_OFFSETS,) if params.far_propagation
                                 else ())
    for _ in range(params.iterations):
        for parity in (0, 1):
            for offsets in sweeps:
                st = st._replace(planes=_exchange_overlap(st.planes, m, tile))
                st = propagation_sweep(st, scene, params, parity, offsets,
                                       cost_fn)
            if params.refine:
                st = refinement_sweep(st, scene, params, parity, cost_fn)
    return PMState(planes=tile.all_gather(st.planes[m:-m])[:prep.h],
                   cost=tile.all_gather(st.cost[m:-m])[:prep.h], gen=gen)


def finalize_tiled(prep: TiledRectPrep, state: PMState):
    """Depth / world normals / cost of the stitched state
    (models.patchmatch.finalize with the unsharded base pack)."""
    base = prep.full_base
    if prep.h_pad != prep.h:
        base = _slice_pack_rows(base, np.arange(prep.h), 0)
    return finalize(state, base)
