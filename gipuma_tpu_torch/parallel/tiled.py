"""Spatial (image-tile) sharding: row bands across ranks with halo exchange.

Counterpart of ``gipuma_tpu/parallel/tiled.py`` on the exact cost path.
The reference image is split into horizontal bands, one per rank of the
``tile`` axis.  Each rank owns its band's plane / cost state and evaluates
costs for its rows only; before every propagation sub-sweep the boundary
plane rows are exchanged with the neighbouring bands (``batch_isend_irecv``
on the tile group), the image's top and bottom edges replicated as the
single-band PaddedEO pads them.

* the reference window channels are cut into per-band blocks with their
  window halos (read-only, no exchange);
* source views and warp constants are shared (any band warps anywhere);
* pixel y-coordinates stay global through ScenePack.row_offset; band
  heights are even, so each band's checkerboard parity is the image's.

Randomness: the init is drawn once for the whole image from the caller's
generator (models.patchmatch.init_planes, as the single-band init_state
draws it) and split by rows.
Refinement draws come from a generator per band seeded from
(params.seed, tile index) (``tile_generator``; the JAX package folds its
key with the tile index): the same distribution as, not the same numbers
as, a single-band run.  Propagation-only runs equal the single-band run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import AlgorithmParams
from ..models.patchmatch import (CLOSE_OFFSETS, FAR_OFFSETS,
                                 MONOLITHIC_OFFSETS, PMState, init_planes,
                                 initial_cost, make_generator,
                                 propagation_sweep, refinement_sweep)
from ..ops import checkerboard as cb
from ..ops.cost import ScenePack, multiview_cost
from .mesh import axis


class TileShards(NamedTuple):
    """Per-band rows, each field with a leading [n] band axis."""

    refE: torch.Tensor      # [n, H_loc + 2pr, W2E + pc, C] image even cols
    refO: torch.Tensor
    gxE: torch.Tensor
    gxO: torch.Tensor
    gyE: torch.Tensor
    gyO: torch.Tensor
    rays: torch.Tensor      # [n, H_loc, W, 3]
    view_vec: torch.Tensor  # [n, H_loc, W, 3]
    texture_ok: torch.Tensor
    row_offset: torch.Tensor  # [n] int32


def tile_generator(seed: int, index: int, device) -> torch.Generator:
    """The refinement generator of tile `index`: seeded from (seed, index),
    a different stream per tile and the same on every rank of one tile."""
    return make_generator(int(seed) * 65599 + int(index) + 1, device)


def shard_scene_rows(scene: ScenePack, n: int):
    """Split the row-dependent scene arrays into n even-height bands (the
    reference channels with their window halos).  Returns (TileShards,
    base scene, H_loc)."""
    H = scene.rays.shape[0]
    if H % n or (H // n) % 2:
        raise ValueError(f"height {H} does not split into {n} even-height "
                         "bands (pad rows first)")
    H_loc = H // n
    pr = scene.ref_img.pr

    def band_halo(a):  # [H + 2pr, ...] padded rows -> [n, H_loc + 2pr, ...]
        return torch.stack([a[i * H_loc:i * H_loc + H_loc + 2 * pr]
                            for i in range(n)])

    def band(a):       # [H, ...] -> [n, H_loc, ...]
        return a.reshape((n, H_loc) + tuple(a.shape[1:]))

    shards = TileShards(
        refE=band_halo(scene.ref_img.E), refO=band_halo(scene.ref_img.O),
        gxE=band_halo(scene.ref_gx.E), gxO=band_halo(scene.ref_gx.O),
        gyE=band_halo(scene.ref_gy.E), gyO=band_halo(scene.ref_gy.O),
        rays=band(scene.rays), view_vec=band(scene.view_vec),
        texture_ok=band(scene.texture_ok),
        row_offset=torch.arange(n, dtype=torch.int32,
                                device=scene.rays.device) * H_loc)
    return shards, scene, H_loc


def _local_scene(shards: TileShards, base: ScenePack, H_loc: int,
                 t: int) -> ScenePack:
    """Band t's ScenePack: its rows of the band fields, the rest shared."""
    def eo(E, O, proto):
        return cb.PaddedEO(E=E[t], O=O[t], pr=proto.pr, pc=proto.pc,
                           h=H_loc, w2=proto.w2)

    return base._replace(
        ref_img=eo(shards.refE, shards.refO, base.ref_img),
        ref_gx=eo(shards.gxE, shards.gxO, base.ref_gx),
        ref_gy=eo(shards.gyE, shards.gyO, base.ref_gy),
        rays=shards.rays[t], view_vec=shards.view_vec[t],
        texture_ok=shards.texture_ok[t], row_offset=shards.row_offset[t])


def _exchange_halo(planes: torch.Tensor, pad: int, tile) -> torch.Tensor:
    """`planes` with `pad` rows of the neighbouring bands above and below;
    at the image's top and bottom the edge row is replicated."""
    from_up, from_dn = tile.neighbour_exchange(planes[:pad], planes[-pad:])
    if from_up is None:
        from_up = planes[:1].expand((pad,) + tuple(planes.shape[1:]))
    if from_dn is None:
        from_dn = planes[-1:].expand((pad,) + tuple(planes.shape[1:]))
    return torch.cat([from_up, planes, from_dn], dim=0)


def iteration_tiled(state: PMState, scene: ScenePack,
                    params: AlgorithmParams, tile,
                    cost_fn=multiview_cost) -> PMState:
    """One PatchMatch iteration on a band, with a halo exchange of the
    plane rows before every propagation sub-sweep."""
    for parity in (0, 1):
        if params.propagation_variant == "monolithic":
            sweeps = (MONOLITHIC_OFFSETS,)
        else:
            sweeps = (CLOSE_OFFSETS,)
            if params.far_propagation:
                sweeps = sweeps + (FAR_OFFSETS,)
        for offsets in sweeps:
            pad = max(max(abs(dy), abs(dx)) for dy, dx in offsets)
            halo = _exchange_halo(state.planes, pad, tile)
            state = propagation_sweep(state, scene, params, parity, offsets,
                                      cost_fn, halo_planes=halo)
        if params.refine:
            state = refinement_sweep(state, scene, params, parity, cost_fn)
    return state


@torch.no_grad()
def run_patchmatch_tile_sharded(scene: ScenePack, params: AlgorithmParams,
                                gen: torch.Generator, mesh,
                                axis_name: str = "tile",
                                iterations: int | None = None,
                                planes0: torch.Tensor | None = None
                                ) -> PMState:
    """Full PatchMatch with the image rows sharded over `axis_name`.

    The init is drawn from `gen` for the whole image (models.patchmatch.
    init_planes, as the single-band init_state draws it) and split by
    rows; planes0 [H, W, 4] replaces that draw (the JAX package's init,
    carried across by the tests).  Refinement draws come from
    ``tile_generator(params.seed, tile index)``.  Every rank returns the
    whole image's state (the bands gathered over the tile group)."""
    tile = axis(mesh, axis_name)
    n = tile.size
    iters = params.iterations if iterations is None else iterations
    if planes0 is None:
        planes0 = init_planes(scene, params, gen)
    shards, base, H_loc = shard_scene_rows(scene, n)
    scene_l = _local_scene(shards, base, H_loc, tile.index)
    planes = planes0[tile.index * H_loc:(tile.index + 1) * H_loc]
    st = PMState(planes=planes,
                 cost=initial_cost(scene_l, params, planes, multiview_cost),
                 gen=tile_generator(params.seed, tile.index, planes.device))
    for _ in range(iters):
        st = iteration_tiled(st, scene_l, params, tile)
    return PMState(planes=tile.all_gather(st.planes),
                   cost=tile.all_gather(st.cost), gen=st.gen)
