"""View- and job-sharded PatchMatch over torch.distributed ranks.

Counterpart of ``gipuma_tpu/parallel/sharded.py``.  Two levels of
parallelism (parallel/mesh.py):

* view sharding — each rank evaluates the window costs of its block of
  source views; the per-view costs [V, K, H, W/2] are combined after one
  all-gather over the ``view`` group (the reference's serial per-pixel
  view loop, gipuma.cu:742-778, spread over ranks);
* job sharding — independent depth-map jobs run on the ``job`` groups with
  no communication but the final gather of their states.

The sweeps are replicated over the view group: every member draws the same
random numbers (each seeds its generator from params.seed) and combines
the same gathered costs, so the members' states stay equal.

The JAX package runs each sharded job as one ``lax.scan`` inside
``shard_map``; these runners run the engine's host loop of sub-sweeps
whatever ``level_dispatch`` says.  A collective inside a CUDA-graph
capture works under NCCL but not under gloo (host copies), so the graph
dispatch of a sharded level is left to a performance PR.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..config import AlgorithmParams
from ..models.patchmatch import PMState, run_patchmatch
from ..models.scene import pad_scene_views
from ..ops import checkerboard as cb
from ..ops.cost import ScenePack, combine_view_costs, per_view_costs_batch
from ..ops.rect_cost import RectScene, rect_per_view_costs_batch
from .mesh import Axis, axis


def view_sharded_cost_fn(view: Axis, rect: bool = False) -> Callable:
    """multiview_cost drop-in over the view group `view`: this rank's
    per-view costs, one all-gather, then the combination.  GOOD needs the
    global real-view count (gipuma.cu:785-786), so the local view_valid
    slices are gathered too (once per scene).

    Both forms evaluate K candidates through ``.batch`` (the candidates'
    costs are independent); refinement rounds are batched only on the rect
    path (``batched_refinement``), as in the JAX package, whose rect cost
    alone has a ``.batch``.  ``.batch`` ignores cand_ok / cur: the sharded
    path runs no two-stage cull."""
    per_view = rect_per_view_costs_batch if rect else per_view_costs_batch
    valid = {}

    def view_valid(scene):
        if valid.get("local") is not scene.view_valid:
            valid["local"] = scene.view_valid
            valid["full"] = view.all_gather(scene.view_valid)
        return valid["full"]

    def cost_fn_batch(scene, params, parity, n, d, cand_ok=None, cur=None):
        del cand_ok, cur
        full = view.all_gather(per_view(scene, params, parity, n, d))
        return combine_view_costs(full, params, view_valid=view_valid(scene))

    def cost_fn(scene, params, parity, n, d):
        return cost_fn_batch(scene, params, parity, n[None], d[None])[0]

    cost_fn.batch = cost_fn_batch
    cost_fn.batched_refinement = rect
    return cost_fn


def view_slice(scene, start: int, stop: int):
    """Views [start, stop) of a ScenePack or RectScene (the per-rank block
    of the view axis; every other field is shared).  A RectScene's nested
    screening scene is dropped: its strided view axis does not match the
    view blocks (the JAX package drops it as well)."""
    if isinstance(scene, RectScene):
        def sl(a):
            return None if a is None else a[start:stop]
        return scene._replace(
            base=view_slice(scene.base, start, stop),
            ref_rect=sl(scene.ref_rect), src_rect=sl(scene.src_rect),
            L=sl(scene.L), fwd_c1=sl(scene.fwd_c1), fwd_r=sl(scene.fwd_r),
            ret_c1=sl(scene.ret_c1), ret_r=sl(scene.ret_r),
            rot_k=sl(scene.rot_k), disp_bounds=sl(scene.disp_bounds),
            hw_valid=sl(scene.hw_valid), tile_ok=sl(scene.tile_ok),
            fwd2_ok=sl(scene.fwd2_ok), ret2_ok=sl(scene.ret2_ok),
            cull=None, rot_k_host=scene.rotations()[start:stop],
            valid_host=scene.valid_views()[start:stop])
    return scene._replace(
        A=scene.A[start:stop], b=scene.b[start:stop],
        view_valid=scene.view_valid[start:stop],
        src=None if scene.src is None else scene.src[start:stop])


def local_views(scene, view: Axis):
    """This rank's block of a scene whose view count divides by the group
    size (pad first)."""
    per = scene.num_views // view.size
    return view_slice(scene, view.index * per, (view.index + 1) * per)


def pad_rect_scene_views(scene: RectScene, multiple: int) -> RectScene:
    """pad_scene_views for a RectScene: the base as there (padded slots
    carry view_valid = 0), the per-pair arrays repeat view 0, the tile
    masks and valid extents are zero, and the padded views are invalid on
    the host too, so they launch no kernel."""
    V = scene.ref_rect.shape[0]
    target = -(-V // multiple) * multiple
    base = pad_scene_views(scene.base, multiple)
    if target == V:
        return scene._replace(base=base)
    pad = target - V

    def pad0(a):
        return torch.cat([a, a[:1].repeat((pad,) + (1,) * (a.ndim - 1))])

    def padz(a):
        if a is None:
            return None
        return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])

    return scene._replace(
        base=base, ref_rect=pad0(scene.ref_rect),
        src_rect=pad0(scene.src_rect), L=pad0(scene.L),
        fwd_c1=pad0(scene.fwd_c1), fwd_r=pad0(scene.fwd_r),
        ret_c1=pad0(scene.ret_c1), ret_r=pad0(scene.ret_r),
        rot_k=pad0(scene.rot_k), disp_bounds=pad0(scene.disp_bounds),
        hw_valid=padz(scene.hw_valid), tile_ok=padz(scene.tile_ok),
        fwd2_ok=padz(scene.fwd2_ok), ret2_ok=padz(scene.ret2_ok),
        rot_k_host=scene.rotations() + (scene.rotations()[0],) * pad,
        valid_host=scene.valid_views() + (False,) * pad)


@torch.no_grad()
def run_patchmatch_view_sharded(scene, params: AlgorithmParams,
                                gen: torch.Generator, mesh) -> PMState:
    """One depth-map job with the source views sharded over the mesh's
    ``view`` axis (the job and tile axes replicate it).  Accepts a
    ScenePack (exact cost path) or a RectScene (its nested screening scene
    dropped).  Every rank passes the whole scene and a generator seeded
    alike; every rank returns the whole state."""
    view = axis(mesh, "view")
    rect = isinstance(scene, RectScene)
    scene = (pad_rect_scene_views(scene._replace(cull=None), view.size)
             if rect else pad_scene_views(scene, view.size))
    return run_patchmatch(local_views(scene, view),
                          params.replace(level_dispatch="host"), gen,
                          cost_fn=view_sharded_cost_fn(view, rect=rect))


@torch.no_grad()
def run_patchmatch_batch_sharded(scenes: ScenePack, params: AlgorithmParams,
                                 gens: Sequence[torch.Generator], mesh
                                 ) -> PMState:
    """A batch of depth-map jobs: the leading batch axis over ``job``
    groups, each job's views over ``view``.  `scenes` is a ScenePack whose
    every field has a leading batch axis (stack_scenes); gens: one
    generator per job.  Each job group runs its block of jobs one after
    another; the states are gathered over the job axis, so every rank
    returns the whole batch ([B, H, W, 4] planes, [B, H, W] cost)."""
    job, view = axis(mesh, "job"), axis(mesh, "view")
    scenes = pad_scene_views_batched(scenes, view.size)
    B = scenes.A.shape[0]
    if B % job.size:
        raise ValueError(f"{B} jobs do not split over {job.size} job groups")
    per = B // job.size
    p = params.replace(level_dispatch="host")
    cost_fn = view_sharded_cost_fn(view)
    outs = [run_patchmatch(local_views(_unstack(scenes, b), view), p,
                           gens[b], cost_fn=cost_fn)
            for b in range(job.index * per, (job.index + 1) * per)]
    return PMState(planes=job.all_gather(torch.stack([o.planes
                                                      for o in outs])),
                   cost=job.all_gather(torch.stack([o.cost for o in outs])))


def _map_pack(fn, packs: Sequence[ScenePack]) -> ScenePack:
    """fn applied field by field across ScenePacks (through the PaddedEO
    planes; None stays None)."""
    kw = {}
    for f in ScenePack._fields:
        vals = [getattr(p, f) for p in packs]
        v0 = vals[0]
        if v0 is None:
            kw[f] = None
        elif isinstance(v0, cb.PaddedEO):
            kw[f] = cb.PaddedEO(E=fn([v.E for v in vals]),
                                O=fn([v.O for v in vals]),
                                pr=v0.pr, pc=v0.pc, h=v0.h, w2=v0.w2)
        else:
            kw[f] = fn(vals)
    return ScenePack(**kw)


def stack_scenes(scenes: list[ScenePack]) -> ScenePack:
    """Stack per-job ScenePacks along a new leading batch axis (every job
    must share the image size and view count: pad_scene_views first)."""
    return _map_pack(torch.stack, scenes)


def _unstack(scenes: ScenePack, b: int) -> ScenePack:
    return _map_pack(lambda vs: vs[0][b], [scenes])


def pad_scene_views_batched(scenes: ScenePack, multiple: int) -> ScenePack:
    """pad_scene_views for a batched ScenePack (the view axis is axis 1)."""
    V = scenes.A.shape[1]
    target = -(-V // multiple) * multiple
    if target == V:
        return scenes
    pad = target - V

    def pad1(a):
        return torch.cat([a, a[:, :1].repeat(
            (1, pad) + (1,) * (a.ndim - 2))], dim=1)

    return scenes._replace(
        A=pad1(scenes.A), b=pad1(scenes.b),
        src=None if scenes.src is None else pad1(scenes.src),
        view_valid=torch.cat([scenes.view_valid, scenes.view_valid.new_zeros(
            (scenes.view_valid.shape[0], pad))], dim=1))
