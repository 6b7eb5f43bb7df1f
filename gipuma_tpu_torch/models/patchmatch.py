"""The PatchMatch multi-view stereo engine.

Counterpart of ``gipuma_tpu/models/patchmatch.py:43-539`` (the reference
GPU core, gipuma.cu:996-1960):

* random plane-field init            — gipuma_init_cu2        (gipuma.cu:996-1051)
* checkerboard close propagation ±1  — spatialPropClose       (gipuma.cu:1471-1588)
* checkerboard far propagation ±5    — spatialPropFar         (gipuma.cu:1353-1468)
* monolithic propagation, 20 offsets — gipuma_checkerboard_cu (gipuma.cu:1236-1330)
  (config.propagation_variant="monolithic")
* plane refinement (perturbation)    — planeRefinement_cu     (gipuma.cu:928-994):
  sequential rounds, or all rounds as one K-candidate batch
  (config.refine_batched, for cost functions that batch it)
* iteration schedule black/red x {close, far, refine}          (gipuma.cu:1911-1941)
* final world-normal / depth output  — gipuma_compute_disp    (gipuma.cu:1080-1103)

Each sub-sweep reads the tensors the previous one produced (functional
updates, as in the JAX package).  Randomness comes from a torch.Generator
seeded from params.seed; it gives other numbers than jax.random, so tests
inject the JAX draws through ``refinement_sweep(uniforms=...)`` and
``convert.state_from_numpy``.  The iteration loop is a host loop of
sub-sweeps (the JAX package's ``run_patchmatch_host_loop``), or under
config.level_dispatch="scan" one CUDA graph per level
(``run_iterations_scan``, the JAX package's whole-level lax.scan).
"""
from __future__ import annotations

import collections
import functools
import time
from typing import NamedTuple

import torch

from .. import kernels
from ..config import MAXCOST, AlgorithmParams
from ..geometry import transforms as T
from ..ops import checkerboard as cb


# Propagation offsets as (dy, dx), in the reference's evaluation order
# (up, down, left, right — gipuma.cu:1450-1462, 1569-1582).
CLOSE_OFFSETS = ((-1, 0), (1, 0), (0, -1), (0, 1))
FAR_OFFSETS = ((-5, 0), (5, 0), (0, -5), (0, 5))
# Monolithic-kernel offsets (gipuma_checkerboard_cu, gipuma.cu:1236-1330):
# per axis ±1 (base), ±3 (EXTRAPOINT), ±5 (EXTRAPOINTFAR), plus the
# EXTRAPOINT2 diagonal-ish points, in the reference's evaluation order
# (_fold_better accepts the first strict improvement, so order matters).
MONOLITHIC_OFFSETS = (
    (-1, 0), (-3, 0), (-5, 0),      # up, upup, upup-2
    (1, 0), (3, 0), (5, 0),         # down...
    (0, -1), (0, -3), (0, -5),      # left...
    (0, 1), (0, 3), (0, 5),         # right...
    # EXTRAPOINT2 (gipuma.cu:1294-1330)
    (-1, 2), (1, 2), (-1, -2), (1, -2),
    (-2, -1), (-2, 1), (2, -1), (2, 1),
)


# torch.cuda.set_sync_debug_mode around each CUDA-graph capture of
# run_iterations_scan.  "error" makes a host sync inside the captured sweeps
# raise at the op that makes it; the mode is process-wide, so set it only
# where no other thread works on the device meanwhile (chip_smoke.py does).
CAPTURE_SYNC_DEBUG_MODE = "default"
# One entry per level that run_iterations_scan ran as a CUDA graph, the
# newest 256: {"capture_s", "replays", "launches_per_replay"} (chip_smoke.py
# reads and clears it).
SCAN_LOG: collections.deque = collections.deque(maxlen=256)


class PMState(NamedTuple):
    """Algorithm state — the LineState analog (linestate.h:8-30): norm4
    (nx, ny, nz, d) and per-pixel cost, plus the random generator."""

    planes: torch.Tensor   # [H, W, 4] = (nx, ny, nz, d)
    cost: torch.Tensor     # [H, W]
    gen: torch.Generator | None = None


def make_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def _active_coords(scene, parity: int):
    """Active-pixel coordinates in global image space."""
    h = scene.rays.shape[0]
    w2 = scene.rays.shape[1] // 2
    dev = scene.rays.device
    x = cb.active_x(h, w2, parity, device=dev)
    y = cb.active_y(h, w2, device=dev) + scene.row_offset.to(torch.float32)
    return x, y


def random_unit_hemisphere(gen: torch.Generator, view_vec: torch.Tensor
                           ) -> torch.Tensor:
    """Random unit normals facing the camera (rndUnitVectorOnHemisphere_cu,
    gipuma.cu:166-169): normalized Gaussians."""
    g = torch.randn(view_vec.shape, generator=gen, dtype=view_vec.dtype,
                    device=view_vec.device)
    return T.flip_to_hemisphere(T.normalize(g, eps=1e-20), view_vec)


def init_planes(scene, params: AlgorithmParams,
                gen: torch.Generator) -> torch.Tensor:
    """Random init planes [H, W, 4]: uniform disparity -> depth, random
    hemisphere normal, plane distance (gipuma_init_cu2)."""
    h, w = scene.rays.shape[:2]
    dev = scene.rays.device
    x, y = T.pixel_grid(h, w, device=dev)
    y = y + scene.row_offset.to(y.dtype)
    u = torch.rand((h, w), generator=gen, device=dev)
    disp = params.min_disparity + u * (params.max_disparity
                                       - params.min_disparity)
    depth = T.disparity_depth(scene.f, scene.baseline, disp)
    n = random_unit_hemisphere(gen, scene.view_vec)
    d = T.plane_d_at_pixel(scene.M_inv, scene.P_col4, n, x, y, depth)
    return torch.cat([n, d[..., None]], dim=-1)


def initial_cost(scene, params: AlgorithmParams, planes: torch.Tensor,
                 cost_fn) -> torch.Tensor:
    """The multiview cost [H, W] of `planes`, parity by parity."""
    cost = torch.zeros(planes.shape[:2], dtype=planes.dtype,
                       device=planes.device)
    for parity in (0, 1):
        c = cost_fn(scene, params, parity, cb.extract(planes[..., :3], parity),
                    cb.extract(planes[..., 3], parity))
        cost = cb.interleave(cost, c, parity)
    return cost


def init_state(scene, params: AlgorithmParams, gen: torch.Generator,
               cost_fn) -> PMState:
    """Random init (init_planes) and its initial multiview cost."""
    planes = init_planes(scene, params, gen)
    return PMState(planes=planes,
                   cost=initial_cost(scene, params, planes, cost_fn), gen=gen)


def _fold_better(scene, params, parity, x, y, cand_n, cand_d, cand_ok,
                 n_now, d_now, c_now, cost_fn):
    """Accept strictly-better candidates in order (spatialPropagation_cu,
    gipuma.cu:832-874): a candidate replaces the current plane when its
    cost is < the current one AND its depth is inside [depth_min,
    depth_max]; first-minimum tie-breaking, as in the reference.

    The candidates' costs do not depend on each other, so they are all
    evaluated first: in one pass through ``cost_fn.batch`` where the cost
    function has one (both of the port's do), else one call per
    candidate."""
    batch = getattr(cost_fn, "batch", None)
    if batch is not None:
        ck_all = batch(scene, params, parity, cand_n, cand_d,
                       cand_ok=cand_ok, cur=(n_now, d_now))
    else:
        ck_all = torch.stack([cost_fn(scene, params, parity, cand_n[k],
                                      cand_d[k])
                              for k in range(cand_n.shape[0])])
    depth_all = T.depth_from_plane(cand_n, cand_d, x, y, scene.fx, scene.cx,
                                   scene.cy, scene.alpha_focal)
    for k in range(cand_n.shape[0]):
        in_range = ((depth_all[k] >= scene.depth_min)
                    & (depth_all[k] <= scene.depth_max))
        accept = cand_ok[k] & in_range & (ck_all[k] < c_now)
        n_now = torch.where(accept[..., None], cand_n[k], n_now)
        d_now = torch.where(accept, cand_d[k], d_now)
        c_now = torch.where(accept, ck_all[k], c_now)
    return n_now, d_now, c_now


def _write_back(state: PMState, scene, params, parity, n_now, d_now, c_now,
                n_old=None, d_old=None) -> PMState:
    if params.no_texture_check:
        # Textureless pixels are frozen at MAXCOST (gipuma.cu:1209-1234).
        tex = cb.extract(scene.texture_ok, parity)
        if n_old is not None:
            n_now = torch.where(tex[..., None], n_now, n_old)
            d_now = torch.where(tex, d_now, d_old)
        c_now = torch.where(tex, c_now, MAXCOST)
    planes = cb.interleave(
        state.planes, torch.cat([n_now, d_now[..., None]], dim=-1), parity)
    cost = cb.interleave(state.cost, c_now, parity)
    return PMState(planes=planes, cost=cost, gen=state.gen)


def propagation_sweep(state: PMState, scene, params: AlgorithmParams,
                      parity: int, offsets, cost_fn,
                      halo_planes: torch.Tensor | None = None) -> PMState:
    """One checkerboard propagation sub-sweep over the neighbour `offsets`
    ((dy, dx) pairs, evaluated in order): each active pixel takes the
    first candidate plane that strictly lowers its cost.

    halo_planes: optional row-extended planes [H + 2*pad, W, 4] whose
    first and last `pad` rows came from the neighbouring tile shards
    (parallel/tiled.py); None = edge replication at the image's rows."""
    w = state.cost.shape[1]
    x, y = _active_coords(scene, parity)
    pad = max(max(abs(dy), abs(dx)) for dy, dx in offsets)
    if halo_planes is not None:
        planes_eo = cb.PaddedEO.build_row_padded(halo_planes, pad, pad + 2)
    else:
        planes_eo = cb.PaddedEO.build(state.planes, pad, pad + 2)
    g_h = scene.global_h.to(y.dtype)
    cand_n, cand_d, cand_ok = [], [], []
    for dy, dx in offsets:
        cand = planes_eo.shifted(dy, dx, parity)             # [H, W2, 4]
        cand_n.append(cand[..., :3])
        cand_d.append(cand[..., 3])
        cand_ok.append((y + dy >= 0) & (y + dy <= g_h - 1)
                       & (x + dx >= 0) & (x + dx <= w - 1))
    cand_n = torch.stack(cand_n)
    cand_d = torch.stack(cand_d)
    cand_ok = torch.stack(cand_ok)

    n_old = cb.extract(state.planes[..., :3], parity)
    d_old = cb.extract(state.planes[..., 3], parity)
    c_now = cb.extract(state.cost, parity)
    n_now, d_now, c_now = _fold_better(
        scene, params, parity, x, y, cand_n, cand_d, cand_ok,
        n_old, d_old, c_now, cost_fn)
    return _write_back(state, scene, params, parity, n_now, d_now, c_now,
                       n_old, d_old)


def axial_propagation_sweep(state: PMState, scene, params: AlgorithmParams,
                            parity: int, dist: int, cost_fn,
                            halo_planes: torch.Tensor | None = None
                            ) -> PMState:
    """propagation_sweep over the four axial neighbours at distance `dist`
    (1 = close, 5 = far), in the reference's order up, down, left, right.
    halo_planes as in propagation_sweep, with `dist` halo rows a side."""
    dist = int(dist)
    return propagation_sweep(state, scene, params, parity,
                             tuple((sy * dist, sx * dist)
                                   for sy, sx in CLOSE_OFFSETS), cost_fn,
                             halo_planes=halo_planes)


def refinement_sweep(state: PMState, scene, params: AlgorithmParams,
                     parity: int, cost_fn, uniforms=None) -> PMState:
    """Plane refinement: the exponential perturbation schedule in disparity
    space (planeRefinement_cu + getRndDispAndUnitVector_cu,
    gipuma.cu:890-994).

    With config.refine_batched and a cost function that declares
    ``batched_refinement`` (the rect cost), every round is one candidate of
    ONE K-candidate batch around the sweep's starting state.  Otherwise the
    rounds run in order, each perturbing the plane the round before
    accepted (the JAX package takes the batched branch only for a cost with
    a ``.batch``, i.e. the rect cost; the exact cost's ``.batch`` serves
    propagation only).

    uniforms: optional (u [R, H, W2], u_n [R, H, W2, 3]) in [0, 1) used in
    place of the generator's draws, round r reading u[r] and u_n[r] (tests
    feed the JAX package's draws)."""
    if not (params.refine_batched
            and getattr(cost_fn, "batched_refinement", False)):
        return _refine_sequential(state, scene, params, parity, cost_fn,
                                  uniforms)
    x, y = _active_coords(scene, parity)
    dev = scene.rays.device
    view_vec = cb.extract(scene.view_vec, parity)
    n_now = cb.extract(state.planes[..., :3], parity)
    d_now = cb.extract(state.planes[..., 3], parity)
    c_now = cb.extract(state.cost, parity)
    depth_now = T.depth_from_plane(n_now, d_now, x, y, scene.fx, scene.cx,
                                   scene.cy, scene.alpha_focal)

    schedule = params.refinement_schedule()
    R = len(schedule)
    deltas = _schedule(tuple(schedule), dev)
    delta_z = deltas[:, 0][:, None, None]                 # [R, 1, 1]
    delta_n = deltas[:, 1][:, None, None, None]           # [R, 1, 1, 1]
    if uniforms is None:
        u = torch.rand((R,) + d_now.shape, generator=state.gen, device=dev)
        u_n = torch.rand((R,) + n_now.shape, generator=state.gen, device=dev)
    else:
        u, u_n = uniforms

    disp = T.disparity_depth(scene.f, scene.baseline, depth_now)
    min_delta = -torch.minimum(delta_z, params.min_disparity + disp[None])
    max_delta = torch.minimum(delta_z, params.max_disparity - disp[None])
    disp_new = disp[None] + min_delta + u * (max_delta - min_delta)
    disp_new = torch.clamp(disp_new, params.min_disparity,
                           params.max_disparity)
    depth_new = T.disparity_depth(scene.f, scene.baseline, disp_new)
    n_new = T.normalize(n_now[None] + (u_n * 2.0 - 1.0) * delta_n,
                        eps=1e-20)
    n_new = T.flip_to_hemisphere(n_new, view_vec[None])
    d_new = T.plane_d_at_pixel(scene.M_inv, scene.P_col4, n_new, x, y,
                               depth_new)

    ck_all = cost_fn.batch(scene, params, parity, n_new, d_new,
                           cur=(n_now, d_now))                # [R, H, W2]
    tex_ok = (cb.extract(scene.texture_ok, parity)
              if params.no_texture_check else None)
    for k in range(R):
        accept = ck_all[k] < c_now
        if tex_ok is not None:
            accept = accept & tex_ok
        n_now = torch.where(accept[..., None], n_new[k], n_now)
        d_now = torch.where(accept, d_new[k], d_now)
        c_now = torch.where(accept, ck_all[k], c_now)
    return _write_back(state, scene, params, parity, n_now, d_now, c_now)


@functools.lru_cache(maxsize=16)
def _schedule(schedule: tuple, dev: torch.device) -> torch.Tensor:
    """The refinement schedule [R, 2] as a float32 tensor on `dev`, made
    once per (schedule, device): later sweeps copy nothing from the host,
    so a CUDA graph can capture them."""
    return torch.tensor(schedule, dtype=torch.float32, device=dev)


def _refine_sequential(state: PMState, scene, params: AlgorithmParams,
                       parity: int, cost_fn, uniforms=None) -> PMState:
    """refinement_sweep's rounds in order (patchmatch.py:333-383 of the JAX
    package): round r perturbs the current plane by (delta_z, delta_n) of
    the schedule and keeps it where its cost is strictly lower."""
    x, y = _active_coords(scene, parity)
    dev = scene.rays.device
    view_vec = cb.extract(scene.view_vec, parity)
    n_now = cb.extract(state.planes[..., :3], parity)
    d_now = cb.extract(state.planes[..., 3], parity)
    c_now = cb.extract(state.cost, parity)
    depth_now = T.depth_from_plane(n_now, d_now, x, y, scene.fx, scene.cx,
                                   scene.cy, scene.alpha_focal)
    deltas = _schedule(tuple(params.refinement_schedule()), dev)
    tex_ok = (cb.extract(scene.texture_ok, parity)
              if params.no_texture_check else None)
    for r in range(deltas.shape[0]):
        delta_z, delta_n = deltas[r, 0], deltas[r, 1]
        if uniforms is None:
            u = torch.rand(d_now.shape, generator=state.gen, device=dev)
            u_n = torch.rand(n_now.shape, generator=state.gen, device=dev)
        else:
            u, u_n = uniforms[0][r], uniforms[1][r]
        disp = T.disparity_depth(scene.f, scene.baseline, depth_now)
        # Perturbation interval limited by the disparity range
        # (gipuma.cu:906-916).
        min_delta = -torch.minimum(delta_z, params.min_disparity + disp)
        max_delta = torch.minimum(delta_z, params.max_disparity - disp)
        disp_new = disp + min_delta + u * (max_delta - min_delta)
        disp_new = torch.clamp(disp_new, params.min_disparity,
                               params.max_disparity)
        depth_new = T.disparity_depth(scene.f, scene.baseline, disp_new)
        n_new = T.normalize(n_now + (u_n * 2.0 - 1.0) * delta_n, eps=1e-20)
        n_new = T.flip_to_hemisphere(n_new, view_vec)
        d_new = T.plane_d_at_pixel(scene.M_inv, scene.P_col4, n_new, x, y,
                                   depth_new)
        c_new = cost_fn(scene, params, parity, n_new, d_new)
        accept = c_new < c_now
        if tex_ok is not None:
            accept = accept & tex_ok
        n_now = torch.where(accept[..., None], n_new, n_now)
        d_now = torch.where(accept, d_new, d_now)
        depth_now = torch.where(accept, depth_new, depth_now)
        c_now = torch.where(accept, c_new, c_now)
    return _write_back(state, scene, params, parity, n_now, d_now, c_now)


def iteration(state: PMState, scene, params: AlgorithmParams,
              cost_fn) -> PMState:
    """One PatchMatch iteration: black {close, far, refine} then red
    {close, far, refine} (gipuma.cu:1911-1941, SMALLKERNEL schedule); under
    propagation_variant="monolithic" each parity's propagation is one
    sweep over MONOLITHIC_OFFSETS (the reference's gipuma_checkerboard_cu
    schedule)."""
    for parity in (0, 1):
        if params.propagation_variant == "monolithic":
            state = propagation_sweep(state, scene, params, parity,
                                      MONOLITHIC_OFFSETS, cost_fn)
        else:
            state = propagation_sweep(state, scene, params, parity,
                                      CLOSE_OFFSETS, cost_fn)
            if params.far_propagation:
                state = propagation_sweep(state, scene, params, parity,
                                          FAR_OFFSETS, cost_fn)
        if params.refine:
            state = refinement_sweep(state, scene, params, parity, cost_fn)
    return state


def run_iterations_scan(state: PMState, scene, params: AlgorithmParams,
                        cost_fn) -> PMState:
    """All iterations of a level as one device program (the JAX package's
    ``run_iterations_scan``, patchmatch.py:474-507): per iteration and
    parity, axial propagation at distance 1, then 5 under far_propagation,
    then refinement under refine.  Like that runner it does not read
    propagation_variant.

    On the card the level is one CUDA graph.  Iteration 1 runs eagerly: it
    is the warm-up (kernel builds, cached constants, the fused kernel's
    shared-memory attributes) and the real first iteration.  The state is
    copied into static planes / cost tensors, one iteration's sweeps are
    captured, ending with a copy of their result into those tensors, and
    the graph is replayed iterations - 1 times, each replay starting from
    the last one's state.  A level of one iteration is therefore the host
    loop exactly.  The refinement draws come from ``state.gen``, registered
    with the graph, so every replay draws the uniforms the host loop would
    draw at that iteration.  A capture that fails raises; there is no
    fallback to the host loop.  On the CPU the schedule runs eagerly."""
    dists = (1, 5) if params.far_propagation else (1,)

    def one_iteration(s: PMState) -> PMState:
        for parity in (0, 1):
            for dist in dists:
                s = axial_propagation_sweep(s, scene, params, parity, dist,
                                            cost_fn)
            if params.refine:
                s = refinement_sweep(s, scene, params, parity, cost_fn)
        return s

    if params.iterations < 1:
        return state
    state = one_iteration(state)
    if state.planes.device.type != "cuda":
        for _ in range(params.iterations - 1):
            state = one_iteration(state)
        return state
    return _replay_level(one_iteration, state, params.iterations - 1)


def _replay_level(step, state: PMState, replays: int) -> PMState:
    """Capture `step` (one iteration) once as a CUDA graph on a side stream
    and replay it `replays` times from static state tensors.  The kernel
    wrappers count their launches while the graph is captured, where
    nothing runs; the counts are set to those captured launches times the
    replays."""
    if replays < 1:
        return state
    if state.gen is not None and not hasattr(torch.cuda.CUDAGraph,
                                             "register_generator_state"):
        raise RuntimeError(
            "level_dispatch='scan': this torch cannot register a "
            "torch.Generator with a CUDA graph (register_generator_state)")
    dev = state.planes.device
    planes = state.planes.clone()
    cost = state.cost.clone()
    graph = torch.cuda.CUDAGraph()
    if state.gen is not None:
        graph.register_generator_state(state.gen)
    before = ({k: kernels.counts[k] for k in kernels.counts},
              {k: kernels.bytes_moved[k] for k in kernels.bytes_moved})
    stream = torch.cuda.Stream(device=dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    debug_mode = torch.cuda.get_sync_debug_mode()
    t0 = time.perf_counter()
    try:
        with torch.cuda.stream(stream):
            torch.cuda.set_sync_debug_mode(CAPTURE_SYNC_DEBUG_MODE)
            # thread_local: the pyramid's and run_batch's scene builds on
            # other threads may go on using the device meanwhile.
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = step(PMState(planes, cost, state.gen))
                planes.copy_(out.planes)
                cost.copy_(out.cost)
                del out
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass   # the capture is invalid; the first error says why
                raise
            graph.capture_end()
    except Exception as e:
        raise RuntimeError(
            "level_dispatch='scan': capturing one iteration as a CUDA graph "
            f"failed ({type(e).__name__}: {e}); the traceback names the op"
        ) from e
    finally:
        torch.cuda.set_sync_debug_mode(debug_mode)
        captured = tuple({k: d[k] - b[k] for k in d} for d, b in zip(
            (kernels.counts, kernels.bytes_moved), before))
        # The capture itself launched nothing.
        for d, b in zip((kernels.counts, kernels.bytes_moved), before):
            d.update(b)
    torch.cuda.current_stream(dev).wait_stream(stream)
    capture_s = time.perf_counter() - t0
    for _ in range(replays):
        graph.replay()
    for d, b, c in zip((kernels.counts, kernels.bytes_moved), before,
                       captured):
        for k in d:
            d[k] = b[k] + c[k] * replays
    SCAN_LOG.append({"capture_s": capture_s, "replays": replays,
                     "launches_per_replay": dict(captured[0])})
    del graph
    return PMState(planes=planes, cost=cost, gen=state.gen)


def run_patchmatch(scene, params: AlgorithmParams, gen: torch.Generator,
                   cost_fn, state: PMState | None = None) -> PMState:
    """Init (unless a warm-start `state` is given) + `params.iterations`
    iterations: sub-sweep by sub-sweep from the host, or under
    config.level_dispatch="scan" as one CUDA graph (run_iterations_scan)."""
    if state is None:
        state = init_state(scene, params, gen, cost_fn)
    if params.level_dispatch == "scan":
        return run_iterations_scan(state, scene, params, cost_fn)
    for _ in range(params.iterations):
        state = iteration(state, scene, params, cost_fn)
    return state


def finalize(state: PMState, scene):
    """World-frame normals + depth map (gipuma_compute_disp,
    gipuma.cu:1080-1103).  Returns (depth [H,W], normals_world [H,W,3],
    cost [H,W]); depth is 0 where the pixel never found a valid view."""
    h, w = state.cost.shape
    x, y = T.pixel_grid(h, w, device=state.cost.device)
    y = y + scene.row_offset.to(y.dtype)
    n = state.planes[..., :3]
    d = state.planes[..., 3]
    depth = T.depth_from_plane(n, d, x, y, scene.fx, scene.cx, scene.cy,
                               scene.alpha_focal)
    depth = torch.where(state.cost != MAXCOST, depth, 0.0)
    n_world = T._matvec(scene.R_orig_inv, n)
    return depth, n_world, state.cost
