"""A local launcher: W ranks of one program on this host.

The counterpart of the JAX tests' ``--xla_force_host_platform_device_count``
(8 virtual devices in one process): torch runs one process per rank, so the
tests and ``chip_smoke.py`` start W processes here with the ``spawn``
start method.  They meet at a FileStore in a temporary directory (TCP
ports would collide between test workers); each rank sets
``torch.set_num_threads(1)`` (W ranks of the default thread count
oversubscribe the cores) and ``LOCAL_RANK``, so ``distributed.rank_device``
gives rank r the card ``r % cards`` (or the CPU when asked).  Every wait
has a timeout: a rank that fails or a collective that hangs kills all the
ranks and raises in the caller.

What runs is a list of tasks (``run_tasks``), each a dict with a "kind"
naming a function of this module; rank functions live in the package so
that the spawned processes can import them.  Each task's record carries its
result (numpy), this rank's kernel launch counts and collective statistics
(parallel/mesh.stats: calls, bytes, host copies) during the task, its
wall seconds, the rank's start-up seconds (to its first line and to its
first task) and, on the card, its peak memory.  A task with "profile" runs
under torch.profiler; its record adds the device seconds, the NCCL
kernels' device seconds and the seconds of gloo's collectives on the
host, each summed from the profiler's events (its wall is stretched by the
profiler: read walls from an unprofiled run).
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch


@dataclasses.dataclass
class RankContext:
    rank: int
    world: int
    device: torch.device
    backend: str
    spawned_at: float     # the caller's time.time() when it started spawning
    entered_s: float      # seconds from then to this rank's first line


def spawn(fn, world: int, args=(), device=None, backend: str | None = None,
          timeout: float = 600.0) -> list:
    """Run ``fn(ctx, *args)`` on `world` ranks; returns the ranks' results
    in rank order.  device None or "cuda" gives each rank a card (NCCL, one
    card per rank, unless backend="gloo" lets ranks share cards) and raises
    without one; "cpu" runs gloo on the CPU.  Raises if any rank raises or
    the run outlives `timeout` seconds; every rank is ended either way."""
    from ..pipeline import resolve_device
    device = str(resolve_device(device))
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gipuma_dist_")
    # The ranks read (fn, args) from a file: passed as Process arguments,
    # large arrays would make each start() wait until its child has
    # imported enough to unpickle them, one child after another.
    job = os.path.join(tmp, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump((fn, tuple(args)), f, protocol=pickle.HIGHEST_PROTOCOL)
    results = ctx.Queue()
    t_spawn = time.time()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, f"file://{tmp}/store", backend,
                               device, job, results, t_spawn),
                         daemon=True)
             for r in range(world)]
    out, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn: {world - len(out)} rank(s) did not finish in "
                    f"{timeout:.0f} s (a hung collective?)")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and len(out) + len(errors) < world:
                    # A rank died without reporting (killed, or a crash
                    # below Python): wait a moment for a report, then stop.
                    try:
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            "spawn: rank process(es) exited with codes "
                            f"{[p.exitcode for p in dead]} without a result"
                        ) from None
                else:
                    continue
            if ok:
                out[rank] = payload
            else:
                errors.append((rank, payload))
                break   # the other ranks may wait on the failed one
        if errors:
            rank, tb = errors[0]
            raise RuntimeError(f"spawn: rank {rank} failed:\n{tb}")
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank, world, init_method, backend, device, job, results,
               t_spawn):
    entered_s = time.time() - t_spawn
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        torch.set_num_threads(1)
        os.environ["LOCAL_RANK"] = str(rank)
        os.environ["LOCAL_WORLD_SIZE"] = str(world)
        from .distributed import init_distributed, rank_device
        init_distributed(backend=backend, init_method=init_method,
                         world_size=world, rank=rank, device=device)
        import torch.distributed as dist
        dev = rank_device(device, rank=rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        ctx = RankContext(rank=rank, world=world, device=dev,
                          backend=str(dist.get_backend()),
                          spawned_at=t_spawn, entered_s=entered_s)
        res = fn(ctx, *args)
        dist.barrier()
        results.put((rank, True, res))
        dist.destroy_process_group()
    except BaseException:   # reported to the caller, which ends the ranks
        results.put((rank, False, traceback.format_exc()))


# --------------------------------------------------------------- tasks ---

def run_tasks(ctx: RankContext, tasks: list) -> list:
    """The rank function of the tests and chip_smoke.py: run `tasks` in
    order, each ``{"kind": ..., **arguments}``, and return one record per
    task (see the module docstring)."""
    from .. import kernels
    from . import mesh as mesh_mod
    if ctx.device.type == "cuda":
        # Warm-up outside every task: the CUDA context, the kernel
        # libraries and, when a task is profiled, the profiler's own start.
        torch.zeros(1, device=ctx.device).add_(1).cpu()
        for name in kernels.SOURCES:
            kernels.library(name)
        if any(t.get("profile") for t in tasks):
            from torch.profiler import ProfilerActivity, profile as prof_ctx
            with prof_ctx(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]):
                torch.zeros(1, device=ctx.device).add_(1).cpu()
    # Seconds from the caller's spawn to this rank's first line, and to its
    # first task (interpreter and imports, rendezvous, warm-up).
    startup = {"entered_s": ctx.entered_s,
               "ready_s": time.time() - ctx.spawned_at}
    records = []
    for task in tasks:
        task = dict(task)
        kind = task.pop("kind")
        profile = task.pop("profile", False) and ctx.device.type == "cuda"
        kernels.reset_counts()
        mesh_mod.reset_stats()
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
            torch.cuda.reset_peak_memory_stats(ctx.device)
        profiled = None
        t0 = time.perf_counter()
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof_ctx
            with prof_ctx(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                result = TASKS[kind](ctx, **task)
                torch.cuda.synchronize(ctx.device)
                # The wall ends here: the profiler's post-processing on
                # exit is not the task's.
                wall = time.perf_counter() - t0
            profiled = _profiled_seconds(prof)
        else:
            result = TASKS[kind](ctx, **task)
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
            wall = time.perf_counter() - t0
        records.append(dict(
            kind=kind, result=result, wall_s=wall, startup=startup,
            counts=dict(kernels.counts), collectives=dict(mesh_mod.stats),
            profiled=profiled,
            peak_bytes=(torch.cuda.max_memory_allocated(ctx.device)
                        if ctx.device.type == "cuda" else None)))
    return records


def _profiled_seconds(prof) -> dict:
    """Seconds summed from a profiler session's events: every device
    event ("device_s"), the NCCL kernels among them ("nccl_device_s"), and
    gloo's collectives on the host ("gloo_s", the "gloo:*" spans: a
    collective from its call to its completion, the wait for the peers
    included)."""
    out = {"device_s": 0, "nccl_device_s": 0, "gloo_s": 0}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if str(ev.device_type()).endswith("CUDA"):
            out["device_s"] += ev.duration_ns()
            if "nccl" in name.lower():
                out["nccl_device_s"] += ev.duration_ns()
        elif name.startswith("gloo:"):
            out["gloo_s"] += ev.duration_ns()
    return {k: v / 1e9 for k, v in out.items()}


_MESHES: dict = {}


def _mesh(mesh_kw: dict):
    from .mesh import make_mesh
    key = tuple(sorted(mesh_kw.items()))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(**mesh_kw)
    return _MESHES[key]


def build(spec: dict, device):
    """(scene, params) from a spec: {"tree": numpy tree, "rect": bool} (a
    JAX scene carried across by convert; params None) or {"job": {"images",
    "Ps", "params"}} (pipeline.prepare_job: view selection, depth range,
    the job's params)."""
    if "tree" in spec:
        from .. import convert
        conv = (convert.rect_scene_from_numpy if spec["rect"]
                else convert.scene_pack_from_numpy)
        return conv(spec["tree"], device=device), None
    from ..pipeline import prepare_job
    j = spec["job"]
    job = prepare_job(j["images"], j["Ps"], j["params"], device=device)
    return job.prep, job.params


def _state(st, scene=None) -> dict:
    out = {"planes": st.planes.cpu().numpy(), "cost": st.cost.cpu().numpy()}
    if scene is not None:
        from ..models.patchmatch import finalize
        depth, normals, _ = finalize(st, scene)
        out["depth"] = depth.cpu().numpy()
        out["normals"] = normals.cpu().numpy()
    return out


def task_view(ctx, scene, mesh, params=None, seed=None, finalize=False):
    """run_patchmatch_view_sharded; params None takes the spec's, the
    generator is seeded from `seed` (default params.seed)."""
    from ..models.patchmatch import make_generator
    from .sharded import run_patchmatch_view_sharded
    sc, sp = build(scene, ctx.device)
    params = sp if params is None else params
    gen = make_generator(params.seed if seed is None else seed, ctx.device)
    st = run_patchmatch_view_sharded(sc, params, gen, _mesh(mesh))
    return _state(st, sc if finalize else None)


def task_batch(ctx, scenes, params, mesh, seeds):
    """run_patchmatch_batch_sharded over stacked exact scenes."""
    from ..models.patchmatch import make_generator
    from .sharded import run_patchmatch_batch_sharded, stack_scenes
    stacked = stack_scenes([build(s, ctx.device)[0] for s in scenes])
    gens = [make_generator(s, ctx.device) for s in seeds]
    return _state(run_patchmatch_batch_sharded(stacked, params, gens,
                                               _mesh(mesh)))


def task_tile(ctx, scene, mesh, params=None, planes0=None, iterations=None):
    """run_patchmatch_tile_sharded (exact path), finalized on the whole
    scene; params None takes the spec's; planes0 (numpy) replaces the init
    draw."""
    from ..models.patchmatch import make_generator
    from .tiled import run_patchmatch_tile_sharded
    sc, sp = build(scene, ctx.device)
    params = sp if params is None else params
    p0 = None if planes0 is None else torch.as_tensor(planes0,
                                                      device=ctx.device)
    st = run_patchmatch_tile_sharded(
        sc, params, make_generator(params.seed, ctx.device), _mesh(mesh),
        iterations=iterations, planes0=p0)
    return _state(st, sc)


def task_tiled_rect(ctx, images, rig, views, params, depth, n_tiles, mesh):
    """prepare_tiled_rect + run_patchmatch_tiled_rect + finalize_tiled."""
    from .tiled_rect import (finalize_tiled, prepare_tiled_rect,
                             run_patchmatch_tiled_rect)
    prep = prepare_tiled_rect(images, rig, views, params, *depth,
                              n_tiles=n_tiles, device=ctx.device)
    st = run_patchmatch_tiled_rect(prep, _mesh(mesh))
    depth_m, normals, _ = finalize_tiled(prep, st)
    return {"planes": st.planes.cpu().numpy(), "cost": st.cost.cpu().numpy(),
            "depth": depth_m.cpu().numpy(), "normals": normals.cpu().numpy(),
            "h_pad": prep.h_pad, "margin": prep.margin}


def task_cost(ctx, scene, params, mesh, parity, n, d):
    """The combined cost of K candidates (n [K, H, W2, 3], d [K, H, W2])
    through view_sharded_cost_fn's batch and single forms."""
    from .mesh import axis
    from .sharded import (local_views, pad_rect_scene_views,
                          view_sharded_cost_fn)
    from ..models.scene import pad_scene_views
    from ..ops.rect_cost import RectScene
    sc = build(scene, ctx.device)[0]
    view = axis(_mesh(mesh), "view")
    rect = isinstance(sc, RectScene)
    sc = (pad_rect_scene_views(sc, view.size) if rect
          else pad_scene_views(sc, view.size))
    local = local_views(sc, view)
    fn = view_sharded_cost_fn(view, rect=rect)
    nt = torch.as_tensor(n, device=ctx.device)
    dt = torch.as_tensor(d, device=ctx.device)
    with torch.no_grad():
        batch = fn.batch(local, params, parity, nt, dt)
        single = torch.stack([fn(local, params, parity, nt[k], dt[k])
                              for k in range(nt.shape[0])])
    return {"batch": batch.cpu().numpy(), "single": single.cpu().numpy()}


def task_fuse(ctx, depths, normals, Ps, params, mesh, f=None, colors=None):
    """fuse_depthmaps_sharded over the mesh's view axis."""
    from ..fusion.sharded import fuse_depthmaps_sharded
    pts, nrm, col = fuse_depthmaps_sharded(depths, normals, Ps, params,
                                           _mesh(mesh), colors=colors, f=f,
                                           device=ctx.device)
    return {"points": pts, "normals": nrm, "colors": col}


def task_cli(ctx, argv):
    """cli.main(argv) in this rank (the world is already initialised, so
    its --distributed reuses it)."""
    from .. import cli
    return {"rc": cli.main(list(argv))}


TASKS = {"view": task_view, "batch": task_batch, "tile": task_tile,
         "tiled_rect": task_tiled_rect, "cost": task_cost, "fuse": task_fuse,
         "cli": task_cli}
