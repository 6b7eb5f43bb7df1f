"""The folder driver: a whole scan of a folder through the program's
command line, on one rank a card, for mixes that name ``"driver":
"folder"`` (``run.py`` dispatches on the mix).

One run is set-up, the mix's ``scans`` whole scans, then the check:

* Set-up.  The run spawns one process per card (``chips``; ``spawn``
  start method) with the variables ``torchrun`` sets (RANK, WORLD_SIZE,
  LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT, and
  OMP_NUM_THREADS=1 unless set).  Each rank initialises the program's
  process group (``parallel.distributed.init_distributed``: NCCL on the
  cards, gloo on the CPU), renders the configuration's views on its card
  from the seed, writes its share of them into a fresh folder under
  ``.portbench_cache/scan/`` as 8-bit PNGs with one ``.P`` file a view,
  runs one warm-up view with ``pipeline.compute_depthmap`` (which builds
  the kernels on a checkout's first run), loads the native writer and
  flushes the host's written files to disk (``os.sync``), so that no
  earlier writing is still in flight in the window.  A barrier follows;
  the window starts when rank 0 leaves it.  ``setup_s``
  runs from ``run.py``'s start to then, on the host's monotonic clock,
  which every process of the host shares.
* The window.  Each rank calls ``gipuma_tpu_torch.cli.main`` with the
  configuration's flags (the script as written), the mix's flags and the
  folders, once a scan, each scan into a fresh output folder; a barrier
  after ``main`` ends the scan.  The mix fixes the number of scans, so
  ``--seconds`` does not decide how much work a run does (a scan that
  ends near the deadline would otherwise make runs of one scan and of
  two).  The ranks' standard output goes to standard error.
* The check runs in this process on the first card, after every rank has
  exited, from the files the scans wrote (``folder_check``), and the
  folder is removed.

A traced run (``--trace 1``) times the program's layers in every rank by
host-clock shims round ``pipeline.run_batch``, ``run_prepared_job``,
``write_outputs`` and ``fusion.sharded.fuse_depthmaps_sharded``, and
profiles every rank's device (on the cards) from the start of its last
view to the end of the scan; the trace is read over the window they all
cover, from the start of the last rank's last view to the end of the
first fusion to end.

Readers hook into every rank as ``core.run_cell``'s do into its one
process: each rank calls ``install(rctx)`` (a ``RankCtx``) on every reader
of the run that has one (the end-to-end readers of an untraced run, the
per-layer readers of a traced one) at the end of set-up, before the
barrier that starts the window, and calls the undo function that each
returns after the last scan.  What a hook records goes into
``rctx.store``, which the rank sends back with its record; the parent's
``read(ctx)`` sees ``ctx.ranks``: per rank, in rank order, a dict of its
``store``, its ``scans`` (each ``cli.main`` call's (start, end)
perf_counter_ns), its ``trace_start`` (perf_counter_ns its profiler
started; None where it did not) and ``trace_start_cost`` (ns the start
took).  A hook that raises fails its rank, which ends the run.

A rank that raises, dies or outlives its limit (``SETUP_LIMIT_S`` for
set-up, ``SCAN_LIMIT_S`` a scan) ends the run: every rank is killed and
``RunFailed`` is raised, so ``run.py`` prints no result and exits non-zero.
"""
from __future__ import annotations

import collections
import importlib.util
import math
import os
import pickle
import queue as queue_mod
import shutil
import socket
import sys
import time
import traceback
import types
from pathlib import Path

import numpy as np

from . import core

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SCAN_DIR = ROOT / ".portbench_cache" / "scan"
# Set-up includes nvcc builds of every kernel on a checkout's first run.
SETUP_LIMIT_S = 900.0
SCAN_LIMIT_S = 300.0
# Idle gaps are named by the innermost of these spans the host was in.
SPAN_DEPTH = {"cli": 0, "run_batch": 1, "fusion": 1, "write_outputs": 2}


class RunFailed(RuntimeError):
    """A rank failed, died or outlived its limit; every rank is ended."""


def cli_flags(cfg: dict, mix: dict) -> list[str]:
    """The command line's flags: the configuration's (the script as
    written), then the mix's.  Raises ConfigError where the program's
    parser would not run the method and the fusion the configuration
    states."""
    if mix.get("params"):
        raise core.ConfigError("a folder mix hands the command line flags, "
                               "not params")
    from gipuma_tpu_torch.cli import build_parser
    core.program_params(cfg, mix)
    flags = list(cfg["flags"]) + list(mix.get("flags", []))
    args = build_parser().parse_args(flags)
    fus = cfg["fusion"]
    bad = [f"{k}={getattr(args, k)!r} (stated {fus[k]!r})"
           for k in ("disp_thresh", "normal_thresh", "num_consistent")
           if getattr(args, k) != fus[k]]
    bad += [f"--{k} missing" for k in ("all_views", "fuse", "distributed")
            if not getattr(args, k)]
    if bad:
        raise core.ConfigError("the command line would not run the "
                               "configuration as stated: " + ", ".join(bad))
    return flags


def flatten(spans) -> list:
    """Disjoint (start, end, label) pieces of nested (start, end, label)
    spans, each piece named by the innermost span over it."""
    pts = sorted({t for a, b, _ in spans for t in (a, b)})
    out = []
    for a, b in zip(pts, pts[1:]):
        cover = [(SPAN_DEPTH[lab], lab) for s, e, lab in spans
                 if s <= a and b <= e]
        if not cover:
            continue
        lab = max(cover)[1]
        if out and out[-1][1] == a and out[-1][2] == lab:
            out[-1] = (out[-1][0], b, lab)
        else:
            out.append((a, b, lab))
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _load_hook(hook):
    path, name = hook
    spec = importlib.util.spec_from_file_location("portbench_folder_hook",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name)


class RankCtx:
    """What a reader's ``install(rctx)`` gets in each rank of a folder run:
    ``rank``, ``world``, ``device``, ``profiling`` (whether the rank's
    profiler is on, read at each use), ``store`` (a dict of picklable
    values the rank sends back; the parent's readers see it in
    ``ctx.ranks``, as the module's docstring says) and ``time_calls``."""

    def __init__(self, rank: int, world: int, device, state: dict):
        self.rank, self.world, self.device = rank, world, device
        self.store: dict = {}
        self._state = state

    @property
    def profiling(self) -> bool:
        return self._state["tracer"] is not None

    def time_calls(self, mod, attr: str, key: str, before=None):
        """Time each call of mod.<attr>: its (start, end) perf_counter_ns
        go to store[key]; returns the undo function."""
        return _time_calls(mod, attr, self.store.setdefault(key, []),
                           before)


def _rank_main(rank: int, world: int, port: int, job: dict, q) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.stdout.flush()
    os.dup2(sys.stderr.fileno(), 1)
    sys.stdout = sys.stderr
    try:
        rec = _rank(rank, world, job, q)
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1) from None
    q.put((rank, "done", rec))
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank(rank: int, world: int, job: dict, q) -> dict:
    """One rank: set-up, the scans, and what the parent reads of them."""
    import torch
    import torch.distributed as dist
    from gipuma_tpu_torch import cli, pipeline
    from gipuma_tpu_torch.fusion import sharded
    from gipuma_tpu_torch.io import native
    from gipuma_tpu_torch.parallel import distributed
    from . import folder_check, folder_io, scene as scene_mod
    from . import trace as trace_mod

    cfg, scans = job["cfg"], len(job["outs"])
    n = cfg["rig"]["views"]

    def barrier():          # a world of one rank has no process group
        if dist.is_initialized():
            dist.barrier()

    steps = {"imports": time.perf_counter()}
    distributed.init_distributed(device=job["device"])
    dev = distributed.rank_device(job["device"])
    cuda = dev.type == "cuda"
    steps["init"] = time.perf_counter()
    names = folder_check.view_names(n)
    scene = scene_mod.make_scene(cfg, job["seed"], dev)
    steps["render"] = time.perf_counter()
    for v in range(rank, n, world):
        folder_io.write_png(Path(job["images"]) / f"{names[v]}.png",
                            scene.images[v])
        folder_io.write_P(Path(job["cameras"]) / f"{names[v]}.png.P",
                          scene.Ps[v])
    steps["write"] = time.perf_counter()
    params = core.program_params(cfg, job["mix"])
    pipeline.compute_depthmap(scene.images, scene.Ps, params, names,
                              ref_index=rank % n, device=dev)
    native.available()
    if job["trace"] and cuda:
        # The profiler's first start (CUPTI) takes seconds: not in a view.
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device=dev).add_(1)
            torch.cuda.synchronize()
    del scene
    steps["warm_up"] = time.perf_counter()
    os.sync()
    steps["sync"] = time.perf_counter()
    spans = collections.defaultdict(list)
    state = {"tracer": None, "start": None, "start_cost": 0}
    rctx = RankCtx(rank, world, dev, state)
    undo = []
    for name in job["readers"]:
        mod = core.metric_module(name)
        if hasattr(mod, "install"):
            undo.append(mod.install(rctx))
    steps["install"] = time.perf_counter()
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
    barrier()
    steps["barrier"] = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_window = time.perf_counter()
    q.put((rank, "ready", None))

    base = list(job["flags"]) + ["-images_folder", job["images"],
                                 "-p_folder", job["cameras"]]
    if not cuda:
        base += ["--device", "cpu"]
    if job["hook"]:
        _load_hook(job["hook"])(rank, base)
    if job["trace"]:
        last = scans * len(distributed.owned_jobs(n, rank, world)) - 1

        def start_at_last_view():
            if len(spans["run_prepared_job"]) == last:
                t0 = time.perf_counter_ns()
                if cuda:
                    state["tracer"] = trace_mod.Tracer(torch).__enter__()
                state["start"] = time.perf_counter_ns()
                state["start_cost"] = state["start"] - t0

        for mod, attr, key, before in (
                (pipeline, "run_batch", "run_batch", None),
                (pipeline, "run_prepared_job", "run_prepared_job",
                 start_at_last_view),
                (pipeline, "write_outputs", "write_outputs", None),
                (sharded, "fuse_depthmaps_sharded", "fusion", None)):
            _time_calls(mod, attr, spans[key], before)
    rcs, ends = [], []
    for out in job["outs"]:
        t0 = time.perf_counter_ns()
        rcs.append(cli.main(base + ["-output_folder", out]))
        spans["cli"].append((t0, time.perf_counter_ns()))
        barrier()
        ends.append(time.perf_counter())
    for u in reversed(undo):
        if u is not None:
            u()
    pickle.dumps(rctx.store)        # fails here, with a traceback, if not
    window_peak = 0
    if cuda:
        torch.cuda.synchronize()
        window_peak = torch.cuda.max_memory_allocated()
    events = None
    if state["tracer"] is not None:
        state["tracer"].__exit__(None, None, None)
        events = state["tracer"].events
    return {"rank": rank, "t_window": t_window, "ends": ends, "rcs": rcs,
            "setup_peak": setup_peak, "window_peak": window_peak,
            "device_name": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "setup_steps": steps, "spans": dict(spans),
            "trace_start": state["start"],
            "trace_start_cost": state["start_cost"],
            "events": events, "store": rctx.store,
            "forbidden": core.forbidden_modules(sys.modules)}


def _time_calls(mod, attr: str, out: list, before=None):
    """Wrap mod.<attr>: each call's (start, end) perf_counter_ns goes to
    `out`; before() runs ahead of each call.  Returns the undo function."""
    orig = getattr(mod, attr)

    def shim(*args, **kw):
        if before is not None:
            before()
        t0 = time.perf_counter_ns()
        try:
            return orig(*args, **kw)
        finally:
            out.append((t0, time.perf_counter_ns()))

    setattr(mod, attr, shim)
    return lambda: setattr(mod, attr, orig)


def _spawn(job: dict, world: int, limits, log) -> list[dict]:
    """Run the ranks; their records in rank order.  Raises RunFailed (every
    rank ended) if one raises, dies or outlives its limit."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, job, q),
                         daemon=True) for r in range(world)]
    ready, done = set(), {}
    deadline = time.monotonic() + limits[0]
    try:
        for p in procs:
            p.start()
        while len(done) < world:
            try:
                rank, kind, payload = q.get(timeout=0.5)
            except queue_mod.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in done}
                if dead:
                    try:
                        rank, kind, payload = q.get(timeout=5.0)
                    except queue_mod.Empty:
                        raise RunFailed(f"rank(s) exited without a result: "
                                        f"exit codes {dead}") from None
                elif time.monotonic() > deadline:
                    stage = "set-up" if len(ready) < world else "the scans"
                    raise RunFailed(f"{stage} outlived its limit; ranks "
                                    f"ready {sorted(ready)}, done "
                                    f"{sorted(done)}")
                else:
                    continue
            if kind == "error":
                raise RunFailed(f"rank {rank} failed:\n{payload}")
            if kind == "ready":
                ready.add(rank)
                if len(ready) == world:
                    deadline = time.monotonic() + len(job["outs"]) * limits[1]
            else:
                done[rank] = payload
        for p in procs:
            p.join(timeout=60.0)
        return [done[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10.0)
        q.close()


def _trace_numbers(recs: list[dict]) -> dict:
    """busy_s (mean over ranks), window_s and the breakdown (device seconds
    by name and idle seconds by host span, each a mean over ranks) over the
    window every rank's trace covers: from the latest trace start to the
    earliest end of a rank's fusion."""
    from . import trace as trace_mod
    lo = max(r["trace_start"] for r in recs)
    hi = min((r["spans"].get("fusion") or r["spans"]["cli"])[-1][1]
             for r in recs)
    world = len(recs)
    busy, ops, idle = 0.0, collections.Counter(), collections.Counter()
    for r in recs:
        names, ids, starts, durs = r["events"]
        phases = flatten([(a, b, lab) for lab in SPAN_DEPTH
                          for a, b in r["spans"].get(lab, [])])
        red = trace_mod.reduce(types.SimpleNamespace(events=r["events"]),
                               lo, hi, phases)
        busy += red["busy_s"] / world
        for k in np.nonzero(red["device_ns_by_name"])[0]:
            ops[names[k][:120]] += (float(red["device_ns_by_name"][k])
                                    / 1e9 / world)
        inside = (starts >= lo) & (starts < hi)
        b = trace_mod.busy_union(starts[inside], durs[inside], lo, hi)
        for lab, ns in trace_mod.idle_by_phase(
                b, names, ids[inside], starts[inside], phases, lo,
                hi).items():
            idle[lab] += ns / 1e9 / world
    return {"busy_s": busy, "window_s": (hi - lo) / 1e9,
            "device_ops": [[k, v] for k, v in ops.most_common(10)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(10)]}


def _layer_numbers(recs: list[dict]) -> dict:
    """The per-layer readings of a traced run: rank 0's fusion walls and its
    write_outputs walls that ended before its trace started, and every
    rank's wall inside run_batch, less its profiler's start; and what the
    profiler adds to rank 0's traced view (its run_prepared_job wall over
    the mean of the views before it, minus 1)."""
    r0 = recs[0]
    s = lambda a, b: (b - a) / 1e9  # noqa: E731
    views = [s(a, b) for a, b in r0["spans"].get("run_prepared_job", [])]
    over = {}
    if len(views) > 1:
        over["traced"] = views[-1] / (sum(views[:-1]) / len(views[:-1])) - 1.0
    start = r0["trace_start"] or math.inf
    return {"trace_overhead": over,
            "fusion_s": [s(a, b) for a, b in r0["spans"].get("fusion", [])],
            "write_s": [s(a, b) for a, b in
                        r0["spans"].get("write_outputs", []) if b <= start],
            "run_batch_s": [sum(s(a, b) for a, b in
                                r["spans"].get("run_batch", []))
                            - r["trace_start_cost"] / 1e9 for r in recs]}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=None, *, hook=None,
             limits=(SETUP_LIMIT_S, SCAN_LIMIT_S)) -> dict:
    """One run of a folder cell on one rank a chip of the cell; returns the
    result line's object (as core.run_cell does).  hook: (file, function)
    a test plants in every rank, called as function(rank, argv) before the
    scans; limits: (set-up, a scan) in seconds."""
    import torch
    from . import check, folder_check

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cfg, mix = cell.config, cell.mix
    flags = cli_flags(cfg, mix)
    world = cell.workload["chips"]
    cuda = torch.device(device).type == "cuda"
    names = [m["name"] for m in (cell.per_layer if trace else cell.end_to_end)]
    readers = {k: core.metric_module(k) for k in names}
    shutil.rmtree(SCAN_DIR, ignore_errors=True)
    job = {"cfg": cfg, "mix": mix, "flags": flags, "seed": seed,
           "trace": trace, "device": "cuda" if cuda else "cpu",
           "images": str(SCAN_DIR / "images"),
           "cameras": str(SCAN_DIR / "cameras"),
           "outs": [str(SCAN_DIR / f"out{k}")
                    for k in range(int(mix.get("scans", 1)))],
           "hook": hook, "readers": names}
    for k in ("images", "cameras"):
        Path(job[k]).mkdir(parents=True)
    try:
        recs = _spawn(job, world, limits, log)
        bad = sorted({m for r in recs for m in r["forbidden"]})
        if bad:
            raise RunFailed("forbidden modules loaded in a rank: "
                            + ", ".join(bad))
        r0 = recs[0]
        rcs = [r["rcs"] for r in recs]
        ctx = core.Ctx(r0["device_name"])
        ctx.window_start = r0["t_window"]
        ctx.setup_s = r0["t_window"] - t_start
        ctx.peak_window_bytes = max(r["window_peak"] for r in recs)
        ctx.ranks = [{"rank": r["rank"], "store": r["store"],
                      "scans": r["spans"]["cli"],
                      "trace_start": r["trace_start"],
                      "trace_start_cost": r["trace_start_cost"]}
                     for r in recs]
        peak = max(max(r["setup_peak"], r["window_peak"]) for r in recs)
        log(f"[portbench] {cell.workload['name']} seed {seed}: set-up "
            f"{ctx.setup_s:.3f} s, {len(job['outs'])} scan(s) on {world} "
            f"ranks, window {r0['ends'][-1] - r0['t_window']:.3f} s "
            f"(--seconds {seconds:g} does not set the work), main's exit "
            f"codes {rcs}")
        log("[portbench] set-up steps, s from the start (rank: imports, "
            "init, render, write, warm_up, sync, install, barrier): "
            + "; ".join(f"{r['rank']}: " + " ".join(
                f"{t - t_start:.2f}" for t in r["setup_steps"].values())
                for r in recs))
        if trace:
            if all(r["trace_start"] is not None and r["events"] is not None
                   for r in recs):
                ctx.trace = _trace_numbers(recs)
            ctx.folder = _layer_numbers(recs)
            log(f"[portbench] layer walls: {ctx.folder}")
        del recs

        # The check: every rank has exited.
        t_chk = time.perf_counter()
        scene = folder_check.bare_scene(cfg)
        trim = cfg["check"]["trim"]
        failed, errs, nums = 0, [], []
        for out, end in zip(job["outs"], r0["ends"]):
            outs, missing, cloud = folder_check.read_scan(Path(out),
                                                          len(scene.cameras))
            failed += len(missing)
            t_read = time.perf_counter()
            scan_errs = [check.rel_errors(scene, o, device, trim)
                         for o in outs]
            errs += scan_errs
            t_err = time.perf_counter()
            nums.append(folder_check.judge(scene, outs, missing, cloud, cfg,
                                           seed, device, scan_errs))
            log(f"[portbench] check: read {t_read - t_chk:.3f} s, ground "
                f"truth {t_err - t_read:.3f} s, judge "
                f"{time.perf_counter() - t_err:.3f} s")
            for o in outs:
                o.normals = None
                ctx.views.append(core.ViewRecord(o.ref, r0["t_window"],
                                                 r0["t_window"], end, o))
            shutil.rmtree(out)
        ctx.rel_err_all = torch.cat(errs) if errs else None
        joined = {k: (sum if k == "views_wrong" else max)(x[k] for x in nums)
                  for k in nums[0]}
        ok, rows = check.verdict(joined, cell.limits.get("checks", {}))
        correct = (ok and failed == 0 and len(ctx.views) > 0
                   and all(rc == 0 for r in rcs for rc in r))
        log(f"[portbench] check {time.perf_counter() - t_chk:.3f} s over "
            f"{len(ctx.views)} views")
    finally:
        shutil.rmtree(SCAN_DIR, ignore_errors=True)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": r0["device_name"], "count": world,
                   "memory_peak_bytes": peak}
    if ctx.trace is not None:
        device_info["busy_s"] = ctx.trace["busy_s"]
        device_info["window_s"] = ctx.trace["window_s"]
    result = {"correct": bool(correct),
              "attempted": len(scene.cameras) * len(job["outs"]),
              "failed": failed, "metrics": metrics, "device": device_info}
    if ctx.trace is not None:
        result["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                               "idle_gaps": ctx.trace["idle_gaps"]}
    if trace:
        result["trace_overhead"] = ctx.folder["trace_overhead"]
    result["views"] = len(ctx.views)
    result["checks"] = rows
    return result


def reading(cell, seed: int, device, log=print) -> dict:
    """One seed's readings for the cell's limits: a whole run's numbers and
    the control's (``folder_check.control_numbers``) on the same seed."""
    import json

    import torch
    from . import folder_check
    t0 = time.perf_counter()
    res = run_cell(cell, seed, 0.0, False, device, t0,
                   log=lambda *a: print(*a, file=sys.stderr, flush=True))
    t1 = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    line = {"seed": seed,
            "program": {k: r["value"] for k, r in res["checks"].items()},
            "control": folder_check.control_numbers(cell.config, seed, device),
            "failed": res["failed"], "run_s": t1 - t0,
            "control_s": time.perf_counter() - t1}
    log(json.dumps(line))
    return line
