"""One run of one cell: set-up, the measured window, the check, the metrics.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration and a job
mix; both are data files found by name (``configs/<config>.json`` via the
configuration's ``file``, ``mixes/<traffic>.json``), as are the cell's
correctness limits (``limits/<workload>.json``) and every metric's reader
(``metrics/<metric>.py``).  A later cell, mix, configuration or metric is
added as files, with no edit here.

The window is a closed loop over the configuration's ``window_views``: the
first is drawn from the seed, the loop then walks the list (the entry
before the first is set-up's one warm-up view), and each view is the
program's ``pipeline.compute_depthmap`` as ``run_batch`` makes it,
``prepare_job`` then ``run_prepared_job`` (which ends with depth, normals
and cost on the host).  The loop starts no view after ``seconds`` and finishes the one it
is in.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gipuma_tpu")
# A traced run starts the profiler at the first view boundary after
# TRACE_FROM of the window has passed and stops it after TRACE_VIEWS views
# (or at the window's end).  The host-side readings come from the views
# that ended before it started: the profiler's host cost outlasts its stop.
TRACE_FROM = 1 / 2
TRACE_VIEWS = 6


class ConfigError(ValueError):
    """The cell's files are missing or the program would not run them as
    stated."""


def forbidden_modules(names) -> list[str]:
    """Loaded module names whose top-level name is a forbidden one."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def _load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise ConfigError(f"missing file {path}") from None


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = _load_json(root / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise ConfigError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next((c for c in bench["configs"] if c["name"] == wl["config"]),
                None)
    if conf is None:
        raise ConfigError(f"no configuration {wl['config']!r}")
    here = root / bench["paths"][0]
    return Cell(
        workload=wl, config=_load_json(root / conf["file"]),
        mix=_load_json(here / "mixes" / f"{wl['traffic']}.json"),
        limits=_load_json(here / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)])


def metric_module(name: str, here: Path = HERE):
    path = here / "metrics" / f"{name}.py"
    if not path.exists():
        raise ConfigError(f"no reader {path} for metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The configuration's ``method`` keys -> the program's AlgorithmParams
# fields that must hold them.
STATED = {"box": ("box_hsize", "box_vsize"), "increment": ("window_increment",),
          "tau_color": ("tau_color",), "tau_gradient": ("tau_gradient",),
          "alpha": ("alpha",), "gamma": ("gamma",), "n_best": ("n_best",),
          "iterations": ("iterations",), "min_angle": ("min_angle",),
          "max_angle": ("max_angle",), "max_views": ("max_views",),
          "depth_min": ("depth_min",), "depth_max": ("depth_max",),
          "selection_seed": ("seed",)}


def program_params(cfg: dict, mix: dict):
    """The program's parameters: the script's flags through the program's
    own command-line parser, then the mix's settings laid over them.
    Raises ConfigError where they differ from what the configuration
    states."""
    from gipuma_tpu_torch.cli import build_parser, params_from_args
    args = build_parser().parse_args(list(cfg["flags"]) + list(mix.get("flags", [])))
    params = params_from_args(args)
    if mix.get("params"):
        params = params.replace(**mix["params"])
    bad = [f"{f}={getattr(params, f)!r} (stated {v!r})"
           for k, v in cfg["method"].items() for f in STATED.get(k, ())
           if getattr(params, f) != v]
    if params.cost_comb.name.lower() != cfg["method"]["cost_comb"]:
        bad.append(f"cost_comb={params.cost_comb.name}")
    if params.algorithm.name.lower() != cfg["method"]["algorithm"]:
        bad.append(f"algorithm={params.algorithm.name}")
    if bad:
        raise ConfigError("the program would not run the configuration as "
                          "stated: " + ", ".join(bad))
    return params


@dataclasses.dataclass
class ViewRecord:
    ref: int
    t0: float            # prepare_job called
    t1: float            # prepare_job returned (synced to the device)
    t2: float            # run_prepared_job returned
    out: object          # check.ViewOutput
    traced: bool = False


class Ctx:
    """What the metric readers read."""

    def __init__(self, device_name: str):
        from . import peaks as peaks_mod
        self.peaks = peaks_mod.peaks(device_name)
        self.setup_s = None
        self.window_start = None
        self.views: list[ViewRecord] = []
        self.rel_err_all = None
        self.peak_window_bytes = 0
        self.trace = None            # trace.reduce(...) of the traced views
        self.trace_start = None      # perf_counter s the profiler started
        self.trace_stop = None       # and stopped at
        self.trace_overhead = None   # trace_overhead(ctx)
        self.tracing = False         # a shim records only while True
        self.shim_calls: dict[str, list] = {}


def per_view_s(views) -> float | None:
    """Wall per view over consecutive views: from the first one's start to
    the last one's end (the harness's steps between views included)."""
    return (views[-1].t2 - views[0].t0) / len(views) if views else None


def before_trace(ctx) -> list:
    """The views of a traced run that ended before the profiler started."""
    if ctx.trace_start is None:
        return []
    return [v for v in ctx.views if v.t2 <= ctx.trace_start]


def trace_overhead(ctx) -> dict:
    """Wall per view while the profiler ran ("traced") and after it stopped
    ("after"), each over wall per view before it started, minus 1: what the
    profiler adds on the host (the device's idle share in the traced
    window holds it)."""
    base = per_view_s(before_trace(ctx))
    parts = {"traced": [v for v in ctx.views if v.traced],
             "after": [v for v in ctx.views
                       if ctx.trace_stop is not None and v.t0 >= ctx.trace_stop]}
    return {k: per_view_s(vs) / base - 1.0
            for k, vs in parts.items() if vs and base}


def run_view(pipeline, scene, params, ref: int, device, sync):
    from .check import ViewOutput
    names = [f"view{i:03d}" for i in range(len(scene.images))]
    t0 = time.perf_counter()
    job = pipeline.prepare_job(scene.images, scene.Ps, params, names,
                               ref_index=ref, device=device)
    if sync:
        sync()
    t1 = time.perf_counter()
    res = pipeline.run_prepared_job(job)
    t2 = time.perf_counter()
    out = ViewOutput(ref, list(res.view_subset), res.depth_min, res.depth_max,
                     res.depth, res.normals, res.cost)
    return ViewRecord(ref, t0, t1, t2, out)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=None) -> dict:
    """One run; returns the result line's object (without the forbidden
    module check, which the caller makes last)."""
    import torch
    from gipuma_tpu_torch import pipeline
    from . import check, scene as scene_mod
    from . import trace as trace_mod

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else None
    device_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    params = program_params(cell.config, cell.mix)
    ctx = Ctx(device_name)
    names = [m["name"] for m in (cell.per_layer if trace else cell.end_to_end)]
    readers = {n: metric_module(n) for n in names}

    scene = scene_mod.make_scene(cell.config, seed, device)
    refs = cell.config["window_views"]
    rng = np.random.default_rng([seed, 1])
    start = int(rng.integers(len(refs)))
    warm = refs[start - 1]
    run_view(pipeline, scene, params, warm, device, None)
    if cuda:
        torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    undo = []
    if trace:
        for n, mod in readers.items():
            if hasattr(mod, "install"):
                undo.append(mod.install(ctx))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ctx.setup_s = time.perf_counter() - t_start
    log(f"[portbench] {cell.workload['name']} seed {seed}: set-up "
        f"{ctx.setup_s:.3f} s, first view {refs[start]}, warm-up view {warm}")

    attempted = failed = 0
    tracer = trace_mod.Tracer(torch) if trace else None
    span = {}

    def start_trace():
        tracer.__enter__()
        span["lo"] = time.perf_counter_ns()
        ctx.trace_start = span["lo"] / 1e9
        ctx.tracing = True

    def stop_trace():
        span["hi"] = time.perf_counter_ns()
        ctx.trace_stop = span["hi"] / 1e9
        ctx.tracing = False
        tracer.__exit__(None, None, None)

    ctx.window_start = time.perf_counter()
    k = 0
    try:
        while True:
            ref = refs[(start + k) % len(refs)]
            k += 1
            attempted += 1
            traced = ctx.tracing
            try:
                rec = run_view(pipeline, scene, params, ref, device, sync)
                rec.traced = traced
                ctx.views.append(rec)
            except Exception:  # noqa: BLE001 - a failed view is counted
                failed += 1
                log(traceback.format_exc())
            elapsed = time.perf_counter() - ctx.window_start
            if elapsed >= seconds:
                break
            if ctx.tracing and sum(v.traced for v in ctx.views) >= TRACE_VIEWS:
                stop_trace()
            elif (tracer is not None and ctx.trace_start is None
                  and elapsed >= TRACE_FROM * seconds):
                start_trace()
    finally:
        if ctx.tracing:
            stop_trace()
    if cuda:
        torch.cuda.synchronize()
        ctx.peak_window_bytes = torch.cuda.max_memory_allocated()
    log("[portbench] views (ref, prepare s, run s): " + " ".join(
        f"{v.ref}:{v.t1 - v.t0:.3f}/{v.t2 - v.t1:.3f}" for v in ctx.views))
    for u in undo:
        u()
    if ctx.trace_start is not None:
        phases = [(int(t * 1e9), int(u * 1e9), lab)
                  for v in ctx.views if v.traced
                  for t, u, lab in ((v.t0, v.t1, "prepare_job"),
                                    (v.t1, v.t2, "run_prepared_job"))]
        ctx.trace = trace_mod.reduce(tracer, span["lo"], span["hi"], phases)
        tracer.events = None
        ctx.trace_overhead = trace_overhead(ctx)
        log(f"[portbench] wall per view against the views before the "
            f"profiler: {ctx.trace_overhead}")

    # The check: after the window, with the program's state released.
    outs = [v.out for v in ctx.views]
    if cuda:
        torch.cuda.empty_cache()
    t_chk = time.perf_counter()
    trim = cell.config["check"]["trim"]
    errs = [check.rel_errors(scene, o, device, trim) for o in outs]
    ctx.rel_err_all = torch.cat(errs) if errs else None
    nums = check.judge(scene, outs, cell.config, seed, device)
    ok, rows = check.verdict(nums, cell.limits.get("checks", {}))
    correct = ok and failed == 0 and len(outs) > 0
    log(f"[portbench] check {time.perf_counter() - t_chk:.3f} s over "
        f"{len(outs)} views")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": device_name,
                   "count": 1,
                   "memory_peak_bytes": max(setup_peak, ctx.peak_window_bytes)}
    if ctx.trace is not None:
        device_info["busy_s"] = ctx.trace["busy_s"]
        device_info["window_s"] = ctx.trace["window_s"]
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if ctx.trace is not None:
        result["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                               "idle_gaps": ctx.trace["idle_gaps"]}
    if ctx.trace is not None:
        result["trace_overhead"] = ctx.trace_overhead
    result["views"] = len(outs)
    result["checks"] = rows
    return result
