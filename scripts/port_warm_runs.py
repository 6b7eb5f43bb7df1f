#!/usr/bin/env python3
"""Repeated runs of prepared jobs on the card, and what slows them.

    python3 scripts/port_warm_runs.py [--paths rect,monolithic] [--runs 3]
                                      [--sessions 8]

Prepares each path of chip_smoke.scene_setup's bench scene once, then runs
every path `--runs` times in each of these states of the process, in
this order:

  fresh       nothing else has run;
  heap        with three million small Python objects alive (a process
              that has run a batch of views and holds its results), the
              garbage collector on;
  heap_nogc   the same with the collector off;
  profiled_S  after S torch.profiler sessions, S = 1 .. --sessions, each
              one run of each path with the device's activity recorded,
              as chip_smoke.py profiles a path.

Per run one JSON line: host wall (synchronised), runtime_s, the seconds
the collector spent in that run (gc.callbacks) and its collections per
generation, the caching allocator's new device allocations and its
allocation retries in that run, and the device memory reserved.  Then
the card line.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


class GcClock:
    """Seconds and collections of the garbage collector, by gc.callbacks."""

    def __init__(self):
        self.s, self.n, self._t0 = 0.0, [0, 0, 0], None
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.s += time.perf_counter() - self._t0
            self.n[info["generation"]] += 1
            self._t0 = None

    def reset(self):
        self.s, self.n = 0.0, [0, 0, 0]


def main() -> int:
    args = sys.argv[1:]
    paths, runs, sessions = ["rect", "monolithic"], 3, 8
    if "--paths" in args:
        paths = args[args.index("--paths") + 1].split(",")
    if "--runs" in args:
        runs = int(args[args.index("--runs") + 1])
    if "--sessions" in args:
        sessions = int(args[args.index("--sessions") + 1])
    import torch
    if not torch.cuda.is_available():
        print("port_warm_runs: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(HERE))
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from gipuma_tpu_torch import kernels
    from gipuma_tpu_torch.pipeline import prepare_job, run_prepared_job

    device = torch.device("cuda")
    kernels.build()
    images, _, _, Ps, cfgs = cs.scene_setup()
    jobs = {p: prepare_job(images, Ps, cfgs[p], device=device) for p in paths}
    for p in paths:                         # first runs, not reported
        run_prepared_job(jobs[p])
    clock = GcClock()

    def timed(state):
        for _ in range(runs):
            for p in paths:
                torch.cuda.synchronize()
                m0 = torch.cuda.memory_stats()
                clock.reset()
                t0 = time.perf_counter()
                res = run_prepared_job(jobs[p])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                m1 = torch.cuda.memory_stats()
                print(json.dumps({
                    "state": state, "path": p, "wall_s": wall,
                    "runtime_s": res.runtime_s, "gc_s": clock.s,
                    "gc_collections": list(clock.n),
                    "device_allocs": m1.get("num_device_alloc", 0)
                    - m0.get("num_device_alloc", 0),
                    "alloc_retries": m1["num_alloc_retries"]
                    - m0["num_alloc_retries"],
                    "reserved_GB": torch.cuda.memory_reserved() / 1e9}),
                    flush=True)

    timed("fresh")
    heap = [(i, str(i)) for i in range(3_000_000)]
    timed("heap")
    gc.disable()
    timed("heap_nogc")
    gc.enable()
    del heap
    for s in range(1, sessions + 1):
        for p in paths:
            with profile(activities=[ProfilerActivity.CUDA]):
                run_prepared_job(jobs[p])
                torch.cuda.synchronize()
        timed(f"profiled_{s}")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
