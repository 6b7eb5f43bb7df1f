#!/usr/bin/env python3
"""Device time of the port's paths, two trees in turns.

    python3 scripts/port_path_ab.py ROOT_A ROOT_B [--paths rect,pyramid]

ROOT_A and ROOT_B are checkouts of the repository (an earlier commit
unpacked beside the current tree, and the current tree).  Each runs in
its own interpreter, importing gipuma_tpu_torch and chip_smoke.py from its
root, in the order A, B, B, A.  Per path: the scene is prepared
(chip_smoke.scene_setup's bench scene and configuration), one warm run is
made, then a timed run (host wall, runtime_s, the peak of allocated
device memory) and a profiled run (torch.profiler, the device's activity
only): device seconds, busy share of the timed run, device launches in
all and by kind (the port's kernels, copy kernels), and the kernels with
the most device time.  Any chip_smoke.py path can be named (census and
unfused run the affine gather).  Prints one JSON line per (tree, path,
turn), then the card line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def child(root: str, tag: str, paths: list[str]) -> None:
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from gipuma_tpu_torch import kernels
    from gipuma_tpu_torch.pipeline import prepare_job, run_prepared_job

    device = torch.device("cuda")
    kernels.build()
    images, _, _, Ps, cfgs = cs.scene_setup()
    for label in paths:
        job = prepare_job(images, Ps, cfgs[label], device=device)
        run_prepared_job(job)
        torch.cuda.synchronize()
        kernels.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run_prepared_job(job)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = dict(kernels.counts)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_prepared_job(job)
            torch.cuda.synchronize()
        by_name = {}
        for ev in prof.profiler.kineto_results.events():
            if not str(ev.device_type()).endswith("CUDA"):
                continue
            us = ev.duration_ns() / 1e3
            if us > 0:
                tot, n = by_name.get(ev.name(), (0.0, 0))
                by_name[ev.name()] = (tot + us, n + 1)
        dev_us = sum(us for us, _ in by_name.values())
        port = ("row_gather_nearest_kernel", "sdg_fused_", "permute2d_kernel",
                "row_gather_affine_kernel")
        rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        print(json.dumps({
            "tree": tag, "path": label, "run_s": run_s,
            "runtime_s": res.runtime_s, "peak_alloc_gb": peak_gb,
            "device_s": dev_us / 1e6,
            "busy_share": dev_us / 1e6 / run_s,
            "device_launches": sum(n for _, n in by_name.values()),
            "copy_launches": sum(n for k, (_, n) in by_name.items()
                                 if "copy" in k.lower()),
            "port_kernels": {p: [sum(u for k, (u, _) in by_name.items()
                                     if p in k) / 1e3,
                                 sum(n for k, (_, n) in by_name.items()
                                     if p in k)] for p in port},
            "wrapper_launches": launches,
            "top": [[k[:70], u / 1e3, n] for k, (u, n) in rows[:10]]}),
            flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], sys.argv[3], sys.argv[4].split(","))
        return 0
    args = sys.argv[1:]
    paths = "rect,pyramid"
    if "--paths" in args:
        i = args.index("--paths")
        paths = args[i + 1]
        del args[i:i + 2]
    a, b = (os.path.abspath(r) for r in args)
    for tag, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--child", root, tag, paths], cwd=root).returncode
        if rc != 0:
            print(f"port_path_ab: tree {tag} ({root}) exited {rc}",
                  file=sys.stderr)
            return rc
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
