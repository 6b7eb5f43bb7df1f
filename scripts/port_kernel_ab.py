#!/usr/bin/env python3
"""A/B of the port's fused window cost on one NVIDIA GPU, in turns.

    python3 scripts/port_kernel_ab.py --old-fused PATH [--rounds 3]
        [--variant NAME:SOURCE ...] [--sass]

PATH is an earlier csrc/sdg_fused.cu with the same C interface (the
one-thread-per-(k, i, j) design, e.g. `git show
98d552d:gipuma_tpu_torch/csrc/sdg_fused.cu`).  It is built here with nvcc,
with -fmad=false as every source was built before the per-source flags,
into gipuma_tpu_torch/build/ab/, and driven through the current wrapper
(ops/sdg_fused.fused_sdg_cost_batch_cuda), so every design sees the same
arguments.  The current source ("new") always runs; each --variant adds
another SOURCE with the same C interface (an alternative design), built
with the current source's flags.  --sass prints, per build, the static
instruction count of the main path's two instantiations (the K=1 box 11
and K=4 cull tile kernels) and their commonest opcodes (cuobjdump).

Inputs: view 0 of chip_smoke.py's bench scene (640x480, 7 cameras, rect
path): K=1 at box 11 / inc 2 (the full pass) and K=4 at the cull box 9 /
inc 4 (the sparse pass), with the scene's hw_valid and tile mask.  Per
round the order is old, new, then each variant, then the same reversed; each
time is chip_smoke.graph_ms (device time per call, CUDA graph replay).
Each design is also held to the plain version at covered pixels (max
|diff|).  Prints one JSON line per shape, then the card line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def print_sass(name, lib) -> None:
    """Static instruction counts of the main path's two fused
    instantiations in `lib` (tile kernel <C=1, T=6, inc 2, one-sided, K=1>
    and <1, 3, 4, one-sided, K>1>, or the old kernel's <1, 8, one-sided>)."""
    from collections import Counter
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    funcs, cur = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            cur = ln.split("Function :")[1].strip()
            funcs[cur] = Counter()
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln):
            op = ln.split("*/", 1)[1].strip().split(" ")[0]
            if op.startswith("@"):
                op = ln.split("*/", 1)[1].strip().split(" ")[1]
            funcs[cur][op.rstrip(";")] += 1
    for f, cnt in funcs.items():
        if not any(t in f for t in ("ILi1ELi6ELb1ELb0E", "ILi1ELi3ELb1ELb1E",
                                    "ILi1ELi6ELi2ELb1ELb0E",
                                    "ILi1ELi3ELi4ELb1ELb1E",
                                    "sdg_fused_kernelILi1ELi8ELb1E")):
            continue
        print(json.dumps({"sass": name, "function": f,
                          "instructions": sum(cnt.values()),
                          "top": cnt.most_common(30)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-fused", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("port_kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gipuma_tpu_torch import kernels
    from gipuma_tpu_torch.ops import sdg_fused as tsf
    from gipuma_tpu_torch.pipeline import prepare_job

    out_dir = kernels.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # Build the old source and every variant, all at once.
    builds = {"old": ([*kernels.NVCC_FLAGS, "-fmad=false"], args.old_fused)}
    for spec in args.variant:
        name, src = spec.split(":", 1)
        if name in ("old", "new") or name in builds:
            ap.error(f"--variant {spec}: the name {name!r} is taken")
        builds[name] = (kernels.flags("sdg_fused"), src)
    procs = {}
    for name, (flags, src) in builds.items():
        lib = out_dir / f"libsdg_fused_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [kernels.nvcc_path(), *flags, "-o", str(lib), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {"new": tsf._cuda_fn()}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        for ln in out.splitlines():
            if ("registers" in ln or "spill" in ln or "error" in ln
                    or "Function properties" in ln):
                print(f"  ptxas[{name}]: {ln.strip()}", flush=True)
        if proc.returncode != 0:
            print(f"port_kernel_ab: build of {name} failed", file=sys.stderr)
            return 1
        fn = ctypes.CDLL(str(lib)).gtt_sdg_fused_cost
        fn.argtypes = [vp] * 7 + [ci] * 13 + [cf] * 7 + [vp]
        fn.restype = ci
        fns[name] = fn
    if args.sass:
        libs = {n: lib for n, (lib, _) in procs.items()}
        libs["new"] = kernels._target("sdg_fused")
        for n, lib in libs.items():
            print_sass(n, lib)

    device = torch.device("cuda")
    images, _, _, Ps, paths = cs.scene_setup()
    job = prepare_job(images, Ps, paths["rect"], device=device)
    scene, jparams = job.prep, job.params
    _, abc_of = cs.bench_inputs(torch, scene, jparams, device)
    v0 = 0
    ref_v, src_v = scene.ref_rect[v0], scene.src_rect[v0]
    db_v = scene.disp_bounds[v0].contiguous()
    hw_v = scene.hw_valid[v0].contiguous()
    tm_v = scene.tile_ok[v0].contiguous()
    hrp, wrp = ref_v.shape[-2:]
    cov = tm_v.to(torch.bool).repeat_interleave(8, 0).repeat_interleave(
        128, 1)[:hrp, :wrp].clone()
    hv, wv = (int(a) for a in scene.hw_valid[v0].tolist())
    cov[(hv + 7) // 8 * 8:] = False
    cov[:, (wv + 127) // 128 * 128:] = False
    npx = int(cov.sum())
    cull_p = jparams.replace(box_hsize=jparams.cull_box,
                             box_vsize=jparams.cull_box,
                             window_increment=jparams.cull_increment)
    card = cs.card_line()

    def variant(name):
        tsf._FN = fns[name]

    names = ["old", "new", *(n for n in fns if n not in ("old", "new"))]
    for label, p, K, pack in (("full K=1 box 11/inc 2", jparams, 1, "pair"),
                              ("cull K=4 box 9/inc 4", cull_p, 4, "tri")):
        abc = abc_of(K, pack)
        want = tsf.fused_sdg_cost_batch_plain(ref_v, src_v, abc, p, db_v[0],
                                              db_v[1])
        errs, times = {}, {n: [] for n in names}
        for n in names:
            variant(n)
            got = tsf.fused_sdg_cost_batch_cuda(ref_v, src_v, abc, p, db_v,
                                                hw_v, tm_v)
            errs[n] = float((got - want).abs()[:, cov].max())
        for _ in range(args.rounds):
            for n in names + names[::-1]:
                variant(n)
                times[n].append(cs.graph_ms(
                    lambda: tsf.fused_sdg_cost_batch_cuda(
                        ref_v, src_v, abc, p, db_v, hw_v, tm_v)))
        bound, by, ops, nbytes = cs.fused_bound(p, K, ref_v.shape[0] // 3,
                                                npx)
        print(json.dumps({
            "ab": "sdg_fused_cost", "shape": label, "card": card,
            "covered_px": npx, "bound_ms": bound, "bound_by": by,
            "ms_median": {n: statistics.median(t) for n, t in times.items()},
            "ms_all": times, "max_abs_err_vs_plain": errs}), flush=True)
    tsf._FN = fns["new"]
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
