#!/usr/bin/env python3
"""A/B of the port's redesigned kernels on one NVIDIA GPU, in turns.

    python3 scripts/port_kernel_ab.py [--old-fused PATH] [--old-affine PATH]
        [--rounds 3] [--variant NAME:SOURCE ...]
        [--affine-variant NAME:SOURCE ...] [--sass]

--old-fused PATH is an earlier csrc/sdg_fused.cu with the same C interface
(the one-thread-per-(k, i, j) design, e.g. `git show
98d552d:gipuma_tpu_torch/csrc/sdg_fused.cu`); --old-affine PATH an earlier
csrc/rowgather_affine.cu with the one-row C interface gtt_row_gather_affine
(the one-thread-per-(k, i, j) design, `git show
9e9bc71:gipuma_tpu_torch/csrc/rowgather_affine.cu`).  Each is built here
with nvcc, with -fmad=false as those designs were built, into
gipuma_tpu_torch/build/ab/.  The current sources ("new") always run; each
--variant (fused) or --affine-variant adds another SOURCE with the current
source's C interface (an alternative design), built with the current
source's flags.  --sass prints, per build, the static instruction count of
the main instantiations (the fused K=1 box 11 and K=4 cull tile kernels;
the affine gather's E=11 and E=9 shared-memory kernels) and their
commonest opcodes (cuobjdump).

Inputs: view 0 of chip_smoke.py's bench scene (640x480, 7 cameras, rect
path).  Fused: K=1 at box 11 / inc 2 (the full pass) and K=4 at the cull
box 9 / inc 4 (the sparse pass), with the scene's hw_valid and tile mask,
through the current wrapper (ops/sdg_fused.fused_sdg_cost_batch_cuda).
Affine: chip_smoke.py's one-row launch (K=4 x 11 columns at the window
corner) and the census and unfused paths' launches of one view and
evaluation (census sparse K=4 x 9 rows x 9 columns, full K=1 x 11 x 11,
centre K=4 x 1 x 1; unfused one-sided K=1 x 6 x 6 and K=4 x 3 x 3): the old
design as one launch per window row (as those paths launched it), the
current source as one rows launch ("new") and as one launch per row
("new_per_row"), each variant as one rows launch.  Per round the order is
old, new, then the others, then the same reversed; each time is
chip_smoke.graph_ms (device time per call, CUDA graph replay).  Fused
designs are held to the plain version at covered pixels (max |diff|), the
affine ones bitwise (NaN included).  Prints one JSON line per shape, then
the card line.
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
                                    "sdg_fused_kernelILi1ELi8ELb1E",
                                    "row_gather_affine_kernelILi11ELb1E",
                                    "row_gather_affine_kernelILi9ELb1E",
                                    "row_gather_affine_kernelEPKi")):
            continue
        print(json.dumps({"sass": name, "function": f,
                          "instructions": sum(cnt.values()),
                          "top": cnt.most_common(30)}), flush=True)


def build_all(builds: dict, out_dir) -> dict:
    """nvcc every {(kernel, name): (flags, source)} at once; returns
    {(kernel, name): library path}, None when a build failed."""
    from gipuma_tpu_torch import kernels
    procs = {}
    for (kern, name), (flags, src) in builds.items():
        lib = out_dir / f"lib{kern}_{name}.so"
        procs[(kern, name)] = (lib, subprocess.Popen(
            [kernels.nvcc_path(), *flags, "-o", str(lib), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        for ln in out.splitlines():
            if ("registers" in ln or "spill" in ln or "error" in ln
                    or "Function properties" in ln):
                print(f"  ptxas[{key[0]}:{key[1]}]: {ln.strip()}", flush=True)
        if proc.returncode != 0:
            print(f"port_kernel_ab: build of {key} failed", file=sys.stderr)
            return None
        libs[key] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-fused")
    ap.add_argument("--old-affine")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--affine-variant", action="append", default=[])
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    if not (args.old_fused or args.old_affine):
        ap.error("give --old-fused and / or --old-affine")

    import torch
    if not torch.cuda.is_available():
        print("port_kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gipuma_tpu_torch import kernels
    from gipuma_tpu_torch.pipeline import prepare_job

    out_dir = kernels.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    # Build the old sources and every variant, all at once.
    old_flags = [*kernels.NVCC_FLAGS, "-fmad=false"]
    builds = {}
    for kern, old, variants in (("sdg_fused", args.old_fused, args.variant),
                                ("rowgather_affine", args.old_affine,
                                 args.affine_variant)):
        if not old:
            continue
        builds[(kern, "old")] = (old_flags, old)
        for spec in variants:
            name, src = spec.split(":", 1)
            if name in ("old", "new", "new_per_row") or (kern, name) in builds:
                ap.error(f"variant {spec}: the name {name!r} is taken")
            builds[(kern, name)] = (kernels.flags(kern), src)
    libs = build_all(builds, out_dir)
    if libs is None:
        return 1
    kernels.build()
    if args.sass:
        for kern in {k for k, _ in builds}:
            libs[(kern, "new")] = kernels._target(kern)
        for (kern, n), lib in libs.items():
            print_sass(f"{kern}:{n}", lib)

    device = torch.device("cuda")
    images, _, _, Ps, paths = cs.scene_setup()
    job = prepare_job(images, Ps, paths["rect"], device=device)
    scene, jparams = job.prep, job.params
    _, abc_of = cs.bench_inputs(torch, scene, jparams, device)
    card = cs.card_line()
    if args.old_fused:
        fused_ab(args, libs, scene, jparams, abc_of, card)
    if args.old_affine:
        if not affine_ab(args, libs, scene, jparams, abc_of, card):
            return 1
    print(card, flush=True)
    return 0


def fused_ab(args, libs, scene, jparams, abc_of, card) -> None:
    """The fused window cost: old, new and variants in turns."""
    import torch
    import chip_smoke as cs
    from gipuma_tpu_torch.ops import sdg_fused as tsf
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {"new": tsf._cuda_fn()}
    for (kern, name), lib in libs.items():
        if kern != "sdg_fused" or name == "new":
            continue
        fn = ctypes.CDLL(str(lib)).gtt_sdg_fused_cost
        fn.argtypes = [vp] * 7 + [ci] * 13 + [cf] * 7 + [vp]
        fn.restype = ci
        fns[name] = fn
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


def affine_ab(args, libs, scene, jparams, abc_of, card) -> bool:
    """The affine row gather at chip_smoke.py's one-row launch and at the
    census and unfused paths' launches: the old design one launch per
    window row, the current one as one rows launch and per row, variants
    as rows launches; each bitwise against the plain rows."""
    import torch
    import chip_smoke as cs
    from gipuma_tpu_torch.ops import rowgather as trg
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sym = "gtt_row_gather_affine_rows"
    new_fn = trg._cuda_fn("rowgather_affine", sym, trg.AFFINE_ARGTYPES)
    old_fn = ctypes.CDLL(str(libs[("rowgather_affine", "old")])
                         ).gtt_row_gather_affine
    old_fn.argtypes = [vp] * 5 + [ci] * 7 + [cf, vp]
    old_fn.restype = ci
    var_fns = {}
    for (kern, name), lib in libs.items():
        if kern == "rowgather_affine" and name not in ("old", "new"):
            var_fns[name] = getattr(ctypes.CDLL(str(lib)), sym)
            var_fns[name].argtypes = new_fn.argtypes
            var_fns[name].restype = ci

    def old_rows(src, abc, dxs, dys, db):
        C, H, W = src.shape
        K, _, _, Ws = abc.shape
        out = torch.empty((len(dys), K * len(dxs), C, H, Ws),
                          dtype=torch.float32, device=abc.device)
        dx_arr = (ctypes.c_int * len(dxs))(*dxs)
        for r, dy in enumerate(dys):
            rc = old_fn(src.data_ptr(), abc.data_ptr(), db.data_ptr(),
                        out[r].data_ptr(), dx_arr, len(dxs), K, C, H, W, Ws,
                        int(dy), ctypes.c_float(float(dy)),
                        torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"old affine kernel: CUDA error {rc}")
        return out

    def rows_with(fn):
        def run(src, abc, dxs, dys, db):
            trg._FNS[sym] = fn
            try:
                return trg.row_gather_affine_rows_cuda(src, abc, dxs, dys, db)
            finally:
                trg._FNS[sym] = new_fn
        return run

    def new_per_row(src, abc, dxs, dys, db):
        # One launch per window row of the current source, each into its
        # row of the output (no copies).
        C, H, W = src.shape
        K, _, _, Ws = abc.shape
        out = torch.empty((len(dys), K * len(dxs), C, H, Ws),
                          dtype=torch.float32, device=abc.device)
        dx_arr = (ctypes.c_int * len(dxs))(*dxs)
        for r, dy in enumerate(dys):
            rc = new_fn(src.data_ptr(), abc.data_ptr(), db.data_ptr(),
                        out[r].data_ptr(), dx_arr, len(dxs),
                        (ctypes.c_float * 1)(float(dy)),
                        (ctypes.c_int * 1)(int(dy)), 1, K, C, H, W, Ws,
                        torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"affine kernel: CUDA error {rc}")
        return out

    designs = {"old": old_rows, "new": rows_with(new_fn),
               "new_per_row": new_per_row,
               **{n: rows_with(f) for n, f in var_fns.items()}}
    names = list(designs)
    v0 = 0
    src = scene.src_rect[v0]
    db = scene.disp_bounds[v0].contiguous()
    corner = -jparams.box_hrad
    box, cull = jparams.box_hsize // 2, jparams.cull_box // 2
    xs_box, xs_cull = tuple(range(-box, box + 1)), tuple(range(-cull,
                                                             cull + 1))
    a4, a1 = abc_of(4, "tri"), abc_of(1, "pair")
    shapes = [  # (label, abc, dxs, dys)
        ("one row K=4 x 11 columns (chip_smoke)", a4, xs_box, (corner,)),
        ("census sparse K=4 x 9 rows x 9 columns", a4, xs_cull, xs_cull),
        ("census full K=1 x 11 rows x 11 columns", a1, xs_box, xs_box),
        ("census centre K=4 x 1 x 1", a4, (0,), (0,)),
        ("unfused full K=1 x 6 rows x 6 columns", a1,
         tuple(range(-box, box + 1, 2)), tuple(range(-box, box + 1, 2))),
        ("unfused sparse K=4 x 3 rows x 3 columns", a4, (-cull, 0, cull),
         (-cull, 0, cull))]
    ok = True
    for label, abc, dxs, dys in shapes:
        K, _, H, Ws = abc.shape
        C, _, W = src.shape
        want = trg.row_gather_affine_rows_plain(src, abc, dxs, dys, db)
        equal = {}
        for n in names:
            got = designs[n](src, abc, dxs, dys, db)
            equal[n] = bool(torch.equal(torch.isnan(got), torch.isnan(want))
                            and torch.equal(got.nan_to_num(-1.0),
                                            want.nan_to_num(-1.0)))
            ok = ok and equal[n]
        del want, got
        times = {n: [] for n in names}
        for _ in range(args.rounds):
            for n in names + names[::-1]:
                times[n].append(cs.graph_ms(
                    lambda: designs[n](src, abc, dxs, dys, db), reps=4))
        nbytes = 4 * (3 * K * H * Ws + len(dys) * K * len(dxs) * C * H * Ws
                      + C * H * W)
        print(json.dumps({
            "ab": "row_gather_affine", "shape": label, "card": card,
            "bound_ms": nbytes / cs.HBM_BPS * 1e3, "bound_by": "bytes",
            "ms_median": {n: statistics.median(t) for n, t in times.items()},
            "ms_all": times, "bit_equal_to_plain": equal}), flush=True)
    return ok


if __name__ == "__main__":
    sys.exit(main())
