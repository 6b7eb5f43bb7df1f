"""Command-line front end — flag parity with the reference CLI
(main.cpp:164-428), plus preset selection and the fusion stage the
reference delegates to fusibile.

Counterpart of ``gipuma_tpu/cli.py:25-374``: the same flags, names and
defaults, plus ``--device`` (default ``cuda``; the JAX CLI picks its
platform from JAX_PLATFORMS).  Without a CUDA device the CLI raises
unless given ``--device cpu``.  ``--distributed`` runs one process per
rank (``python -m torch.distributed.run --nproc_per_node W -m
gipuma_tpu_torch.cli --distributed ...``): each process takes its block of
the reference views (parallel/distributed.py) into a shared output folder,
waits at a barrier for every process's views, fuses with the view axis
over all processes (fusion/sharded.py), and process 0 writes fused.ply.

Usage mirrors the reference:
    python -m gipuma_tpu_torch.cli img0.png img1.png ... -images_folder F \
        -krt_file par.txt -blocksize 11 --iterations 8 ...
Extras:
    --preset middlebury|dtu_fast|dtu_accurate|highres
    --all_views        run every image as the reference view (script loop)
    --fuse             run consistency fusion over the produced depth maps
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch.distributed as dist

from .config import AlgorithmParams, CostCombination, FusionParams, PRESETS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gipuma_tpu_torch",
        description="massively parallel multi-view stereo on a CUDA GPU "
                    "(the PyTorch port of gipuma_tpu)")
    p.add_argument("images", nargs="*", help="image filenames; first = reference")
    # Input paths (InputFiles fields, main.h:27-60)
    p.add_argument("-images_folder", default="")
    p.add_argument("-p_folder", default=None)
    p.add_argument("-krt_file", default=None)
    p.add_argument("-calib_file", default=None)
    p.add_argument("-pmvs_folder", default=None)
    p.add_argument("-camera_idx", type=int, default=None,
                   help="reference view index (pmvs mode, main.cpp:409-421)")
    p.add_argument("-output_folder", default="results")
    # Algorithm flags (main.cpp:164-428)
    p.add_argument("-a", dest="algorithm", choices=["pm", "ct"], default=None,
                   help="matching cost: pm (bilaterally weighted color+"
                        "gradient, default) or ct (census transform) — the "
                        "two algorithms that exist on the reference device "
                        "path (main.cpp:225-241; the other parsed names are "
                        "dead there, SURVEY.md §2)")
    p.add_argument("--census_epsilon", type=float, default=None)
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("-blocksize", type=int, default=None)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--tau_color", type=float, default=None)
    p.add_argument("--tau_gradient", type=float, default=None)
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--gamma", type=float, default=None)
    p.add_argument("--depth_min", type=float, default=None)
    p.add_argument("--depth_max", type=float, default=None)
    p.add_argument("--n_best", type=int, default=None)
    p.add_argument("--cost_comb", choices=["all", "best_n", "good"], default=None)
    p.add_argument("--good_factor", type=float, default=None)
    p.add_argument("-view_selection", action="store_true")
    p.add_argument("--no_view_selection", action="store_true")
    p.add_argument("--min_angle", type=float, default=None)
    p.add_argument("--max_angle", type=float, default=None)
    p.add_argument("--max_views", type=int, default=None)
    p.add_argument("--color_processing", action="store_true")
    p.add_argument("--cam_scale", type=float, default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="PRNG seed (the reference's unimplemented "
                        "--initial_seed, main.cpp:394; here it works)")
    p.add_argument("--pyramid_levels", type=int, default=None,
                   help="coarse-to-fine levels (1 = off)")
    p.add_argument("--pyramid_fine_iterations", type=int, default=None)
    p.add_argument("--cost_path", choices=["exact", "rect"], default=None,
                   help="cost evaluation path: exact reference formulas or "
                        "the rectified row-aligned TPU fast path")
    # Batch + fusion (scripts layer capability)
    p.add_argument("--all_views", action="store_true",
                   help="compute a depth map for every view (scripts loop)")
    p.add_argument("--fuse", action="store_true",
                   help="fuse the per-view depth maps (fusibile stage)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process scan: one process per rank "
                        "(torchrun's RANK / WORLD_SIZE / MASTER_ADDR / "
                        "MASTER_PORT), shared output folder, sharded "
                        "fusion")
    p.add_argument("--skip_existing", action="store_true",
                   help="resume: skip views whose disp.dmb already exists")
    p.add_argument("--disp_thresh", type=float, default=0.5)
    p.add_argument("--normal_thresh", type=float, default=30.0)
    p.add_argument("--num_consistent", type=int, default=3)
    # GT evaluation (main.cpp:378-385)
    p.add_argument("-gt", default=None,
                   help="ground-truth depth (dmb/pfm/png); in batch mode a "
                        "per-view template with {name}/{idx} placeholders, "
                        "e.g. 'gt/{name}.pfm' or 'depth_{idx:03d}.dmb'")
    p.add_argument("--gt_tol", type=float, default=1.0)
    p.add_argument("--gt_tol2", type=float, default=None,
                   help="second error tolerance (default 2*gt_tol)")
    p.add_argument("-gt_nocc", default=None,
                   help="non-occluded ground truth (dmb/pfm)")
    p.add_argument("-occl_mask", default=None,
                   help="occlusion mask image (png/pgm, nonzero = occluded)")
    p.add_argument("-gt_normal", default=None,
                   help="ground-truth normal map (3-channel dmb)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; raises when "
                        "CUDA is absent — pass --device cpu to run the "
                        "kernels' plain versions on the CPU)")
    p.add_argument("--gtDepth_divisionFactor", "--gt_div_factor",
                   dest="gt_div_factor", type=float, default=1.0,
                   help="GT image values are disparity*divFactor "
                        "(main.h:34-35, groundTruthUtils.h:38 — "
                        "Middlebury small images 4, big 3, KITTI 255); "
                        "values are divided by this at load.  Raw 0/-1 "
                        "(no-GT markers) stay invalid after division "
                        "(eval.metrics treats gt <= 0 as no data).")
    return p


def params_from_args(args) -> AlgorithmParams:
    params = PRESETS[args.preset] if args.preset else AlgorithmParams()
    over = {}
    if args.blocksize is not None:
        over["box_hsize"] = args.blocksize
        over["box_vsize"] = args.blocksize
    for name in ("iterations", "tau_color", "tau_gradient", "alpha", "gamma",
                 "depth_min", "depth_max", "n_best", "good_factor",
                 "min_angle", "max_angle", "max_views", "cam_scale", "seed",
                 "cost_path", "pyramid_levels", "pyramid_fine_iterations",
                 "census_epsilon"):
        v = getattr(args, name, None)
        if v is not None:
            over[name] = v
    if args.algorithm is not None:
        from .config import MatchingAlgorithm
        over["algorithm"] = {"pm": MatchingAlgorithm.PM,
                             "ct": MatchingAlgorithm.CENSUS}[args.algorithm]
    if args.cost_comb is not None:
        over["cost_comb"] = {"all": CostCombination.ALL,
                             "best_n": CostCombination.BEST_N,
                             "good": CostCombination.GOOD}[args.cost_comb]
    if args.no_view_selection:
        over["view_selection"] = False
    if args.color_processing:
        over["color_processing"] = True
    return params.replace(**over)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .io.images import list_images
    from .pipeline import resolve_device, run_batch

    if args.distributed:
        # One process per rank (torchrun, or a world the caller already
        # initialised); each takes its card, or the CPU when asked.
        from .parallel.distributed import init_distributed, rank_device
        pidx, pcount = init_distributed(device=args.device)
        device = rank_device(args.device)
        print(f"[gipuma_tpu_torch] distributed: process {pidx}/{pcount} "
              f"on {device}")
    else:
        device = resolve_device(args.device)

    folder = Path(args.images_folder) if args.images_folder else Path(".")
    names = args.images or list_images(folder)
    if not names:
        print("no input images", file=sys.stderr)
        return 2
    paths = [str(folder / n) for n in names]

    params = params_from_args(args)
    # Distributed processes must agree on the output directory (it is the
    # work-partition ledger): no per-process timestamp subdirectory.
    out_root = (Path(args.output_folder) if args.distributed
                else Path(args.output_folder) / time.strftime("%Y%m%d-%H%M%S"))

    if args.all_views:
        ref_indices = None
    elif args.camera_idx is not None:
        ref_indices = [args.camera_idx]
    else:
        ref_indices = [0]

    if args.distributed:
        from .parallel.distributed import run_batch_distributed
        results = run_batch_distributed(
            paths, params, out_root, p_folder=args.p_folder,
            krt_file=args.krt_file, calib_file=args.calib_file,
            pmvs_folder=args.pmvs_folder, ref_indices=ref_indices,
            color=args.color_processing, device=device)
    else:
        results = run_batch(paths, params, out_root,
                            p_folder=args.p_folder, krt_file=args.krt_file,
                            calib_file=args.calib_file,
                            pmvs_folder=args.pmvs_folder,
                            ref_indices=ref_indices,
                            color=args.color_processing,
                            skip_existing=args.skip_existing, device=device)
    for r in results:
        print(f"{r.ref_name}: {r.runtime_s:.2f}s, views={r.view_subset}, "
              f"depth=[{r.depth_min:.3f},{r.depth_max:.3f}]")

    if args.gt:
        # GT evaluation (computeError / computeNormalError capability,
        # groundTruthUtils.h:22-139, flags at main.cpp:378-385), for EVERY
        # produced view — the reference evaluates inside every script-loop
        # invocation (main.cpp:1087-1163).  -gt/-gt_nocc/-gt_normal accept
        # per-view templates with {name} (reference image stem) and {idx}
        # (camera index) placeholders; a plain path applies to all views.
        from .eval.metrics import depth_error, normal_error
        from .io.dmb import read_dmb
        from .io.images import decode_normal_map_16u, load_image, \
            load_image_raw
        from .io.pfm import read_pfm
        from .io.vis import save_png

        def _read_map(path):
            # dmb/pfm by extension; ANY other image via the raw decoder —
            # the reference's imread(-1) fallback (main.cpp:770-772).
            if path.endswith(".dmb"):
                raw = np.asarray(read_dmb(path))
            elif path.endswith(".pfm"):
                raw = np.asarray(read_pfm(path))
            else:
                raw = load_image_raw(path)
            # Middlebury/KITTI divFactor (groundTruthUtils.h:38): stored
            # value = disparity * divFactor.  0/-1 no-GT markers map to
            # <= 0 and stay invalid in eval.metrics.depth_error.
            df = float(getattr(args, "gt_div_factor", 1.0))
            return raw if df == 1.0 else raw.astype(np.float64) / df

        def _read_normal_map(path):
            if path.endswith(".dmb"):
                return np.asarray(read_dmb(path))
            # 16-bit image GT normals: n*32767+32767 (main.cpp:800-817).
            return decode_normal_map_16u(load_image_raw(path))

        def _resolve(template, stem, idx):
            try:
                return template.format(name=stem, idx=idx)
            except (KeyError, IndexError, ValueError):
                return template

        for r in results:
            stem = Path(r.ref_name).stem
            idx = names.index(r.ref_name) if r.ref_name in names else 0
            vdir = out_root / stem
            gt_path = _resolve(args.gt, stem, idx)
            if not Path(gt_path).exists():
                print(f"{stem}: GT file {gt_path} not found — skipping "
                      "eval", file=sys.stderr)
                continue
            # Occlusion masks are view-specific: resolve the same
            # {name}/{idx} template as -gt per view and skip (not reuse a
            # wrong view's mask) when the resolved file is missing.
            occl = None
            if args.occl_mask:
                occl_path = _resolve(args.occl_mask, stem, idx)
                if Path(occl_path).exists():
                    occl = load_image(occl_path) > 0
                else:
                    print(f"{stem}: occlusion mask {occl_path} not found — "
                          "nocc rates skipped for this view",
                          file=sys.stderr)
            rep = depth_error(r.depth, _read_map(gt_path),
                              tol=args.gt_tol, tol2=args.gt_tol2,
                              occlusion_mask=occl)
            print(f"{stem}: GT error rate @{args.gt_tol}: "
                  f"{rep.error_rate:.4f} "
                  f"@tol2 {rep.error_rate_tol2:.4f} "
                  f"nocc {rep.error_rate_nocc:.4f} "
                  f"(mean abs {rep.mean_abs_error:.4f})")
            # The reference's five error-map PNGs (main.cpp:1123-1139,
            # groundTruthUtils.h:22-95): two tolerances x overall/nocc +
            # the algorithm-valid-masked map, into the view's own results
            # directory; metrics appended to its results.txt.
            for fname, emap in (
                    ("gt_error.png", rep.error_map),
                    ("gt_error_tol2.png", rep.error_map_tol2),
                    ("gt_error_nocc.png", rep.error_map_nocc),
                    ("gt_error_nocc_tol2.png", rep.error_map_nocc_tol2),
                    ("gt_error_masked.png", rep.error_map_masked)):
                if emap is not None:
                    save_png(vdir / fname, (emap * 255).astype(np.uint8))
            gt_lines = [
                f"gt_file {gt_path}",
                f"error_rate_tol{args.gt_tol} {rep.error_rate:.6f}",
                f"error_rate_tol2 {rep.error_rate_tol2:.6f}",
                f"error_rate_nocc {rep.error_rate_nocc:.6f}",
                f"mean_abs_error {rep.mean_abs_error:.6f}",
            ]
            if args.gt_nocc:
                nocc_path = _resolve(args.gt_nocc, stem, idx)
                if Path(nocc_path).exists():
                    rep_n = depth_error(r.depth, _read_map(nocc_path),
                                        tol=args.gt_tol, tol2=args.gt_tol2)
                    print(f"{stem}: GT(nocc file) error rate "
                          f"@{args.gt_tol}: {rep_n.error_rate:.4f}")
                    # Distinct name: gt_error_nocc.png is the occl_mask-
                    # derived map of the PRIMARY GT above.
                    save_png(vdir / "gt_error_noccfile.png",
                             (rep_n.error_map * 255).astype(np.uint8))
                    gt_lines.append(
                        f"error_rate_nocc_file {rep_n.error_rate:.6f}")
            if args.gt_normal:
                nrm_path = _resolve(args.gt_normal, stem, idx)
                if Path(nrm_path).exists():
                    nrep = normal_error(r.normals,
                                        _read_normal_map(nrm_path))
                    print(f"{stem}: GT normal error: "
                          f">=0.2rad {nrep.error_rate_02:.4f} "
                          f">=0.3rad {nrep.error_rate_03:.4f} "
                          f"(mean {nrep.mean_angle_rad:.4f} rad)")
                    ang = np.nan_to_num(nrep.angle_map, nan=np.pi)
                    save_png(vdir / "gt_normal_error.png",
                             np.clip(ang / np.pi * 255, 0,
                                     255).astype(np.uint8))
                    gt_lines += [
                        f"normal_error_02 {nrep.error_rate_02:.6f}",
                        f"normal_error_03 {nrep.error_rate_03:.6f}",
                        f"normal_mean_rad {nrep.mean_angle_rad:.6f}"]
            try:
                with open(vdir / "results.txt", "a") as fh:
                    fh.write("\n".join(gt_lines) + "\n")
            except OSError as e:
                print(f"{stem}: could not append GT metrics to "
                      f"results.txt: {e}", file=sys.stderr)

    if args.fuse:
        from .fusion.fuse import fuse_depthmaps
        from .io.calib import load_projection_matrices
        from .io.ply import write_ply_points
        Ps = load_projection_matrices(
            names, p_folder=args.p_folder, krt_file=args.krt_file,
            calib_file=args.calib_file, pmvs_folder=args.pmvs_folder)
        fp = FusionParams(disp_thresh=args.disp_thresh,
                          normal_thresh=args.normal_thresh,
                          num_consistent=args.num_consistent)
        order = ref_indices if ref_indices is not None else list(range(len(names)))
        distributed = args.distributed and dist.is_initialized()
        if distributed:
            # Every process's views are on disk before any process reads
            # another's .dmb files.
            dist.barrier()
        if len(results) == len(order):
            depths = np.stack([r.depth for r in results])
            normals = np.stack([r.normals for r in results])
        else:
            # Distributed or resumed batch (--skip_existing): this process
            # holds only the views it ran — fuse from the per-view outputs
            # on disk
            # (the .dmb files are the interchange format, exactly how the
            # reference's scripts hand fusibile the results).
            from .io.dmb import read_dmb
            depths, normals = [], []
            for ref in order:
                vdir = out_root / Path(names[ref]).stem
                if not (vdir / "disp.dmb").exists():
                    print(f"fusion: missing {vdir}/disp.dmb — is the "
                          "batch complete?", file=sys.stderr)
                    return 3
                depths.append(read_dmb(vdir / "disp.dmb"))
                normals.append(read_dmb(vdir / "normals.dmb"))
            depths = np.stack(depths)
            normals = np.stack(normals)
        if distributed:
            # The consistency check's view axis over every process
            # (fusion/sharded.py); process 0 writes the cloud.
            from .fusion.sharded import fuse_depthmaps_sharded
            from .parallel.mesh import make_mesh
            world = dist.get_world_size()
            pts, nrm, col = fuse_depthmaps_sharded(
                depths, normals, [Ps[i] for i in order], fp,
                make_mesh(view_shards=world, max_view_shards=world),
                device=device)
            if dist.get_rank() != 0:
                return 0
        else:
            pts, nrm, col = fuse_depthmaps(
                depths, normals, [Ps[i] for i in order], fp, device=device)
        out = out_root / "fused.ply"
        n = write_ply_points(out, pts, nrm, col)
        print(f"fused cloud: {n} points -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
