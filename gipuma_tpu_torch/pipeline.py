"""End-to-end depth-map pipeline — the runGipuma analog (main.cpp:694-1199).

Counterpart of ``gipuma_tpu/pipeline.py:73-314``: select views, build the
scene (the rectified path, or the exact path — the default, and the
fallback where the rig cannot be rectified — or a coarse-to-fine pyramid
of either), run PatchMatch, finalize, write outputs (dmb/ply/png +
results.txt).  ``run_batch`` loops the reference views of a folder of
images in-process (the scripts' shell loop), preparing view i+1 on a
planner thread while view i runs.

Entry points run on the card: ``device=None`` means ``cuda``, and raises
when CUDA is absent.  Pass ``device="cpu"`` to run the plain versions of
the kernels on the CPU.  The one fallback is the JAX package's own, rect
to exact where the rig cannot be rectified, and it prints a line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from .config import AlgorithmParams
from .geometry.camera import FAKE_BASELINE, build_rig, camera_center_from_P
from .io import calib as calib_io
from .io import dmb as dmb_io
from .io import vis as vis_io
from .io.images import load_image
from .io.ply import write_ply
from .models.patchmatch import finalize, make_generator, run_patchmatch
from .models.scene import build_scene, ensure_even_width
from .ops.cost import multiview_cost
from .select import select_views


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another; no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gipuma_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but CUDA is not available")
    return device


@dataclasses.dataclass
class RunResult:
    depth: np.ndarray        # [H, W]
    normals: np.ndarray      # [H, W, 3] world frame
    cost: np.ndarray         # [H, W]
    view_subset: list[int]
    depth_min: float
    depth_max: float
    runtime_s: float
    ref_name: str = ""


@dataclasses.dataclass
class PreparedJob:
    """Host-side plan + device scenes for one reference view.  With the
    pyramid, `prep` holds the levels' futures (models/pyramid.py), whose
    builds run on background threads until run_prepared_job resolves
    them."""

    prep: object                 # pyramid futures, a RectScene or a ScenePack
    params: AlgorithmParams
    view_subset: list[int]
    depth_min: float
    depth_max: float
    ref_name: str
    orig_w: int
    w: int
    device: torch.device = None
    pyramid: bool = False


def prepare_job(images: Sequence[np.ndarray],
                P_matrices: Sequence[np.ndarray],
                params: AlgorithmParams,
                image_names: Sequence[str] | None = None,
                ref_index: int = 0, device=None,
                ledger=None) -> PreparedJob:
    """Plan one reference view's job and build its rect scene on `device`.

    images/P_matrices are for all cameras; `ref_index` selects the
    reference (swapped to the front internally, main.cpp:409-421).  When
    the rect path is asked for and the rig cannot be rectified, the job
    falls back to the exact path (with a printed line), as in the JAX
    package.  ledger: a rect_scene.ShapeBucketLedger shared across a scan
    (config.rect_quantize_shapes; run_batch threads one through)."""
    device = resolve_device(device)
    order = [ref_index] + [i for i in range(len(images)) if i != ref_index]
    images = [np.asarray(images[i], dtype=np.float32) for i in order]
    Ps = [np.asarray(P_matrices[i]) for i in order]
    names = ([image_names[i] for i in order]
             if image_names else [f"cam{i:03d}" for i in order])

    orig_w = images[0].shape[1]
    images = [ensure_even_width(im) for im in images]
    h, w = images[0].shape[:2]

    rig = build_rig(Ps, names, cam_scale=params.cam_scale)
    subset, depth_min, depth_max = select_views(rig, orig_w, h, params,
                                                seed=params.seed)
    if not subset:
        raise ValueError("view selection produced an empty subset — "
                         "relax min/max angle or disable view_selection")
    params = params.with_depth_range(depth_min, depth_max, rig.f,
                                     FAKE_BASELINE)

    job = dict(params=params, view_subset=subset, depth_min=depth_min,
               depth_max=depth_max, ref_name=names[0], orig_w=orig_w, w=w,
               device=device)
    if params.pyramid_levels > 1:
        from .models.pyramid import prepare_pyramid
        prep = prepare_pyramid(images, Ps, names, subset, params, depth_min,
                               depth_max, lazy=True, device=device,
                               ledger=ledger)
        return PreparedJob(prep=prep, pyramid=True, **job)

    with torch.no_grad():
        scene = None
        if params.cost_path == "rect":
            from .models.rect_scene import RectifyUnsupported, build_rect_scene
            # Lite base: the rect path reads only its geometry fields.
            base = build_scene(images, rig, subset, params, depth_min,
                               depth_max, lite=True, device=device)
            try:
                scene, _ = build_rect_scene(images, rig, subset, params,
                                            depth_min, depth_max, base=base,
                                            ledger=ledger, device=device)
            except RectifyUnsupported as e:
                print(f"[gipuma_tpu_torch] rect path unavailable ({e}); "
                      "falling back to the exact cost path")
                job["params"] = params = params.replace(cost_path="exact")
        if scene is None:
            scene = build_scene(images, rig, subset, params, depth_min,
                                depth_max, lite=False, device=device)
    return PreparedJob(prep=scene, **job)


def run_prepared_job(job: PreparedJob) -> RunResult:
    """Run PatchMatch + finalize for a prepared job; returns host arrays."""
    params = job.params
    gen = make_generator(params.seed, job.device)
    if job.pyramid:
        from .models.pyramid import run_pyramid
        t0 = time.perf_counter()
        depth, normals, cost = run_pyramid(job.prep, gen)
        runtime = time.perf_counter() - t0
    else:
        if params.cost_path == "rect":
            from .ops.rect_cost import rect_multiview_cost as cost_fn
        else:
            cost_fn = multiview_cost
        t0 = time.perf_counter()
        with torch.no_grad():
            state = run_patchmatch(job.prep, params, gen, cost_fn=cost_fn)
            depth, normals, cost = finalize(state, job.prep)
            depth = depth.cpu().numpy()
        runtime = time.perf_counter() - t0
        normals = normals.cpu().numpy()
        cost = cost.cpu().numpy()
    if job.w != job.orig_w:  # crop the even-width padding
        depth = depth[:, :job.orig_w]
        normals = normals[:, :job.orig_w]
        cost = cost[:, :job.orig_w]
    return RunResult(depth=depth, normals=normals, cost=cost,
                     view_subset=job.view_subset, depth_min=job.depth_min,
                     depth_max=job.depth_max, runtime_s=runtime,
                     ref_name=job.ref_name)


def compute_depthmap(images: Sequence[np.ndarray],
                     P_matrices: Sequence[np.ndarray],
                     params: AlgorithmParams,
                     image_names: Sequence[str] | None = None,
                     ref_index: int = 0, device=None) -> RunResult:
    """Compute the depth map for one reference view (prepare + run)."""
    return run_prepared_job(prepare_job(images, P_matrices, params,
                                        image_names, ref_index,
                                        device=device))


def write_outputs(result: RunResult, out_dir: str | os.PathLike,
                  params: AlgorithmParams,
                  ref_image: np.ndarray | None = None,
                  P_ref: np.ndarray | None = None) -> None:
    """disp.dmb + normals.dmb + PNGs + PLY + results.txt — the reference's
    output set (main.cpp:987-1031, fileIoUtils.h:183-245)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    dmb_io.write_dmb(out / "disp.dmb", result.depth)
    dmb_io.write_dmb(out / "normals.dmb", result.normals)

    vis_io.save_png(out / "disp.png",
                    vis_io.depth_to_jet(result.depth, result.depth_min,
                                        result.depth_max))
    vis_io.save_png(out / "normals.png", vis_io.normals_png(result.normals))
    vis_io.save_png(out / "cost.png", vis_io.cost_to_gray(result.cost, 100.0))

    if ref_image is not None and P_ref is not None:
        write_ply(out / f"3d_model_{result.ref_name}.ply", result.depth,
                  result.normals, ref_image, P_ref)

    n_px = result.depth.size
    lines = {
        "ref_name": result.ref_name,
        "runtime_s": round(result.runtime_s, 4),
        "runtime_us_per_pixel": round(result.runtime_s * 1e6 / n_px, 4),
        "selected_views": result.view_subset,
        "depth_min": result.depth_min,
        "depth_max": result.depth_max,
        "params": {k: (v.name if hasattr(v, "name") else v)
                   for k, v in dataclasses.asdict(params).items()},
    }
    with open(out / "results.txt", "a") as f:
        f.write(json.dumps(lines, indent=2) + "\n")


def run_batch(image_paths: Sequence[str], params: AlgorithmParams,
              results_root: str | os.PathLike,
              p_folder: str | None = None, krt_file: str | None = None,
              calib_file: str | None = None, pmvs_folder: str | None = None,
              ref_indices: Sequence[int] | None = None,
              color: bool = False, skip_existing: bool = False,
              device=None) -> list[RunResult]:
    """Loop reference views in-process (replaces scripts/*.sh shell loops),
    on `device` (None: the card).

    Loads the calibration and the images, takes the depth range from the
    bundler points when depth_min == -1 and a pmvs folder is given, and
    writes each view's outputs under results_root/<image stem>.
    skip_existing: resume a partially-finished batch — views whose output
    directory already holds a disp.dmb are skipped.  One planner thread
    prepares view i+1 (its scene built on the device) while view i runs:
    both threads use the device's default stream, so the work is ordered,
    and a job's scene is read only after its prepare_job has returned;
    the device holds up to two views' scenes at once."""
    from concurrent.futures import ThreadPoolExecutor

    device = resolve_device(device)
    names = [Path(p).name for p in image_paths]
    Ps = calib_io.load_projection_matrices(
        names, p_folder=p_folder, krt_file=krt_file,
        calib_file=calib_file, pmvs_folder=pmvs_folder)
    images = [load_image(p, color=color) for p in image_paths]
    if ref_indices is None:
        ref_indices = range(len(images))

    if pmvs_folder and params.depth_min == -1:
        # Bundler point cloud drives the depth range (main.cpp:873-876).
        bundle = Path(pmvs_folder) / "bundle.rd.out"
        if bundle.exists():
            dmin, dmax = calib_io.bundler_depth_range(
                bundle, camera_center_from_P(np.asarray(Ps[0])))
            params = params.replace(depth_min=dmin, depth_max=dmax)

    root = Path(results_root)
    todo = [ref for ref in ref_indices
            if not (skip_existing
                    and (root / Path(names[ref]).stem / "disp.dmb").exists())]
    # One ledger across all reference views of the scan
    # (config.rect_quantize_shapes).
    ledger = None
    if params.cost_path == "rect" and params.rect_quantize_shapes:
        from .models.rect_scene import ShapeBucketLedger
        ledger = ShapeBucketLedger()

    def prepare(ref):
        return prepare_job(images, Ps, params, names, ref_index=ref,
                           device=device, ledger=ledger)

    results = []
    with ThreadPoolExecutor(max_workers=1) as planner:
        nxt = planner.submit(prepare, todo[0]) if todo else None
        for i, ref in enumerate(todo):
            job = nxt.result()
            if i + 1 < len(todo):
                nxt = planner.submit(prepare, todo[i + 1])
            res = run_prepared_job(job)
            P_ref = build_rig([Ps[ref]] + [Ps[k] for k in range(len(Ps))
                                           if k != ref],
                              rebase=True).cameras[0].P
            write_outputs(res, root / Path(names[ref]).stem, params,
                          ref_image=images[ref], P_ref=P_ref)
            results.append(res)
    return results
