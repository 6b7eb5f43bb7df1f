"""The comparison that decides ``correct`` for a scan of a folder.

It reads what the scan wrote (every view's ``results.txt``, ``disp.dmb``
and ``normals.dmb``, and ``fused.ply``) and judges it against the plain
references (``reference.select_views``, ``reference_fusion.fuse``) and the
analytic ground truth (``scene.ground_truth``, the objects' surfaces):

* ``views_wrong``: views whose source-view subset or depth range in
  results.txt differs from the reference's view selection (exact; limit 0).
* ``depth_err``: over every view of the scan, the worst view's median
  relative depth error against the ground truth (as ``check.rel_errors``
  takes it), so that one rank's block of views gone wrong shows.
* ``fusion_gap``: fused.ply against the reference fusion of the same
  disp.dmb and normals.dmb files: the larger of the relative gap in point
  count and the ``cloud_quantile`` quantile of the distance from a point of
  one cloud to the nearest of the other (``cloud_points`` points drawn from
  the seed, each way), over the rig's distance.
* ``cloud_err``: the median distance of the fused points to the nearest of
  the scene's analytic surfaces, over the rig's distance (DTU's accuracy).

The control (``control_numbers``) puts the references in the program's
place a precision step below its float32: ground-truth depths and normals
rounded to bfloat16, fused by the reference fusion computed in bfloat16.
Nothing here imports the program.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from . import folder_io, reference as ref_mod, reference_fusion
from .check import ViewOutput, rel_errors
from .scene import Scene, camera_layout, ground_truth

CONTROL_DTYPE = torch.bfloat16


def bare_scene(cfg: dict) -> Scene:
    """The configuration's rig and geometry without images (the check reads
    only cameras and ground truth)."""
    rig = cfg["rig"]
    return Scene(cameras=camera_layout(rig), images=[], height=rig["height"],
                 width=rig["width"], config=cfg)


def view_names(n: int) -> list[str]:
    return [f"view{i:03d}" for i in range(n)]


def read_scan(out_root: Path, n_views: int):
    """(outputs of the views whose files are all there, in folder order;
    folder indices of the views that are missing a file; the fused points
    or None), from the output folder that the command line with
    --distributed writes into."""
    outs, missing = [], []
    for i, name in enumerate(view_names(n_views)):
        vdir = Path(out_root) / name
        try:
            rec = folder_io.read_results(vdir / "results.txt")
            depth = folder_io.read_dmb(vdir / "disp.dmb")
            normals = folder_io.read_dmb(vdir / "normals.dmb")
        except (OSError, ValueError):
            missing.append(i)
            continue
        outs.append(ViewOutput(i, list(rec["selected_views"]),
                               float(rec["depth_min"]),
                               float(rec["depth_max"]), depth, normals, None))
    ply = Path(out_root) / "fused.ply"
    try:
        cloud = folder_io.read_ply_points(ply)
    except (OSError, ValueError):
        cloud = None
    return outs, missing, cloud


def nearest_distances(query: torch.Tensor, cloud: torch.Tensor,
                      chunk: int = 1 << 15) -> torch.Tensor:
    """Distance from each query point [q, 3] to the nearest point of cloud
    [m, 3]: |a|^2 + |b|^2 - 2 a.b in float64, a block of the cloud at a
    time."""
    q = query.to(torch.float64)
    qq = (q * q).sum(-1)
    best = torch.full((q.shape[0],), math.inf, dtype=torch.float64,
                      device=q.device)
    for s in range(0, cloud.shape[0], chunk):
        c = cloud[s:s + chunk].to(torch.float64)
        d2 = qq[:, None] + (c * c).sum(-1)[None, :] - 2.0 * (q @ c.T)
        best = torch.minimum(best, d2.min(dim=1).values)
    return best.clamp(min=0.0).sqrt()


def cloud_gap(got: torch.Tensor, want: torch.Tensor, chk: dict,
              rng: np.random.Generator, distance: float) -> float:
    """max(|count gap| / reference count, quantile of the nearest-point
    distance both ways / rig distance)."""
    if got.shape[0] == 0 or want.shape[0] == 0:
        return math.inf
    count = abs(got.shape[0] - want.shape[0]) / want.shape[0]
    dists = []
    for a, b in ((got, want), (want, got)):
        k = min(chk["cloud_points"], a.shape[0])
        pick = torch.as_tensor(rng.choice(a.shape[0], size=k, replace=False),
                               device=a.device)
        dists.append(nearest_distances(a[pick], b))
    q = torch.quantile(torch.cat(dists).double(), chk["cloud_quantile"])
    return max(count, float(q) / distance)


def surface_distance(points: torch.Tensor, scene_cfg: dict) -> torch.Tensor:
    """Distance of world points [n, 3] to the nearest analytic surface of the
    scene (spheres and planes)."""
    X = points.to(torch.float64)
    best = torch.full((X.shape[0],), math.inf, dtype=torch.float64,
                      device=X.device)
    for obj in scene_cfg["objects"]:
        if obj["type"] == "ellipsoid":
            r = obj["radii"]
            if max(r) != min(r):
                raise ValueError("surface distance needs a sphere, not an "
                                 f"ellipsoid of radii {r}")
            c = torch.as_tensor(obj["center"], dtype=torch.float64,
                                device=X.device)
            d = ((X - c).norm(dim=-1) - r[0]).abs()
        elif obj["type"] == "plane":
            n = torch.as_tensor(obj["normal"], dtype=torch.float64,
                                device=X.device)
            d = ((X @ (n / n.norm())) - obj["offset"]).abs()
        else:
            raise ValueError(f"unknown object type {obj['type']!r}")
        best = torch.minimum(best, d)
    return best


def judge(scene: Scene, outs: list, missing: list, cloud, cfg: dict,
          seed: int, device, errs=None) -> dict:
    """The numbers compared, for one scan: `outs` the views read back (in
    folder order), `missing` the views that are not, `cloud` the fused
    points [M, 3] (None: no fused.ply), `errs` each view's relative depth
    errors (``check.rel_errors``; taken here if None)."""
    chk, p = cfg["check"], cfg["method"]
    dist = float(cfg["rig"]["distance"])
    rng = np.random.default_rng([seed, 2])
    wrong = 0
    for o in outs:
        want = ref_mod.select_views(scene.cameras, o.ref, scene.width,
                                    scene.height, p)
        got = (list(o.subset), float(o.depth_min), float(o.depth_max))
        wrong += int(got != (list(want[0]), want[1], want[2]))
    if errs is None:
        errs = [rel_errors(scene, o, device, chk["trim"]) for o in outs]
    medians = [float(e.median()) if e.numel() else math.inf for e in errs]
    nums = {"views_wrong": wrong,
            "depth_err": max(medians) if medians else math.inf,
            "fusion_gap": math.inf, "cloud_err": math.inf}
    if cloud is None or missing or not outs:
        return nums
    got = torch.as_tensor(np.asarray(cloud), device=device)
    want, _ = reference_fusion.fuse(
        np.stack([o.depth for o in outs]), np.stack([o.normals for o in outs]),
        scene.Ps, cfg["fusion"], float(cfg["rig"]["K"][0][0]),
        device=device)
    nums["fusion_gap"] = cloud_gap(got, want, chk, rng, dist)
    if got.shape[0]:
        nums["cloud_err"] = float(surface_distance(got, cfg["scene"])
                                  .median()) / dist
    return nums


def control_numbers(cfg: dict, seed: int, device) -> dict:
    """The control's numbers: ground truth rounded to ``CONTROL_DTYPE`` in
    the program's place, fused by the reference fusion computed in it,
    judged as a scan is."""
    low = CONTROL_DTYPE
    scene = bare_scene(cfg)
    outs = []
    for r in range(len(scene.cameras)):
        gt, gtn = ground_truth(scene, r, device)
        hit = torch.isfinite(gt)
        d = torch.where(hit, ref_mod.round_to(torch.where(hit, gt, 0.0), low),
                        0.0)
        subset, dmin, dmax = ref_mod.select_views(
            scene.cameras, r, scene.width, scene.height, cfg["method"])
        outs.append(ViewOutput(r, subset, dmin, dmax,
                               d.to(torch.float32).cpu().numpy(),
                               ref_mod.round_to(gtn, low).to(torch.float32)
                               .cpu().numpy(), None))
    cloud, _ = reference_fusion.fuse(
        np.stack([o.depth for o in outs]), np.stack([o.normals for o in outs]),
        scene.Ps, cfg["fusion"], float(cfg["rig"]["K"][0][0]), dtype=low,
        device=device)
    return judge(scene, outs, [], cloud.to(torch.float64).cpu().numpy(), cfg,
                 seed, device)
