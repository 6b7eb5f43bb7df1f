"""The yardstick's arithmetic: the scene generator's ground truth against a
brute-force ray march, and the kernels' bounds against the ones PERF.md's
kernel table states for the bench scene's view-0 shapes."""
import math

import numpy as np
import pytest
import torch

from conftest import tiny_cell
from portbench import bounds, peaks, scene as sc, trace

H100 = peaks.PEAKS["NVIDIA H100 80GB HBM3"]


@pytest.mark.parametrize("workload", ["dino.exact", "dtu_fast.exact"])
def test_ground_truth_matches_a_brute_force_ray_march(workload):
    """March each ray of a small view in fine steps until it first enters a
    surface (inside the ellipsoid, or behind the plane); the analytic
    z-depth agrees to within one step, and so does the hit mask."""
    cfg = tiny_cell(workload, scale=40).config
    cam = sc.camera_layout(cfg["rig"])[3]
    h, w = cfg["rig"]["height"], cfg["rig"]["width"]
    depth, normal, _ = sc.ray_cast(cam, h, w, cfg["scene"], "cpu")
    Kinv = torch.as_tensor(np.linalg.inv(cam.K))
    Rt = torch.as_tensor(cam.R.T.copy())
    C = torch.as_tensor(cam.C)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64), indexing="ij")
    d = torch.stack([xs, ys, torch.ones_like(xs)], -1) @ (Rt @ Kinv).T
    dmin, dmax = cfg["method"]["depth_min"], cfg["method"]["depth_max"]
    step = (dmax - dmin) / 4000.0
    found = torch.full((h, w), math.inf, dtype=torch.float64)
    for t in np.arange(0.5 * dmin, 1.5 * dmax, step):
        X = C + t * d
        inside = torch.zeros((h, w), dtype=torch.bool)
        for obj in cfg["scene"]["objects"]:
            if obj["type"] == "ellipsoid":
                q = (X - torch.as_tensor(obj["center"])) / torch.as_tensor(obj["radii"])
                inside |= (q * q).sum(-1) <= 1.0
            else:
                n = torch.as_tensor(obj["normal"], dtype=torch.float64)
                inside |= (X * n).sum(-1) / n.norm() <= obj["offset"]
        found = torch.where(inside & torch.isinf(found), torch.full_like(found, t), found)
    assert torch.equal(torch.isfinite(found), torch.isfinite(depth))
    hit = torch.isfinite(depth)
    assert hit.any()
    err = (found[hit] - depth[hit]).abs()
    assert float(err.max()) <= step * 1.001
    assert torch.allclose(normal[hit].norm(dim=-1), torch.ones(1, dtype=torch.float64))


def test_same_seed_same_images_other_seed_other_texture():
    cfg = tiny_cell("dino.exact").config
    a = sc.make_scene(cfg, 2 ** 31 + 11, "cpu")
    b = sc.make_scene(cfg, 2 ** 31 + 11, "cpu")
    c = sc.make_scene(cfg, 12, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a.images, b.images))
    assert not np.array_equal(a.images[0], c.images[0])
    assert a.images[0].max() <= 255 and a.images[0].min() >= 0
    assert np.array_equal(a.images[0], np.round(a.images[0]))


def test_sampler_bound_matches_the_kernel_table():
    """PERF.md: the sampler at the exact path's largest launch on the bench
    scene (source [3, 480, 640], K=4 x 36 offsets x 480 x 320) 0.133 ms."""
    n = 4 * 36 * 480 * 320
    ms = bounds.sampler_bytes(n, 3, 480, 640) / H100["hbm_bytes_per_s"] * 1e3
    assert round(ms, 3) == 0.133


def test_idle_time_goes_to_what_the_host_was_doing():
    class T:
        events = (["k1", "k2"], np.array([0, 1, 0]), np.array([100, 300, 600]),
                  np.array([100, 100, 100]))
    phases = [(0, 250, "prepare_job"), (250, 900, "run_prepared_job")]
    red = trace.reduce(T, 0, 1000, phases)
    assert red["busy_s"] == 300 / 1e9
    assert red["window_s"] == 1000 / 1e9
    assert red["device_ops"][0] == ["k1", 200 / 1e9]
    # Gaps [0, 100) [200, 300) [400, 600) [700, 1000): the second is cut at
    # the phases' border, the last runs past the phases into the harness.
    assert dict(red["idle_gaps"]) == {
        "prepare_job before k1": 100 / 1e9,
        "prepare_job before k2": 50 / 1e9,
        "run_prepared_job before k2": 50 / 1e9,
        "run_prepared_job before k1": 200 / 1e9,
        "run_prepared_job before the window's end": 200 / 1e9,
        "harness before the window's end": 100 / 1e9}
    assert sum(t for _, t in red["idle_gaps"]) == (1000 - 300) / 1e9
    busy = trace.busy_union(np.array([0, 50, 300]), np.array([100, 100, 10]), 0, 1000)
    assert busy == [[0, 150], [300, 310]]


def test_host_readings_leave_the_traced_views_out():
    from portbench import core
    V = core.ViewRecord
    ctx = core.Ctx("cpu")
    ctx.views = [V(0, 0.0, 0.1, 1.0, None), V(1, 1.0, 1.2, 2.0, None),
                 V(2, 2.0, 2.1, 3.5, None, True), V(3, 3.5, 3.6, 5.0, None, True),
                 V(4, 5.5, 5.6, 6.7, None)]
    assert core.trace_overhead(ctx) == {}
    ctx.trace_start, ctx.trace_stop = 2.0, 5.4
    assert core.before_trace(ctx) == ctx.views[:2]
    assert core.per_view_s(core.before_trace(ctx)) == 1.0
    over = core.trace_overhead(ctx)
    assert abs(over["traced"] - 0.5) < 1e-12 and abs(over["after"] - 0.2) < 1e-12


@pytest.mark.parametrize("workload,selected", [("dino.exact", 4),
                                               ("dtu_fast.exact", 9)])
def test_every_reference_selects_the_same_number_of_views(workload, selected):
    """Every reference view of the rig selects as many source views (so
    every seed's window does the same work), and no view's angle lies
    within 0.1 degree of the preset's window, where rounding could flip
    the selection."""
    from portbench import core, reference
    cfg = core.load_cell(workload).config
    cams = sc.camera_layout(cfg["rig"])
    w, h, p = cfg["rig"]["width"], cfg["rig"]["height"], cfg["method"]
    for r in range(len(cams)):
        subset, lo, hi = reference.select_views(cams, r, w, h, p)
        assert len(subset) == selected
        assert (lo, hi) == (p["depth_min"], p["depth_max"])
        ang = reference.selection_angles(cams, r, w, h)
        assert min(min(abs(a - p["min_angle"]), abs(a - p["max_angle"]))
                   for a in ang) > 0.1
