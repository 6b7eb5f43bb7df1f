"""gipuma_tpu_torch.parallel.tiled and tiled_rect: row bands over ranks of
a 4-rank gloo world (spawned once for the file, CPU).

Exact path, on the scene of tests/test_tiled.py (3 cameras at 24x32, box
5, one iteration):

* propagation only, 2 and 4 bands, from the JAX package's whole-image
  init (recomputed from its key as gipuma_tpu/parallel/tiled.py:161-168
  does, carried in as numpy): equal to the port's single-band sweeps from
  that init within 1e-6 (tests/test_tiled.py's tolerance; bit-equal in
  fact), and to the JAX package's run_patchmatch (which its
  tests/test_tiled.py holds to its tile-sharded runner at 1e-6): planes
  bit-equal, cost within 1e-5 (the exact cost sums its window in another
  order, 1.2e-5 abs at costs up to 8.7).  JAX's tile-sharded runner
  itself compiles for minutes a call on a CPU, so it is not called here;
* with refinement, 2 bands: median relative depth error < 0.05.

Rect path, tile x view (tests/test_tiled_rect.py's scene, 4 cameras):

* prepare_tiled_rect's margin, h_pad and every band's tables (forward and
  return permutations, rotations) equal to the JAX package's bit for bit;
* 2 tiles x 2 views at 48x128, 3 iterations: median and band-seam median
  relative depth errors < 0.01, unit normals;
* an uneven height (46x64 on 2 tiles x 2 views) is padded and cropped
  back: finite depth, median error < 0.01."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gipuma_tpu.config import AlgorithmParams as JParams
from gipuma_tpu.geometry import transforms as JT
from gipuma_tpu.geometry.camera import FAKE_BASELINE
from gipuma_tpu.models import patchmatch as jpm
from gipuma_tpu.models import scene as jscene
from gipuma_tpu.parallel import tiled_rect as jtr
from gipuma_tpu.utils.synthetic import plane_scene

from gipuma_tpu_torch.convert import params_from_dict, to_numpy_tree
from gipuma_tpu_torch.models import patchmatch as tpm
from gipuma_tpu_torch.ops.cost import multiview_cost
from gipuma_tpu_torch.parallel import launch
from gipuma_tpu_torch.parallel import tiled_rect as ttr

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)
TILES = (2, 4)


def test_port_imports_no_jax():
    """The tiled modules import neither JAX nor the JAX package (fresh
    interpreter)."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import gipuma_tpu_torch.parallel.tiled, "
         "gipuma_tpu_torch.parallel.tiled_rect, gipuma_tpu_torch as g; "
         "print(g.foreign_modules())"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def _rect_scene(h=48, w=128, iterations=3):
    images, rig, gt, _ = plane_scene(num_cams=4, h=h, w=w, focal=100.0,
                                     plane_depth=5.0, slant=(0.15, -0.1))
    jp = JParams(box_hsize=7, box_vsize=7, iterations=iterations, seed=0,
                 cost_path="rect").with_depth_range(3.0, 8.0, rig.f,
                                                    FAKE_BASELINE)
    return images, rig, gt, jp


@pytest.fixture(scope="module")
def setup():
    images, rig, gt, _ = plane_scene(num_cams=3, h=24, w=32, focal=60.0)
    jp = JParams(box_hsize=5, box_vsize=5, iterations=1,
                 refine=False).with_depth_range(3.0, 8.0, rig.f,
                                                FAKE_BASELINE)
    js = jscene.build_scene(images, rig, [1, 2], jp, 3.0, 8.0)
    # The JAX package's whole-image init (parallel/tiled.py:161-168).
    key = jax.random.PRNGKey(0)
    h, w = js.rays.shape[:2]
    x, y = JT.pixel_grid(h, w)
    k_disp, k_norm, _ = jax.random.split(key, 3)
    disp = jax.random.uniform(k_disp, (h, w), minval=jp.min_disparity,
                              maxval=jp.max_disparity)
    depth = JT.disparity_depth(js.f, js.baseline, disp)
    nrm = jpm.random_unit_hemisphere(k_norm, js.view_vec)
    d = JT.plane_d_at_pixel(js.M_inv, js.P_col4, nrm, x, y, depth)
    planes0 = np.asarray(jnp.concatenate([nrm, d[..., None]], axis=-1))
    tp = params_from_dict(dataclasses.asdict(jp))
    tree = dict(tree=to_numpy_tree(js), rect=False)

    r_images, r_rig, r_gt, r_jp = _rect_scene()
    u_images, u_rig, u_gt, u_jp = _rect_scene(h=46, w=64)
    rect = dict(views=[1, 2, 3], depth=(3.0, 8.0), n_tiles=2)
    tasks = [dict(kind="tile", scene=tree, params=tp,
                  mesh=dict(tile_shards=n), planes0=planes0) for n in TILES]
    tasks += [
        dict(kind="tile", scene=tree, params=tp.replace(refine=True),
             mesh=dict(tile_shards=2)),
        dict(kind="tiled_rect", images=r_images, rig=r_rig,
             params=params_from_dict(dataclasses.asdict(r_jp)),
             mesh=dict(tile_shards=2, view_shards=2), **rect),
        dict(kind="tiled_rect", images=u_images, rig=u_rig,
             params=params_from_dict(dataclasses.asdict(u_jp)),
             mesh=dict(tile_shards=2, view_shards=2), **rect),
    ]
    recs = launch.spawn(launch.run_tasks, 4, args=(tasks,), device="cpu",
                        timeout=600)
    return dict(recs=recs, js=js, jp=jp, tp=tp, tree=tree, planes0=planes0,
                gt=gt, r=(r_images, r_rig, r_gt, r_jp), u_gt=u_gt)


def _port_single(setup):
    """The port's single-band propagation from the same init planes."""
    scene = launch.build(setup["tree"], "cpu")[0]
    params = setup["tp"]
    planes = torch.tensor(setup["planes0"])
    with torch.no_grad():
        st = tpm.PMState(planes=planes, cost=tpm.initial_cost(
            scene, params, planes, multiview_cost))
        for _ in range(params.iterations):
            st = tpm.iteration(st, scene, params, multiview_cost)
    return st


@pytest.mark.parametrize("n", TILES)
def test_tiled_propagation_matches_single(setup, n):
    ref = _port_single(setup)
    for rec in setup["recs"]:
        got = rec[TILES.index(n)]["result"]
        np.testing.assert_allclose(got["cost"], ref.cost.numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["planes"], ref.planes.numpy(),
                                   rtol=1e-6, atol=1e-6)
    # Each band exchanged its halos: 2 parities x (close, far) + gathers.
    assert setup["recs"][0][TILES.index(n)]["collectives"]["calls"] >= 6


def test_tiled_propagation_matches_jax(setup):
    out = jpm.run_patchmatch(setup["js"], setup["jp"], jax.random.PRNGKey(0))
    jc, jpl = np.asarray(out.cost), np.asarray(out.planes)
    for n in TILES:
        got = setup["recs"][0][TILES.index(n)]["result"]
        np.testing.assert_array_equal(got["planes"], jpl)
        np.testing.assert_allclose(got["cost"], jc, rtol=1e-5, atol=1e-5)


def test_tiled_with_refinement_converges(setup):
    got = setup["recs"][0][len(TILES)]["result"]
    depth, gt = got["depth"], setup["gt"]
    assert np.isfinite(depth).all()
    s = np.s_[6:-6, 6:-6]
    assert np.median(np.abs(depth[s] - gt[s]) / gt[s]) < 0.05


def test_prepare_tiled_rect_matches_jax(setup):
    images, rig, _, jp = setup["r"]
    want = jtr.prepare_tiled_rect(images, rig, [1, 2, 3], jp, 3.0, 8.0,
                                  n_tiles=2)
    got = ttr.prepare_tiled_rect(images, rig, [1, 2, 3],
                                 params_from_dict(dataclasses.asdict(jp)),
                                 3.0, 8.0, n_tiles=2, device="cpu")
    assert (got.margin, got.h, got.h_pad, got.w) == (
        want.margin, want.h, want.h_pad, want.w)
    assert got.margin == ttr.required_band_margin(got.params)
    assert int(got.full_base.global_h) == int(want.full_base.global_h)
    for t in range(2):
        for f in ("fwd_c1", "fwd_r", "ret_c1", "ret_r", "rot_k"):
            np.testing.assert_array_equal(
                getattr(got.scenes[t], f).numpy(),
                np.asarray(getattr(want.scenes, f)[t]), err_msg=f)
        assert got.scenes[t].spans.shape == want.scenes.spans.shape[1:]
        assert int(got.scenes[t].row_offset) == int(
            want.scenes.base.row_offset[t])


def test_tiled_rect_depth_quality_and_seam(setup):
    gt = setup["r"][2]
    for rec in setup["recs"]:
        got = rec[len(TILES) + 1]["result"]
        assert got["planes"].shape == (48, 128, 4)
        d = got["depth"]
        s = np.s_[8:-8, 8:-8]
        ok = d[s] > 0
        assert ok.mean() > 0.9
        assert np.median(np.abs(d[s][ok] - gt[s][ok]) / gt[s][ok]) < 0.01
        # The band seam (the stitch at H/2) stays in the same class.
        b = np.s_[20:28, 8:-8]
        okb = d[b] > 0
        assert np.median(np.abs(d[b][okb] - gt[b][okb]) / gt[b][okb]) < 0.01
        assert np.allclose(np.linalg.norm(got["normals"], axis=-1), 1.0,
                           atol=1e-3)


def test_tiled_rect_uneven_height_pads(setup):
    gt = setup["u_gt"]
    got = setup["recs"][0][len(TILES) + 2]["result"]
    assert got["h_pad"] % 2 == 0 and got["h_pad"] > 46
    assert got["planes"].shape == (46, 64, 4)
    d = got["depth"]
    assert np.isfinite(d).all()
    s = np.s_[8:-8, 8:-8]
    ok = d[s] > 0
    assert ok.mean() > 0.9
    assert np.median(np.abs(d[s][ok] - gt[s][ok]) / gt[s][ok]) < 0.01
