"""gipuma_tpu_torch's level_dispatch="scan" runner (run_iterations_scan),
on the CPU, where its schedule runs eagerly (on the card the level is one
CUDA graph; tests/test_torch_kernels_gpu.py holds that to the host loop):

* the port's counterparts of tests/test_patchmatch.py:122-175: the scan
  equals the host loop bit for bit on the exact and the rect path, and
  with refine=False (which differs from refine=True);
* propagation-only scan from one state carried across with
  convert.state_from_numpy equals the JAX package's run_iterations_scan:
  planes bit-equal on >= 99.5% of pixels, costs to 1e-4 abs there (the
  exact path's tolerance: the port sums the window offsets in another
  order);
* like the JAX runner, the scan does not read propagation_variant: with
  "monolithic" it runs close + far propagation, not the 20-offset sweep."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gipuma_tpu.config import AlgorithmParams as JParams
from gipuma_tpu.geometry.camera import FAKE_BASELINE
from gipuma_tpu.models import patchmatch as jpm
from gipuma_tpu.models import scene as jscene
from gipuma_tpu.ops.cost import multiview_cost as j_cost
from gipuma_tpu.utils.synthetic import plane_scene

from gipuma_tpu_torch import AlgorithmParams
from gipuma_tpu_torch.convert import (params_from_dict, scene_pack_from_numpy,
                                      state_from_numpy, to_numpy_tree)
from gipuma_tpu_torch.geometry import transforms as T
from gipuma_tpu_torch.geometry.camera import FAKE_BASELINE as T_BASELINE
from gipuma_tpu_torch.models import patchmatch as tpm
from gipuma_tpu_torch.models.rect_scene import build_rect_scene
from gipuma_tpu_torch.models.scene import build_scene
from gipuma_tpu_torch.ops import checkerboard as cb
from gipuma_tpu_torch.ops.cost import multiview_cost as t_cost
from gipuma_tpu_torch.ops.rect_cost import rect_multiview_cost

# The suite runs under pytest-xdist beside JAX's thread pools; at these
# sizes torch's intra-op threads only oversubscribe the cores.
torch.set_num_threads(1)
FRAC = 0.995
H, W = 32, 40


@pytest.fixture(scope="module")
def port_setup():
    """tests/test_patchmatch.py's make_setup(h=32, w=40) on the port."""
    images, rig, _, _ = plane_scene(num_cams=4, h=H, w=W, focal=60.0,
                                    plane_depth=5.0, slant=(0.2, -0.1))
    params = AlgorithmParams(box_hsize=7, box_vsize=7, iterations=2,
                             seed=0).with_depth_range(3.0, 8.0, rig.f,
                                                      T_BASELINE)
    scene = build_scene(images, rig, [1, 2, 3], params, 3.0, 8.0,
                        device="cpu")
    return dict(images=images, rig=rig, params=params, scene=scene)


def _run(scene, params, cost_fn, seed):
    with torch.no_grad():
        return tpm.run_patchmatch(scene, params,
                                  tpm.make_generator(seed, "cpu"), cost_fn)


def _equal(a, b):
    return (torch.equal(a.planes.view(torch.int32), b.planes.view(torch.int32))
            and torch.equal(a.cost.view(torch.int32), b.cost.view(torch.int32)))


def test_host_loop_honors_refine_flag(port_setup):
    scene, params = port_setup["scene"], port_setup["params"]
    params = params.replace(iterations=1)
    off = _run(scene, params.replace(refine=False), t_cost, 7)
    off_scan = _run(scene, params.replace(refine=False,
                                          level_dispatch="scan"), t_cost, 7)
    on = _run(scene, params, t_cost, 7)
    assert _equal(off, off_scan)
    assert not torch.equal(off.planes, on.planes)


def test_scan_runner_matches_host_loop(port_setup):
    scene, params = port_setup["scene"], port_setup["params"]
    want = _run(scene, params, t_cost, 5)
    got = _run(scene, params.replace(level_dispatch="scan"), t_cost, 5)
    assert _equal(got, want)


def test_scan_runner_matches_host_loop_rect(port_setup):
    params = port_setup["params"].replace(cost_path="rect", iterations=1)
    rscene, _ = build_rect_scene(port_setup["images"], port_setup["rig"],
                                 [1, 2, 3], params, 3.0, 8.0,
                                 base=port_setup["scene"], device="cpu")
    want = _run(rscene, params, rect_multiview_cost, 6)
    got = _run(rscene, params.replace(level_dispatch="scan"),
               rect_multiview_cost, 6)
    assert _equal(got, want)


def test_scan_ignores_propagation_variant(port_setup):
    """JAX's scan runner reads no propagation_variant: "monolithic" under
    the scan is the close + far schedule, and differs from the host loop's
    monolithic sweep."""
    scene, params = port_setup["scene"], port_setup["params"]
    params = params.replace(iterations=1)
    axial = _run(scene, params.replace(level_dispatch="scan"), t_cost, 4)
    mono_scan = _run(scene, params.replace(
        level_dispatch="scan", propagation_variant="monolithic"), t_cost, 4)
    mono_host = _run(scene, params.replace(
        propagation_variant="monolithic"), t_cost, 4)
    assert _equal(mono_scan, axial)
    assert not torch.equal(mono_scan.planes, mono_host.planes)


def test_propagation_scan_matches_jax():
    """Propagation-only scan (refine=False, one iteration: close and far
    propagation of both parities) from one random state on the exact
    path, against the JAX package's run_iterations_scan."""
    images, rig, _, _ = plane_scene(num_cams=4, h=H, w=W, focal=60.0,
                                    plane_depth=5.0, slant=(0.2, -0.1),
                                    texture="noise")
    jp = JParams(box_hsize=7, box_vsize=7, seed=0, iterations=1,
                 refine=False).with_depth_range(3.0, 8.0, rig.f,
                                                FAKE_BASELINE)
    js = jscene.build_scene(images, rig, [1, 2, 3], jp, 3.0, 8.0)
    tp = params_from_dict(dataclasses.asdict(jp)).replace(
        level_dispatch="scan")
    ts = scene_pack_from_numpy(to_numpy_tree(js), device="cpu")
    # A random state (planes facing the camera at depths in [3, 8]) with
    # its costs as the port evaluates them; the same state goes to both.
    rng = np.random.default_rng(31)
    n = T.flip_to_hemisphere(T.normalize(torch.from_numpy(
        rng.normal(size=(H, W, 3)).astype(np.float32)), eps=1e-20),
        ts.view_vec)
    depth = torch.from_numpy(rng.uniform(3.0, 8.0, size=(H, W))
                             .astype(np.float32))
    x, y = T.pixel_grid(H, W)
    d = T.plane_d_at_pixel(ts.M_inv, ts.P_col4, n, x, y, depth)
    cost = torch.zeros((H, W))
    for parity in (0, 1):
        cost = cb.interleave(cost, t_cost(ts, tp, parity, cb.extract(n, parity),
                                          cb.extract(d, parity)), parity)
    planes0 = torch.cat([n, d[..., None]], -1).numpy()
    cost0 = cost.numpy()
    jstate = jpm.PMState(planes=jnp.asarray(planes0),
                         cost=jnp.asarray(cost0), key=jax.random.PRNGKey(3))
    jnew = jax.jit(lambda s, sc: jpm.run_iterations_scan(
        s, sc, jp, cost_fn=j_cost))(jstate, js)
    with torch.no_grad():
        tnew = tpm.run_iterations_scan(
            state_from_numpy(planes0, cost0, device="cpu"), ts, tp, t_cost)
    jpl = np.asarray(jnew.planes)
    tpl = tnew.planes.numpy()
    changed = ~np.all(jpl == planes0, axis=-1)
    assert changed.mean() > 0.05, "the scan accepted too little"
    same = (jpl == tpl).all(-1)
    assert same.mean() >= FRAC, f"planes agree on {same.mean():.4f}"
    np.testing.assert_allclose(tnew.cost.numpy()[same],
                               np.asarray(jnew.cost)[same], rtol=0,
                               atol=1e-4)
