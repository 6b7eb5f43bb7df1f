"""gipuma_tpu_torch pyramid, warm start and the pipeline's new routes.

Against the JAX package:
* downscale2 / upsample2_to bit-equal, and the device-side upsample equal
  to upsample2_to;
* _warm_start_impl on the exact scene (32x40, box 7), with the cost
  evaluated (1e-4 abs where planes agree to rtol 1e-5) and with a carried
  cost (the 1.05 inflation, MAXCOST at invalid depths).

In the port alone, on the CPU, each at the quality gate (median relative
depth error < 5e-3):
* a 2-level rect pyramid with the bench's fine-level trims (48x64);
* compute_depthmap with the default cost path (exact);
* a rig that cannot be rectified falls back to the exact path.
And prepare_job builds the scenes of the settings slice 2 made
runnable."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gipuma_tpu.config import AlgorithmParams as JParams
from gipuma_tpu.geometry.camera import FAKE_BASELINE
from gipuma_tpu.models import pyramid as jpyr
from gipuma_tpu.models import scene as jscene
from gipuma_tpu.ops.cost import multiview_cost as j_cost
from gipuma_tpu.utils import checkpoint as jck
from gipuma_tpu.utils.synthetic import make_ring_P, plane_scene

from gipuma_tpu_torch import AlgorithmParams
from gipuma_tpu_torch import pipeline as tpipe
from gipuma_tpu_torch.config import MAXCOST, MatchingAlgorithm
from gipuma_tpu_torch.convert import (params_from_dict, scene_pack_from_numpy,
                                      to_numpy_tree)
from gipuma_tpu_torch.models import pyramid as tpyr
from gipuma_tpu_torch.models.patchmatch import make_generator
from gipuma_tpu_torch.ops.cost import ScenePack
from gipuma_tpu_torch.ops.cost import multiview_cost as t_cost
from gipuma_tpu_torch.utils import checkpoint as tck

# The suite runs under pytest-xdist beside JAX's thread pools; at these
# sizes torch's intra-op threads only oversubscribe the cores.
torch.set_num_threads(1)


def _median_err(depth, gt, m=10):
    i = np.s_[m:-m, m:-m]
    return float(np.median(np.abs(depth[i] - gt[i]) / gt[i]))


@pytest.mark.parametrize("shape", [(33, 47), (32, 40, 3)])
def test_resample_bitwise(shape):
    rng = np.random.default_rng(2)
    a = (rng.random(shape) * 255).astype(np.float32)
    np.testing.assert_array_equal(tpyr.downscale2(a), jpyr.downscale2(a))
    small = tpyr.downscale2(a)
    h, w = shape[0], shape[1]
    want = jpyr.upsample2_to(small, h, w)
    np.testing.assert_array_equal(tpyr.upsample2_to(small, h, w), want)
    np.testing.assert_array_equal(
        tpyr._up2(torch.from_numpy(small), h, w).numpy(), want)


@pytest.fixture(scope="module")
def exact_scene():
    images, rig, gt, _ = plane_scene(num_cams=4, h=32, w=40, focal=60.0,
                                     plane_depth=5.0, slant=(0.2, -0.1),
                                     texture="noise")
    jp = JParams(box_hsize=7, box_vsize=7, seed=0).with_depth_range(
        3.0, 8.0, rig.f, FAKE_BASELINE)
    js = jscene.build_scene(images, rig, [1, 2, 3], jp, 3.0, 8.0)
    return dict(gt=gt, jp=jp, js=js,
                tp=params_from_dict(dataclasses.asdict(jp)),
                ts=scene_pack_from_numpy(to_numpy_tree(js), device="cpu"))


@pytest.mark.parametrize("carry", [False, True])
def test_warm_start_matches(exact_scene, carry):
    rng = np.random.default_rng(4)
    gt = exact_scene["gt"]
    depth = (gt * rng.uniform(0.97, 1.03, gt.shape)).astype(np.float32)
    depth[3, 4] = 0.0                    # invalid: mid-range fallback plane
    depth[7, 9] = np.nan
    nw = rng.normal(size=gt.shape + (3,)).astype(np.float32)
    nw /= np.linalg.norm(nw, axis=-1, keepdims=True)
    cost0 = rng.uniform(0.5, 30.0, gt.shape).astype(np.float32)
    ci = jnp.asarray(cost0) if carry else None
    jst = jax.jit(lambda sc, dd, nn, cc: jck._warm_start_impl(
        sc, exact_scene["jp"], jax.random.PRNGKey(0), dd, nn,
        cost_fn=j_cost, cost_init=cc))(exact_scene["js"], jnp.asarray(depth),
                                       jnp.asarray(nw), ci)
    tst = tck._warm_start_impl(
        exact_scene["ts"], exact_scene["tp"], None, torch.from_numpy(depth),
        torch.from_numpy(nw), cost_fn=t_cost,
        cost_init=torch.from_numpy(cost0) if carry else None)
    jpl, tpl = np.asarray(jst.planes), tst.planes.numpy()
    same = np.isclose(jpl, tpl, rtol=1e-5, atol=1e-6).all(-1)
    assert same.mean() >= 0.995, same.mean()
    jc, tc = np.asarray(jst.cost), tst.cost.numpy()
    np.testing.assert_allclose(tc[same], jc[same], rtol=0, atol=1e-4)
    if carry:
        assert tc[3, 4] == tc[7, 9] == MAXCOST
        np.testing.assert_array_equal(tc[0], np.float32(1.05) * cost0[0])


def test_pyramid_rect_cpu_gate():
    images, rig, gt, _ = plane_scene(num_cams=5, h=48, w=64, focal=100.0,
                                     plane_depth=5.0, slant=(0.2, -0.1))
    Ps = make_ring_P(5, 48, 64, 100.0, target_depth=5.0)
    params = AlgorithmParams(
        box_hsize=9, box_vsize=9, iterations=3, depth_min=3.0, depth_max=8.0,
        min_angle=0.01, max_angle=60.0, cost_path="rect",
        rect_two_stage_cull=True, cull_view_stride=2, pyramid_levels=2,
        pyramid_fine_iterations=1, pyramid_fine_far=False,
        pyramid_fine_refine_rounds=2, pyramid_carry_cost=True,
        pyramid_coarse_box=7)
    job = tpipe.prepare_job(images, Ps, params, device="cpu")
    assert job.pyramid and len(job.prep) == 2
    res = tpipe.run_prepared_job(job)
    assert res.depth.shape == gt.shape and np.isfinite(res.depth).all()
    assert _median_err(res.depth, gt) < 5e-3


def _verify_scene():
    images, rig, gt, _ = plane_scene(num_cams=5, h=60, w=72, focal=110.0,
                                     plane_depth=5.0, slant=(0.2, -0.1))
    Ps = make_ring_P(5, 60, 72, 110.0, target_depth=5.0)
    params = AlgorithmParams(box_hsize=9, box_vsize=9, iterations=3,
                             depth_min=3.0, depth_max=8.0, min_angle=0.01,
                             max_angle=60.0)
    return images, Ps, gt, params


def test_compute_depthmap_exact_default_cpu_gate():
    images, Ps, gt, params = _verify_scene()
    assert params.cost_path == "exact"
    res = tpipe.compute_depthmap(images, Ps, params, device="cpu")
    assert res.depth.shape == gt.shape and np.isfinite(res.depth).all()
    assert _median_err(res.depth, gt) < 5e-3


@pytest.mark.parametrize("levels", [1, 2])
def test_unrectifiable_rig_falls_back_to_exact(capsys, levels):
    """A forward-motion source cannot be row-rectified; with
    rect_drop_unsupported_views off the whole job (or, in a pyramid, each
    level) takes the exact path."""
    images, rig, gt, _ = plane_scene(num_cams=4, h=48, w=64, focal=100.0,
                                     plane_depth=5.0, slant=(0.2, -0.1))
    Ps = make_ring_P(4, 48, 64, 100.0, target_depth=5.0)
    K = np.array([[100.0, 0.0, 32.0], [0.0, 100.0, 24.0], [0.0, 0.0, 1.0]])
    Ps = list(Ps) + [K @ np.hstack([np.eye(3), [[0.0], [0.0], [-0.5]]])]
    images = list(images) + [images[0]]
    params = AlgorithmParams(
        box_hsize=9, box_vsize=9, iterations=3, depth_min=3.0, depth_max=8.0,
        min_angle=0.01, max_angle=60.0, view_selection=False,
        cost_path="rect", rect_drop_unsupported_views=False,
        pyramid_levels=levels)
    job = tpipe.prepare_job(images, Ps, params, device="cpu")
    if levels == 1:
        assert "falling back to the exact cost path" in \
            capsys.readouterr().out
        assert job.params.cost_path == "exact"
        scenes = [job.prep]
    else:
        scenes = [f.result()[0] for f in job.prep]
        assert capsys.readouterr().out.count(
            "rect path unavailable at pyramid level") == levels
    assert all(isinstance(sc, ScenePack) and sc.src is not None
               for sc in scenes)
    res = tpipe.run_prepared_job(job)
    err = np.abs(res.depth[8:-8, 8:-8] - gt[8:-8, 8:-8]) / gt[8:-8, 8:-8]
    assert np.median(err) < 5e-3


@pytest.mark.parametrize("kw", [dict(pyramid_levels=3),
                                dict(cost_path="exact"),
                                dict(refine_batched=False),
                                dict(use_pallas_sampler=True),
                                dict(cost_path="exact",
                                     algorithm=MatchingAlgorithm.CENSUS)])
def test_slice_settings_supported(kw):
    """prepare_job on a small ring (48x64, 4 cameras, CPU) builds each
    level's scene on the cost path the settings ask for."""
    images, rig, _, _ = plane_scene(num_cams=4, h=48, w=64, focal=90.0,
                                    plane_depth=5.0, slant=(0.2, -0.1))
    Ps = make_ring_P(4, 48, 64, 90.0, target_depth=5.0)
    p = AlgorithmParams(cost_path="rect", box_hsize=9, box_vsize=9,
                        iterations=1, depth_min=3.0, depth_max=8.0,
                        min_angle=0.01, max_angle=60.0).replace(**kw)
    job = tpipe.prepare_job(images, Ps, p, device="cpu")
    scenes = [f.result()[0] for f in job.prep] if job.pyramid else [job.prep]
    assert len(scenes) == p.pyramid_levels
    for sc in scenes:
        if p.cost_path == "exact":
            assert isinstance(sc, ScenePack) and sc.src is not None
        else:
            assert not isinstance(sc, ScenePack) and sc.num_views == 3


def test_warm_start_entry_point(exact_scene):
    """warm_start takes host arrays and returns the state on the scene's
    device, its cost evaluated by the given cost function."""
    gt = exact_scene["gt"]
    nw = np.zeros(gt.shape + (3,), np.float32)
    nw[..., 2] = -1.0
    st = tck.warm_start(exact_scene["ts"], exact_scene["tp"],
                        make_generator(0, "cpu"), gt, nw)
    assert st.planes.shape == gt.shape + (4,)
    assert (st.cost < MAXCOST).float().mean() > 0.9
