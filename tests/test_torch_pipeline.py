"""gipuma_tpu_torch pipeline end to end on the CPU, and its scene build and
output writers against the JAX package.

* compute_depthmap(device="cpu") on the /verify scene with the rect slice
  configuration passes the quality gate (median rel depth err < 5e-3);
* build_rect_scene equals the JAX package's when both warp with numpy
  (tables, masks and packed source words bitwise; float fields to 1e-6);
* write_outputs writes the seven artifacts; .dmb/.ply bytes equal the JAX
  writers' for the same result, and the PNGs decode to the same pixels;
* compute_depthmap through the census and the unfused rect costs passes
  the same gate; prepare_job builds every rect layout's scene;
* the settings that raised NotImplementedError before the port ran them
  (cull_downscale screening, level_dispatch="scan", shape quantization,
  monolithic propagation) prepare and run, and the entry points do not
  fall back to the CPU silently."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gipuma_tpu.models.rect_scene as jrs
from gipuma_tpu.config import AlgorithmParams as JParams
from gipuma_tpu.geometry.camera import FAKE_BASELINE
from gipuma_tpu.pipeline import RunResult as JRunResult
from gipuma_tpu.pipeline import write_outputs as j_write_outputs
from gipuma_tpu.utils.synthetic import make_ring_P, plane_scene

from gipuma_tpu_torch import AlgorithmParams, MatchingAlgorithm
from gipuma_tpu_torch import pipeline as tpipe
from gipuma_tpu_torch.convert import params_from_dict
from gipuma_tpu_torch.io.dmb import read_dmb
from gipuma_tpu_torch.models.rect_scene import build_rect_scene as t_build
from gipuma_tpu_torch.models.scene import build_scene

REPO = Path(__file__).resolve().parents[1]

# The suite runs under pytest-xdist beside JAX's thread pools; at these
# sizes torch's intra-op threads only oversubscribe the cores.
torch.set_num_threads(1)
ARTIFACTS = ["3d_model_cam000.ply", "cost.png", "disp.dmb", "disp.png",
             "normals.dmb", "normals.png", "results.txt"]


def test_port_imports_no_jax():
    """The port never imports JAX or the JAX package (fresh interpreter)."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import gipuma_tpu_torch as g; print(g.foreign_modules())"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def _verify_params(**kw):
    return AlgorithmParams(
        box_hsize=9, box_vsize=9, iterations=3, depth_min=3.0,
        depth_max=8.0, min_angle=0.01, max_angle=60.0, cost_path="rect",
        rect_two_stage_cull=True, cull_view_stride=2, **kw)


@pytest.fixture(scope="module")
def verify_run():
    images, rig, gt, _ = plane_scene(num_cams=5, h=60, w=72, focal=110.0,
                                     plane_depth=5.0, slant=(0.2, -0.1))
    Ps = make_ring_P(5, 60, 72, 110.0, target_depth=5.0)
    params = _verify_params()
    res = tpipe.compute_depthmap(images, Ps, params, device="cpu")
    return dict(images=images, rig=rig, gt=gt, params=params, res=res)


def test_compute_depthmap_quality_gate(verify_run):
    res, gt = verify_run["res"], verify_run["gt"]
    assert res.depth.shape == gt.shape and np.isfinite(res.depth).all()
    i = np.s_[10:-10, 10:-10]
    err = np.abs(res.depth[i] - gt[i]) / gt[i]
    assert np.median(err) < 5e-3, np.median(err)
    assert res.view_subset == [1, 2, 3, 4]


def _result_pair(verify_run):
    r = verify_run["res"]
    fields = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
    return r, JRunResult(**fields)


def test_write_outputs_artifacts_and_bytes(verify_run, tmp_path):
    tres, jres = _result_pair(verify_run)
    params = verify_run["params"]
    jparams = JParams(**{f.name: getattr(params, f.name)
                         for f in dataclasses.fields(params)
                         if f.name not in ("algorithm", "cost_comb")})
    img, P = verify_run["images"][0], verify_run["rig"].cameras[0].P
    tpipe.write_outputs(tres, tmp_path / "t", params, ref_image=img, P_ref=P)
    j_write_outputs(jres, tmp_path / "j", jparams, ref_image=img, P_ref=P)
    assert sorted(os.listdir(tmp_path / "t")) == ARTIFACTS
    for name in ("disp.dmb", "normals.dmb", "3d_model_cam000.ply"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    np.testing.assert_array_equal(read_dmb(tmp_path / "j" / "disp.dmb"),
                                  tres.depth)
    np.testing.assert_array_equal(read_dmb(tmp_path / "j" / "normals.dmb"),
                                  tres.normals)
    Image = pytest.importorskip("PIL.Image")
    for name in ("disp.png", "normals.png", "cost.png"):
        a = np.asarray(Image.open(tmp_path / "t" / name))
        b = np.asarray(Image.open(tmp_path / "j" / name))
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_build_rect_scene_matches_numpy_warp(monkeypatch):
    monkeypatch.setattr(jrs, "_HAVE_CV2", False)
    images, rig, _, _ = plane_scene(num_cams=4, h=32, w=48, focal=70.0,
                                    plane_depth=5.0, slant=(0.2, -0.1),
                                    texture="noise")
    jp = JParams(box_hsize=7, box_vsize=7, cost_path="rect",
                 rect_two_stage_cull=True, cull_view_stride=2
                 ).with_depth_range(3.0, 8.0, rig.f, FAKE_BASELINE)
    tp = params_from_dict(dataclasses.asdict(jp))
    js, jinfo = jrs.build_rect_scene(images, rig, [1, 2, 3], jp, 3.0, 8.0)
    ts, tinfo = t_build(images, rig, [1, 2, 3], tp, 3.0, 8.0, device="cpu")
    assert jinfo["pairs"] == tinfo["pairs"]
    assert js.spans.shape == tuple(ts.spans.shape)
    assert list(ts.rot_k_host) == np.asarray(js.rot_k).tolist()
    for f in ("ref_rect", "src_rect", "fwd_c1", "fwd_r", "ret_c1", "ret_r",
              "rot_k", "disp_bounds", "hw_valid", "tile_ok", "fwd2_ok",
              "ret2_ok"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    np.testing.assert_allclose(ts.L.numpy(), np.asarray(js.L), rtol=1e-6)
    for f in ts.base._fields:
        if getattr(ts.base, f) is None:  # the exact path's fields (lite)
            continue
        np.testing.assert_allclose(getattr(ts.base, f).numpy(),
                                   np.asarray(getattr(js.base, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def _prepared(**kw):
    """prepare_job with the /verify settings (one iteration) changed by
    `kw`, on a small ring (48x64, 4 cameras) on the CPU; returns the job
    and its scenes (a pyramid's coarsest first)."""
    images, rig, _, _ = plane_scene(num_cams=4, h=48, w=64, focal=90.0,
                                    plane_depth=5.0, slant=(0.2, -0.1))
    Ps = make_ring_P(4, 48, 64, 90.0, target_depth=5.0)
    job = tpipe.prepare_job(images, Ps,
                            _verify_params().replace(iterations=1, **kw),
                            device="cpu")
    scenes = [f.result()[0] for f in job.prep] if job.pyramid else [job.prep]
    return job, scenes


# The settings that raised NotImplementedError until the port ran them
# (the cull_downscale screening scene, the whole-level scan); the test
# keeps its name and now holds that they prepare and run.
@pytest.mark.parametrize("kw", [dict(cull_downscale=2),
                                dict(cull_downscale=3, pyramid_levels=3),
                                dict(cull_downscale=4,
                                     algorithm=MatchingAlgorithm.CENSUS),
                                dict(level_dispatch="scan", pyramid_levels=3),
                                dict(level_dispatch="scan")])
def test_off_slice_settings_raise(kw):
    job, scenes = _prepared(**kw)
    if kw.get("cull_downscale", 1) > 1:
        # The nested screening scene on every level that screens: one
        # level, or the warm-started ones of a pyramid (the coarsest
        # starts from random planes and screens at full resolution).
        warm = scenes[1:] if job.pyramid else scenes
        assert all(sc.cull is not None for sc in warm)
        assert all(sc.cull.ref_rect.shape[-2] < sc.ref_rect.shape[-2]
                   for sc in warm)
        if job.pyramid:
            assert scenes[0].cull is None
        return
    # The scan runs the host loop's schedule: on the CPU, the same bits.
    got = tpipe.run_prepared_job(job)
    host = _prepared(**dict(kw, level_dispatch="host"))[0]
    want = tpipe.run_prepared_job(host)
    np.testing.assert_array_equal(got.depth, want.depth)
    np.testing.assert_array_equal(got.cost, want.cost)
    assert np.isfinite(got.depth).all()


@pytest.mark.parametrize("kw", [dict(rect_quantize_shapes=True),
                                dict(propagation_variant="monolithic"),
                                dict(rect_quantize_shapes=True,
                                     propagation_variant="monolithic",
                                     pyramid_levels=3)])
def test_slice6_settings_supported(kw):
    job, scenes = _prepared(**kw)
    assert len(scenes) == kw.get("pyramid_levels", 1)
    for sc in scenes:
        assert sc.num_views >= 1 and sc.ref_rect.shape[-1] % 128 == 0
        if kw.get("rect_quantize_shapes"):
            # Quantized buckets: rows and columns rounded up to the quanta.
            assert sc.ref_rect.shape[-2] % job.params.rect_quantum_rows == 0
    assert job.params.propagation_variant == kw.get(
        "propagation_variant", _verify_params().propagation_variant)


# Every rect layout and cost: census, the unfused window_grads cost, full
# channels, grad_fwd and f32 taps.
SLICE3 = {"census": dict(algorithm=MatchingAlgorithm.CENSUS),
          "unfused": dict(fused_window_cost=False),
          "full": dict(window_grads=False),
          "gfwd": dict(window_grads=False, grad_fwd_pack=True),
          "f32": dict(pack_taps=False)}


@pytest.mark.parametrize("name", list(SLICE3))
def test_rect_layouts_supported(name):
    """prepare_job builds each layout's rect scene: packed image words
    ([C] int32, window_grads), [img, gy] words ([2C] int32, grad_fwd),
    [img, gx, gy] words ([3C] int32, full) or channels ([3C] float32,
    f32 taps)."""
    job, (sc,) = _prepared(**SLICE3[name])
    C = sc.ref_rect.shape[1] // 3
    want = {"census": (C, torch.int32), "unfused": (C, torch.int32),
            "full": (3 * C, torch.int32), "gfwd": (2 * C, torch.int32),
            "f32": (3 * C, torch.float32)}[name]
    assert (sc.src_rect.shape[1], sc.src_rect.dtype) == want


@pytest.mark.parametrize("name,iters", [("census", 4), ("unfused", 3)])
def test_compute_depthmap_census_and_unfused(name, iters):
    """compute_depthmap(device="cpu") on the /verify scene through the
    census and the unfused window_grads rect costs passes the gate."""
    images, rig, gt, _ = plane_scene(num_cams=5, h=60, w=72, focal=110.0,
                                     plane_depth=5.0, slant=(0.2, -0.1))
    Ps = make_ring_P(5, 60, 72, 110.0, target_depth=5.0)
    params = _verify_params(**SLICE3[name]).replace(iterations=iters)
    res = tpipe.compute_depthmap(images, Ps, params, device="cpu")
    assert res.depth.shape == gt.shape and np.isfinite(res.depth).all()
    i = np.s_[10:-10, 10:-10]
    err = np.abs(res.depth[i] - gt[i]) / gt[i]
    assert np.median(err) < 5e-3, np.median(err)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    images, rig, _, _ = plane_scene(num_cams=3, h=16, w=24, focal=40.0)
    Ps = make_ring_P(3, 16, 24, 40.0, target_depth=5.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.compute_depthmap(images, Ps, _verify_params())


def test_build_scene_defaults_to_the_card():
    """models.scene.build_scene, a public entry point, runs on the card
    unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    images, rig, _, _ = plane_scene(num_cams=3, h=16, w=24, focal=40.0)
    p = _verify_params()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_scene(images, rig, [1, 2], p, 3.0, 8.0)
    s = build_scene(images, rig, [1, 2], p, 3.0, 8.0, device="cpu")
    assert s.rays.device.type == "cpu"
