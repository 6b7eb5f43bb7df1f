"""gipuma_tpu_torch config, geometry, view selection, checkerboard and scene
geometry against the JAX package on identical numpy inputs.

Tolerances: configuration, rig building, rectification, view selection,
synthetic scenes and the checkerboard layout are exact; float32 tensor
geometry (rays, view vectors, plane algebra) agrees to rtol 1e-5 (the two
frameworks sum 3-term dot products in different orders)."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gipuma_tpu import config as jcfg
from gipuma_tpu.geometry import camera as jcam
from gipuma_tpu.geometry import rectify as jrect
from gipuma_tpu.geometry import transforms as jT
from gipuma_tpu.models import scene as jscene
from gipuma_tpu.ops import checkerboard as jcb
from gipuma_tpu.select import select_views as j_select_views
from gipuma_tpu.utils import synthetic as jsyn

from gipuma_tpu_torch import config as tcfg
from gipuma_tpu_torch.convert import params_from_dict
from gipuma_tpu_torch.geometry import camera as tcam
from gipuma_tpu_torch.geometry import rectify as trect
from gipuma_tpu_torch.geometry import transforms as tT
from gipuma_tpu_torch.models import scene as tscene
from gipuma_tpu_torch.ops import checkerboard as tcb
from gipuma_tpu_torch.select import select_views as t_select_views
from gipuma_tpu_torch.utils import synthetic as tsyn

REPO = Path(__file__).resolve().parents[1]

# The suite runs under pytest-xdist beside JAX's thread pools; at these
# sizes torch's intra-op threads only oversubscribe the cores.
torch.set_num_threads(1)


@pytest.fixture
def rng():
    """A fresh generator per test: inputs do not depend on test order."""
    return np.random.default_rng(1234)


def _named(p):
    return {k: (v.name if hasattr(v, "name") else v)
            for k, v in dataclasses.asdict(p).items()}


def test_port_imports_no_jax():
    """The port never imports JAX or the JAX package (fresh interpreter)."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import gipuma_tpu_torch as g; print(g.foreign_modules())"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_params_fields_defaults_presets_equal():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.AlgorithmParams)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.AlgorithmParams)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    assert _named(jcfg.AlgorithmParams()) == _named(tcfg.AlgorithmParams())
    assert set(jcfg.PRESETS) == set(tcfg.PRESETS)
    for k in jcfg.PRESETS:
        assert _named(jcfg.PRESETS[k]) == _named(tcfg.PRESETS[k]), k
    assert jcfg.MAXCOST == tcfg.MAXCOST
    for E in ("CostCombination", "MatchingAlgorithm"):
        assert ({m.name: m.value for m in getattr(jcfg, E)}
                == {m.name: m.value for m in getattr(tcfg, E)})


@pytest.mark.parametrize("preset", ["middlebury", "dtu_fast", "highres"])
def test_params_methods_and_convert(preset):
    jp = jcfg.PRESETS[preset].replace(box_hsize=9, window_increment=3)
    tp = params_from_dict(dataclasses.asdict(jp))
    assert _named(tp) == _named(jp)
    assert params_from_dict(_named(jp)) == tp
    assert (tp.box_hrad, tp.box_vrad) == (jp.box_hrad, jp.box_vrad)
    assert tp.window_offsets() == jp.window_offsets()
    assert tp.refinement_schedule() == jp.refinement_schedule()
    jd = jp.with_depth_range(3.0, 8.0, 800.0, 0.54)
    td = tp.with_depth_range(3.0, 8.0, 800.0, 0.54)
    assert _named(jd) == _named(td)
    assert (td.min_disparity, td.max_disparity) == (
        jd.min_disparity, jd.max_disparity)


def _ring(n=6, h=48, w=64, f=100.0, jitter=0.05):
    return jsyn.make_ring_P(n, h, w, f, target_depth=5.0, jitter=jitter,
                            rng=np.random.default_rng(3))


def test_build_rig_exact():
    Ps = _ring()
    jr = jcam.build_rig(Ps, cam_scale=0.5)
    tr = tcam.build_rig(Ps, cam_scale=0.5)
    for attr in ("f", "fy", "alpha", "baseline"):
        assert getattr(jr, attr) == getattr(tr, attr)
    np.testing.assert_array_equal(jr.K_ref, tr.K_ref)
    for jc, tc in zip(jr.cameras, tr.cameras):
        for f in dataclasses.fields(jc):
            a, b = getattr(jc, f.name), getattr(tc, f.name)
            if isinstance(a, str):
                assert a == b
            else:
                np.testing.assert_array_equal(a, b)
    cs = tcam.rig_to_cameraset(tr)
    np.testing.assert_array_equal(cs.K.numpy(),
                                  np.asarray(jcam.rig_to_cameraset(jr).K))


@pytest.mark.parametrize("min_angle,max_angle,max_views,vs", [
    (0.01, 60.0, 9, True), (3.0, 10.0, 9, True), (0.01, 60.0, 3, True),
    (0.01, 60.0, 9, False)])
def test_select_views_exact(min_angle, max_angle, max_views, vs):
    Ps = _ring(n=8)
    for dmin, dmax in ((-1.0, -1.0), (3.0, 8.0)):
        p = dict(min_angle=min_angle, max_angle=max_angle,
                 max_views=max_views, view_selection=vs,
                 depth_min=dmin, depth_max=dmax)
        jres = j_select_views(jcam.build_rig(Ps), 64, 48,
                              jcfg.AlgorithmParams(**p), seed=4)
        tres = t_select_views(tcam.build_rig(Ps), 64, 48,
                              tcfg.AlgorithmParams(**p), seed=4)
        assert jres == tres


def test_rectify_and_synthetic_exact():
    images_j, rig_j, gt_j, pl_j = jsyn.plane_scene(
        num_cams=4, h=40, w=56, focal=90.0, slant=(0.2, -0.1),
        texture="noise")
    images_t, rig_t, gt_t, pl_t = tsyn.plane_scene(
        num_cams=4, h=40, w=56, focal=90.0, slant=(0.2, -0.1),
        texture="noise")
    for a, b in zip(images_j, images_t):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gt_j, gt_t)
    ref = rig_j.cameras[0]
    for cam in rig_j.cameras[1:]:
        rj = jrect.rectify_pair(ref.K, cam.K, cam.R, cam.t)
        rt = trect.rectify_pair(ref.K, cam.K, cam.R, cam.t)
        for a, b in zip(rj, rt):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jrect.rectified_bounds(rj.T_ref, 56, 40),
                        trect.rectified_bounds(rt.T_ref, 56, 40)):
            np.testing.assert_array_equal(a, b)


def test_transforms_match():
    # A camera of the kind the engine sees (small rotation and offset,
    # planes facing it), so no output is a near-cancelling sum; the test's
    # own generator keeps the inputs independent of test order.
    rng = np.random.default_rng(11)
    h, w = 12, 16
    K = np.array([[90.0, 0, 8.0], [0, 95.0, 6.0], [0, 0, 1]])
    K_inv = np.linalg.inv(K).astype(np.float32)
    ax = rng.normal(scale=0.1, size=3)
    S = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    R = np.linalg.qr(np.eye(3) + S)[0]
    R = R * np.sign(np.diag(R))[None]
    C = rng.normal(scale=0.3, size=3)
    M_inv = np.linalg.inv(K @ R).astype(np.float32)
    P4 = (-K @ R @ C).astype(np.float32)
    C = C.astype(np.float32)
    n = np.concatenate([rng.normal(scale=0.3, size=(h, w, 2)),
                        -np.ones((h, w, 1))], axis=-1).astype(np.float32)
    depth = rng.uniform(3, 8, size=(h, w)).astype(np.float32)
    d = rng.uniform(-6, -3, size=(h, w)).astype(np.float32)
    jx, jy = jT.pixel_grid(h, w)
    tx, ty = tT.pixel_grid(h, w)
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    t = torch.from_numpy

    def close(a, b):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5,
                                   atol=1e-6)

    close(jT.pixel_rays(K_inv, jx, jy), tT.pixel_rays(t(K_inv), tx, ty))
    close(jT.view_vectors(M_inv, P4, C, jx, jy),
          tT.view_vectors(t(M_inv), t(P4), t(C), tx, ty))
    close(jT.plane_d_at_pixel(M_inv, P4, n, jx, jy, depth),
          tT.plane_d_at_pixel(t(M_inv), t(P4), t(n), tx, ty, t(depth)))
    close(jT.depth_from_plane(n, d, jx, jy, 90.0, 8.0, 6.0, 0.95),
          tT.depth_from_plane(t(n), t(d), tx, ty, 90.0, 8.0, 6.0, 0.95))
    close(jT.disparity_depth(90.0, 0.54, depth),
          tT.disparity_depth(90.0, 0.54, t(depth)))
    close(jT.normalize(n, eps=1e-20), tT.normalize(t(n), eps=1e-20))
    vv = rng.normal(size=(h, w, 3)).astype(np.float32)
    close(jT.flip_to_hemisphere(n, vv), tT.flip_to_hemisphere(t(n), t(vv)))
    K2, R2, t2 = rng.normal(size=(3, 3)), rng.normal(size=(3, 3)), \
        rng.normal(size=3)
    for a, b in zip(jT.warp_coefficients(K2, R2, t2),
                    tT.warp_coefficients(K2, R2, t2)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("parity", [0, 1])
def test_checkerboard_exact(rng, parity):
    a = rng.normal(size=(10, 12, 4)).astype(np.float32)
    h, w2 = 10, 6
    np.testing.assert_array_equal(np.asarray(jcb.active_x(h, w2, parity)),
                                  tcb.active_x(h, w2, parity).numpy())
    np.testing.assert_array_equal(np.asarray(jcb.active_y(h, w2)),
                                  tcb.active_y(h, w2).numpy())
    je = jcb.extract(jnp.asarray(a), parity)
    te = tcb.extract(torch.from_numpy(a), parity)
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    vals = rng.normal(size=(h, w2, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jcb.interleave(jnp.asarray(a), jnp.asarray(vals), parity)),
        tcb.interleave(torch.from_numpy(a), torch.from_numpy(vals),
                       parity).numpy())
    jp = jcb.PaddedEO.build(jnp.asarray(a), 5, 7)
    tp = tcb.PaddedEO.build(torch.from_numpy(a), 5, 7)
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1), (-5, 0), (5, 0),
                   (0, -5), (0, 5)):
        np.testing.assert_array_equal(
            np.asarray(jp.shifted(dy, dx, parity)),
            tp.shifted(dy, dx, parity).numpy())


@pytest.mark.parametrize("no_texture_check", [False, True])
def test_build_scene_geometry_matches(no_texture_check):
    images, rig, _, _ = jsyn.plane_scene(num_cams=4, h=24, w=32,
                                         focal=60.0)
    images[0][:, :12] = 128.0       # a textureless band
    p = jcfg.AlgorithmParams(box_hsize=5, box_vsize=5,
                             no_texture_check=no_texture_check)
    js = jscene.build_scene(images, rig, [1, 2, 3], p, 3.0, 8.0, lite=True)
    ts = tscene.build_scene(images, rig, [1, 2, 3],
                            params_from_dict(dataclasses.asdict(p)),
                            3.0, 8.0, lite=True, device="cpu")
    for f in ts._fields:
        if getattr(ts, f) is None:      # the exact path's fields (lite)
            continue
        np.testing.assert_allclose(np.asarray(getattr(js, f)),
                                   getattr(ts, f).numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    padded = tscene.pad_scene_views(ts, 4)
    assert padded.num_views == 4 and padded.view_valid.tolist() == [1, 1, 1, 0]
