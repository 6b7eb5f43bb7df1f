"""gipuma_tpu_torch's downscaled cull screening scene
(config.cull_downscale) against the JAX package, with cv2 off in both
(the port's warp and blur are the JAX package's numpy branches):

* _gauss_blur on [H, W] and [H, W, C] equals JAX's to 1e-6;
* build_rect_scene with cull_downscale=2 and the two-stage cull: the
  nested scene's tables, masks and packed words and info["cull"] equal
  JAX's bit for bit, its float fields to 1e-6;
* the sparse pass's window costs on the nested scene agree to 1e-3 abs
  (the fused-cost tolerance), the MAXCOST pattern exactly;
* one refinement sweep with the JAX draws injected (its K candidates go
  through the sparse pass on the nested scene): accepted planes equal on
  >= 99.5% of the active pixels, JAX's cost batch evaluating the
  candidate planes the port made from the draws.  Each framework's own
  candidates differ in the last bit, and a candidate clamped to the depth
  bound then flips its depth-range test (4 of 768 pixels on this scene);
  JAX's cost batch under jit against the same batch op by op flips 7
  (XLA's fusions round that depth differently), while op by op JAX and
  the port agree on every pixel;
* convert carries the nested scene across;
* a nested build that cannot rectify leaves info["cull"] = {"error": ...}
  and the sparse pass on the strided views (_slice_views), as in JAX;
* compute_depthmap with cull_downscale=2 on a 3-level pyramid passes the
  5e-3 gate on the /verify scene."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gipuma_tpu.models.rect_scene as jrs
from gipuma_tpu.config import AlgorithmParams as JParams
from gipuma_tpu.geometry.camera import FAKE_BASELINE
from gipuma_tpu.models import patchmatch as jpm
from gipuma_tpu.ops import checkerboard as jcb
from gipuma_tpu.ops import rect_cost as jrc
from gipuma_tpu.utils.synthetic import make_ring_P, plane_scene

from gipuma_tpu_torch import AlgorithmParams
from gipuma_tpu_torch import pipeline as tpipe
from gipuma_tpu_torch.config import MAXCOST
from gipuma_tpu_torch.convert import (params_from_dict, rect_scene_from_numpy,
                                      state_from_numpy, to_numpy_tree)
from gipuma_tpu_torch.models import patchmatch as tpm
from gipuma_tpu_torch.models import rect_scene as trs
from gipuma_tpu_torch.ops import rect_cost as trc

# The suite runs under pytest-xdist beside JAX's thread pools; at these
# sizes torch's intra-op threads only oversubscribe the cores.
torch.set_num_threads(1)
FRAC = 0.995
TABLE_FIELDS = ("ref_rect", "src_rect", "fwd_c1", "fwd_r", "ret_c1",
                "ret_r", "rot_k", "disp_bounds", "hw_valid", "tile_ok",
                "fwd2_ok", "ret2_ok")


@pytest.mark.parametrize("shape", [(20, 27), (20, 27, 3)])
def test_gauss_blur_matches(monkeypatch, shape):
    monkeypatch.setattr(jrs, "_HAVE_CV2", False)
    img = np.random.default_rng(3).uniform(0, 255, shape).astype(np.float32)
    for cds in (2, 3, 4):
        sigma = 0.5 * float(np.sqrt(cds * cds - 1.0))
        want = jrs._gauss_blur(img, sigma)
        got = trs._gauss_blur(img, sigma)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert trs._gauss_blur(img, 0.0) is img


@pytest.fixture(scope="module")
def scenes():
    mp = pytest.MonkeyPatch()
    mp.setattr(jrs, "_HAVE_CV2", False)
    images, rig, _, (n_w, d_w) = plane_scene(
        num_cams=4, h=32, w=48, focal=70.0, plane_depth=5.0,
        slant=(0.2, -0.1), texture="noise")
    jp = JParams(box_hsize=7, box_vsize=7, iterations=1, seed=0,
                 cost_path="rect", rect_two_stage_cull=True,
                 cull_view_stride=2, cull_downscale=2
                 ).with_depth_range(3.0, 8.0, rig.f, FAKE_BASELINE)
    tp = params_from_dict(dataclasses.asdict(jp))
    jscene, jinfo = jrs.build_rect_scene(images, rig, [1, 2, 3], jp, 3.0, 8.0)
    tscene, tinfo = trs.build_rect_scene(images, rig, [1, 2, 3], tp, 3.0, 8.0,
                                         device="cpu")
    mp.undo()
    R0 = rig.cameras[0].R_orig_inv.T
    return dict(images=images, rig=rig, jp=jp, tp=tp, jscene=jscene,
                jinfo=jinfo, tscene=tscene, tinfo=tinfo, n_ref=R0 @ n_w,
                d_ref=float(d_w))


def test_cull_scene_matches(scenes):
    js, ts = scenes["jscene"].cull, scenes["tscene"].cull
    assert js is not None and ts is not None
    assert scenes["jinfo"]["cull"] == scenes["tinfo"]["cull"]
    # Downscaled grid over the strided views.
    assert ts.num_views == 2
    assert ts.ref_rect.shape[-2] < scenes["tscene"].ref_rect.shape[-2]
    assert js.spans.shape == tuple(ts.spans.shape)
    assert list(ts.rot_k_host) == np.asarray(js.rot_k).tolist()
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    np.testing.assert_allclose(ts.L.numpy(), np.asarray(js.L), rtol=1e-6)
    for f in ts.base._fields:
        if getattr(ts.base, f) is None:
            continue
        np.testing.assert_allclose(getattr(ts.base, f).numpy(),
                                   np.asarray(getattr(js.base, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def _candidates(s, parity, K, seed):
    """K candidate planes per active pixel around the true plane (numpy),
    as tests/test_torch_rect_cost.py draws them."""
    rng = np.random.default_rng(seed)
    sc = s["tscene"]
    h, w2 = sc.rays.shape[0], sc.rays.shape[1] // 2
    n = np.broadcast_to(s["n_ref"], (K, h, w2, 3)).astype(np.float32).copy()
    d = np.full((K, h, w2), s["d_ref"], np.float32)
    n[1:] += rng.normal(scale=0.05, size=n[1:].shape).astype(np.float32)
    d[2:] *= rng.uniform(0.97, 1.03, size=d[2:].shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return n.astype(np.float32), d


def test_sparse_pass_costs_on_cull_scene(scenes):
    K, parity = 4, 1
    n, d = _candidates(scenes, parity, K, seed=parity)
    jp, tp = scenes["jp"], scenes["tp"]
    sp_j = jp.replace(box_hsize=jp.cull_box, box_vsize=jp.cull_box,
                      window_increment=jp.cull_increment)
    sp_t = tp.replace(box_hsize=tp.cull_box, box_vsize=tp.cull_box,
                      window_increment=tp.cull_increment)
    jfn = jax.jit(lambda sc, nn, dd: jrc.rect_per_view_costs_batch(
        sc, sp_j, parity, nn, dd, m_pack="tri", cost_pack=True))
    want = np.asarray(jfn(scenes["jscene"].cull, jnp.asarray(n),
                          jnp.asarray(d)))
    got = trc.rect_per_view_costs_batch(
        scenes["tscene"].cull, sp_t, parity, torch.from_numpy(n),
        torch.from_numpy(d), m_pack="tri", cost_pack=True).numpy()
    assert got.shape == want.shape == (2, K) + d.shape[1:]
    np.testing.assert_array_equal(got == MAXCOST, want == MAXCOST)
    live = want < MAXCOST
    assert live.mean() > 0.3, live.mean()
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-3)


def test_refinement_sweep_on_cull_scene(scenes, monkeypatch):
    """refine_batched: the R candidates are ranked by the sparse pass on
    the nested scene, the winner evaluated on the full one.  The port's
    sweep runs with the JAX draws; JAX's cost batch, op by op, evaluates
    the candidate planes the port's sweep made from them, and the accept
    fold (patchmatch.py:317-324 of the JAX package) runs in numpy."""
    parity = 0
    jp, jscene = scenes["jp"], scenes["jscene"]
    jinit = jax.jit(lambda sc, k: jpm.init_state(
        sc, jp, k, cost_fn=jrc.rect_multiview_cost))
    js = jinit(jscene, jax.random.PRNGKey(3))
    _, kz, kn = jax.random.split(js.key, 3)
    h, w = js.cost.shape
    R = len(jp.refinement_schedule())
    assert R > 1
    u = np.array(jax.random.uniform(kz, (R, h, w // 2), jnp.float32))
    u_n = np.array(jax.random.uniform(kn, (R, h, w // 2, 3), jnp.float32))
    seen = {}
    batch = trc.rect_multiview_cost.batch

    def spy(scene, params, par, n, d, cand_ok=None, cur=None):
        seen.update(n=n.numpy().copy(), d=d.numpy().copy(),
                    cur=tuple(t.numpy().copy() for t in cur))
        return batch(scene, params, par, n, d, cand_ok=cand_ok, cur=cur)

    monkeypatch.setattr(trc.rect_multiview_cost, "batch", spy)
    st = state_from_numpy(js.planes, js.cost, device="cpu")
    tnew = tpm.refinement_sweep(st, scenes["tscene"], scenes["tp"], parity,
                                trc.rect_multiview_cost,
                                uniforms=(torch.from_numpy(u),
                                          torch.from_numpy(u_n)))
    ck = np.asarray(jrc.rect_multiview_cost_batch(
        jscene, jp, parity, jnp.asarray(seen["n"]), jnp.asarray(seen["d"]),
        cur=tuple(jnp.asarray(t) for t in seen["cur"])))
    n_now, d_now = seen["cur"]
    c_now = np.asarray(jcb.extract(js.cost, parity))
    for k in range(R):
        accept = ck[k] < c_now
        n_now = np.where(accept[..., None], seen["n"][k], n_now)
        d_now = np.where(accept, seen["d"][k], d_now)
        c_now = np.where(accept, ck[k], c_now)
    want = np.concatenate([n_now, d_now[..., None]], axis=-1)
    tpl = tnew.planes.numpy()
    tpl = np.where(((np.arange(h)[:, None] + parity) % 2 == 0)[..., None],
                   tpl[:, 0::2], tpl[:, 1::2])
    same = (want == tpl).all(-1)
    assert same.mean() >= FRAC, f"planes agree on {same.mean():.4f}"
    tc = tcb_extract(tnew.cost.numpy(), parity)
    np.testing.assert_allclose(tc[same], c_now[same], rtol=0, atol=1e-3)
    changed = ~np.all(want == np.asarray(jcb.extract(js.planes, parity)), -1)
    assert changed.sum() > 0, "the sweep accepted nothing"


def tcb_extract(a, parity):
    """The active half-grid of a full [H, W] numpy array."""
    rows = (np.arange(a.shape[0])[:, None] + parity) % 2 == 0
    return np.where(rows, a[:, 0::2], a[:, 1::2])


def test_convert_carries_cull(scenes):
    ts = rect_scene_from_numpy(to_numpy_tree(scenes["jscene"]), device="cpu")
    assert ts.cull is not None and ts.cull.cull is None
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(ts.cull, f).numpy(),
                                      getattr(scenes["tscene"].cull, f)
                                      .numpy(), err_msg=f)
    assert ts.cull.rot_k_host == scenes["tscene"].cull.rot_k_host
    assert ts.cull.valid_host == scenes["tscene"].cull.valid_host


def test_failed_cull_build_falls_back(scenes, monkeypatch):
    build = trs.build_rect_scene

    def no_downscaled(*a, rect_scale=1.0, **k):
        if rect_scale != 1.0:
            raise trs.RectifyUnsupported("no downscaled grid here")
        return build(*a, rect_scale=rect_scale, **k)

    monkeypatch.setattr(trs, "build_rect_scene", no_downscaled)
    scene, info = build(scenes["images"], scenes["rig"], [1, 2, 3],
                        scenes["tp"], 3.0, 8.0, device="cpu")
    assert scene.cull is None
    assert info["cull"] == {"error": "no downscaled grid here"}
    strides = []
    slice_views = trc._slice_views

    def spy(sc, stride):
        strides.append(stride)
        return slice_views(sc, stride)

    monkeypatch.setattr(trc, "_slice_views", spy)
    n, d = _candidates(scenes, 1, 4, seed=9)
    got = trc.rect_multiview_cost_batch(scene, scenes["tp"], 1,
                                        torch.from_numpy(n),
                                        torch.from_numpy(d))
    assert strides == [2]
    assert got.shape == d.shape
    # With the nested scene the sparse pass never slices views.
    strides.clear()
    trc.rect_multiview_cost_batch(scenes["tscene"], scenes["tp"], 1,
                                  torch.from_numpy(n), torch.from_numpy(d))
    assert strides == []


def test_compute_depthmap_cull_downscale_pyramid():
    """bench.py's default pyramid with cull_downscale=2 on the /verify
    scene: only the warm-started levels screen on a nested scene."""
    images, rig, gt, _ = plane_scene(num_cams=5, h=60, w=72, focal=110.0,
                                     plane_depth=5.0, slant=(0.2, -0.1))
    Ps = make_ring_P(5, 60, 72, 110.0, target_depth=5.0)
    params = AlgorithmParams(
        box_hsize=9, box_vsize=9, iterations=3, depth_min=3.0,
        depth_max=8.0, min_angle=0.01, max_angle=60.0, cost_path="rect",
        rect_two_stage_cull=True, cull_view_stride=2, pyramid_levels=3,
        pyramid_fine_iterations=1, pyramid_fine_far=False,
        pyramid_fine_refine_rounds=2, pyramid_carry_cost=True,
        pyramid_coarse_box=7, cull_downscale=2)
    job = tpipe.prepare_job(images, Ps, params, device="cpu")
    levels = [f.result() for f in job.prep]
    # Coarsest first: it starts from random planes and screens at full
    # resolution; the warm-started levels carry a nested scene.
    assert levels[0][0].cull is None
    assert all(sc.cull is not None for sc, *_ in levels[1:])
    res = tpipe.run_prepared_job(job)
    assert res.depth.shape == gt.shape and np.isfinite(res.depth).all()
    i = np.s_[10:-10, 10:-10]
    err = np.abs(res.depth[i] - gt[i]) / gt[i]
    assert np.median(err) < 5e-3, np.median(err)
