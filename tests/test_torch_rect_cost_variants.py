"""gipuma_tpu_torch rect cost paths beyond the fused window_grads one,
against the JAX package (Pallas kernels in interpret mode, full block scan)
on identical numpy inputs:

* rect_pair_cost_batch for census (packed and f32 layouts), the unfused
  window_grads cost (ring and one-sided edges; packed and f32 image
  channels), and the full-channel, grad_fwd and f32 scans, at hr=16,
  wr=128, box 5, K=2 with one NaN plane pixel (one 128-column block: the
  interpret-mode compile of the JAX kernels grows with the block count,
  and the port's kernels have no blocks).  PM costs agree within
  1e-3 abs (XLA contracts products and sums into FMAs in interpret mode,
  which moves a sample position by an ulp; the sources are smooth so that
  stays small) and census costs (whole counts) are equal on >= 99.5% of
  pixels;
* build_rect_scene for the full, grad_fwd and f32 layouts equals the JAX
  build when both warp with numpy (bitwise; L to 1e-6);
* rect_per_view_costs_batch on a JAX scene carried across by convert, for
  census and for the f32 layout (whose float src_rect convert must keep);
* rect_window_cost and rect_pair_cost, the single-hypothesis forms."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gipuma_tpu.models.rect_scene as jrs
from gipuma_tpu.config import AlgorithmParams as JParams
from gipuma_tpu.config import MatchingAlgorithm as JAlg
from gipuma_tpu.geometry.camera import FAKE_BASELINE
from gipuma_tpu.ops import rect_cost as jrc
from gipuma_tpu.ops.pallas_rowgather import pack_taps
from gipuma_tpu.utils.synthetic import plane_scene

from gipuma_tpu_torch.config import MAXCOST
from gipuma_tpu_torch.convert import (params_from_dict, rect_scene_from_numpy,
                                      to_numpy_tree)
from gipuma_tpu_torch.models.rect_scene import build_rect_scene as t_build
from gipuma_tpu_torch.ops import rect_cost as trc

# The suite runs under pytest-xdist beside JAX's thread pools; at these
# sizes torch's intra-op threads only oversubscribe the cores.
torch.set_num_threads(1)
ATOL = 1e-3
HR, WR, K = 16, 128, 2
LO, HI = -5.0, 45.0


@pytest.fixture
def rng():
    """A fresh generator per test: inputs do not depend on test order."""
    return np.random.default_rng(2024)


def _smooth(rng, c):
    yy, xx = np.mgrid[0:HR, 0:WR].astype(np.float32)
    ph = rng.uniform(0, 6, size=(c, 1, 1)).astype(np.float32)
    img = 120.0 + 60.0 * np.sin(xx / 20.0 + ph) * np.cos(yy / 7.0 + ph)
    return img.astype(np.float32)


def _grads(img, step=1, fwd=False):
    """[img, gx, gy] with edge-replicated differences."""
    if fwd:
        gx = np.empty_like(img)
        gx[..., :-1] = 2.0 * (img[..., 1:] - img[..., :-1])
        gx[..., -1:] = gx[..., -2:-1]
    else:
        p = np.pad(img, ((0, 0), (0, 0), (step, step)), mode="edge")
        gx = p[..., 2 * step:] - p[..., :-2 * step]
    p = np.pad(img, ((0, 0), (step, step), (0, 0)), mode="edge")
    gy = p[:, 2 * step:] - p[:, :-2 * step]
    return np.concatenate([img, gx, gy]).astype(np.float32)


def _abc(rng):
    abc = np.empty((K, 3, HR, WR), np.float32)
    abc[:, 0] = rng.uniform(-0.15, 0.15, size=(K, 1, 1))
    abc[:, 1] = rng.uniform(-0.1, 0.1, size=(K, 1, 1))
    abc[:, 2] = rng.uniform(5.0, 40.0, size=(K, 1, 1))
    abc += rng.normal(scale=0.01, size=abc.shape).astype(np.float32)
    abc[0, 2, 5, 100] = np.nan
    return abc


# name -> (source layout, params beyond box 5)
VARIANTS = {
    "census_packed": ("img_packed", dict(algorithm="CENSUS")),
    "census_f32": ("full_f32", dict(algorithm="CENSUS")),
    "unfused_ring": ("img_packed", dict(fused_window_cost=False,
                                        sdg_onesided_edges=False)),
    "unfused_onesided": ("img_packed", dict(fused_window_cost=False,
                                            sdg_onesided_edges=True)),
    "unfused_f32": ("img_f32", dict(fused_window_cost=False)),
    "full": ("full_packed", dict(window_grads=False)),
    "gfwd": ("gfwd_packed", dict(window_grads=False, grad_fwd_pack=True)),
    "f32": ("full_f32", dict(pack_taps=False)),
}


def _inputs(rng, layout, inc):
    ref_img, src_img = _smooth(rng, 1), _smooth(rng, 1)
    if layout in ("img_packed", "img_f32"):
        ref = _grads(ref_img, step=inc)
        src = pack_taps(src_img) if layout == "img_packed" else src_img
    elif layout == "gfwd_packed":
        ref = _grads(ref_img, fwd=True)
        s = _grads(src_img)
        src = pack_taps(np.concatenate([s[:1], s[2:]]))
    else:
        ref = _grads(ref_img)
        src = _grads(src_img)
        src = pack_taps(src) if layout == "full_packed" else src
    return ref, src, _abc(rng)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_rect_pair_cost_batch_variants(rng, name):
    layout, kw = VARIANTS[name]
    census = kw.get("algorithm") == "CENSUS"
    jkw = dict(kw, algorithm=JAlg.CENSUS) if census else kw
    jp = JParams(box_hsize=5, box_vsize=5, **jkw)
    tp = params_from_dict(dataclasses.asdict(jp))
    ref, src, abc = _inputs(rng, layout, jp.window_increment)
    want = np.asarray(jrc.rect_pair_cost_batch(
        jnp.asarray(ref), jnp.asarray(src), jnp.asarray(abc), jp,
        interpret=True, disp_lo=jnp.float32(LO), disp_hi=jnp.float32(HI),
        span_blocks=None))
    got = trc.rect_pair_cost_batch(
        torch.from_numpy(ref), torch.from_numpy(src), torch.from_numpy(abc),
        tp, torch.tensor([LO, HI])).numpy()
    assert got.shape == want.shape == (K, HR, WR)
    if census:
        # A NaN sample falls in the middle sign class: no MAXCOST here.
        assert got[0, 5, 100] == want[0, 5, 100] < MAXCOST
        assert np.mean(got == want) >= 0.995, np.mean(got == want)
    else:
        assert got[0, 5, 100] == want[0, 5, 100] == MAXCOST  # NaN plane
        np.testing.assert_array_equal(got == MAXCOST, want == MAXCOST)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_rect_pair_cost_single_field(rng):
    jp = JParams(box_hsize=5, box_vsize=5, window_grads=False)
    tp = params_from_dict(dataclasses.asdict(jp))
    ref, src, abc = _inputs(rng, "full_packed", 2)
    want = np.asarray(jrc.rect_pair_cost(
        jnp.asarray(ref), jnp.asarray(src), jnp.asarray(abc[1]), jp,
        interpret=True, disp_lo=jnp.float32(LO), disp_hi=jnp.float32(HI)))
    got = trc.rect_pair_cost(torch.from_numpy(ref), torch.from_numpy(src),
                             torch.from_numpy(abc[1]), tp,
                             torch.tensor([LO, HI])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_rect_window_cost(rng):
    jp = JParams(box_hsize=5, box_vsize=5)
    tp = params_from_dict(dataclasses.asdict(jp))
    ref = _smooth(rng, 1)[0]
    ref_gx = _grads(ref[None])[1]
    src = _grads(_smooth(rng, 1))[:2]                   # (image, gx)
    abc = np.moveaxis(_abc(rng)[1], 0, -1).copy()       # [Hr, Wr, 3]
    want = np.asarray(jrc.rect_window_cost(
        jnp.asarray(ref), jnp.asarray(ref_gx), jnp.asarray(src),
        jnp.asarray(abc), jp, interpret=True))
    got = trc.rect_window_cost(torch.from_numpy(ref), torch.from_numpy(ref_gx),
                               torch.from_numpy(src), torch.from_numpy(abc),
                               tp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


LAYOUTS = {"full": dict(window_grads=False),
           "gfwd": dict(window_grads=False, grad_fwd_pack=True),
           "f32": dict(pack_taps=False)}


def _scene_params(rig, box=5, **kw):
    return JParams(box_hsize=box, box_vsize=box, iterations=1, seed=0,
                   cost_path="rect", **kw).with_depth_range(
                       3.0, 8.0, rig.f, FAKE_BASELINE)


def _images():
    return plane_scene(num_cams=4, h=32, w=48, focal=70.0, plane_depth=5.0,
                       slant=(0.2, -0.1), texture="noise")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_build_rect_scene_layouts_match(monkeypatch, layout):
    monkeypatch.setattr(jrs, "_HAVE_CV2", False)
    images, rig, _, _ = _images()
    jp = _scene_params(rig, **LAYOUTS[layout])
    tp = params_from_dict(dataclasses.asdict(jp))
    js, jinfo = jrs.build_rect_scene(images, rig, [1, 2, 3], jp, 3.0, 8.0)
    ts, tinfo = t_build(images, rig, [1, 2, 3], tp, 3.0, 8.0, device="cpu")
    assert jinfo["pairs"] == tinfo["pairs"]
    assert js.spans.shape == tuple(ts.spans.shape)
    assert str(np.asarray(js.src_rect).dtype) == str(ts.src_rect.dtype
                                                     ).split(".")[-1]
    for f in ("ref_rect", "src_rect", "fwd_c1", "fwd_r", "ret_c1", "ret_r",
              "rot_k", "disp_bounds", "hw_valid", "tile_ok"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    np.testing.assert_allclose(ts.L.numpy(), np.asarray(js.L), rtol=1e-6)


def _candidates(rig, tscene, n_w, d_w, K=3, seed=3):
    """The true plane, a jittered copy and a random plane per pixel."""
    rng = np.random.default_rng(seed)
    h, w2 = tscene.rays.shape[0], tscene.rays.shape[1] // 2
    n_ref = rig.cameras[0].R_orig_inv.T @ n_w
    n = np.broadcast_to(n_ref, (K, h, w2, 3)).astype(np.float32).copy()
    d = np.full((K, h, w2), float(d_w), np.float32)
    n[1] += rng.normal(scale=0.05, size=n[1].shape).astype(np.float32)
    n[2] = rng.normal(size=n[2].shape)
    n[2, ..., 2] = -np.abs(n[2, ..., 2]) - 0.5
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return n.astype(np.float32), d


@pytest.mark.parametrize("layout", ["census", "f32"])
def test_rect_per_view_costs_batch_converted(monkeypatch, layout):
    monkeypatch.setattr(jrs, "_HAVE_CV2", False)
    images, rig, _, (n_w, d_w) = _images()
    kw = (dict(algorithm=JAlg.CENSUS, box=3) if layout == "census"
          else dict(pack_taps=False))
    jp = _scene_params(rig, **kw)
    tp = params_from_dict(dataclasses.asdict(jp))
    js, _ = jrs.build_rect_scene(images, rig, [1, 2, 3], jp, 3.0, 8.0)
    ts = rect_scene_from_numpy(to_numpy_tree(js), device="cpu")
    # convert keeps src_rect's own dtype (int32 words / f32 channels).
    assert ts.src_rect.dtype == (torch.float32 if layout == "f32"
                                 else torch.int32)
    np.testing.assert_array_equal(ts.src_rect.numpy(), np.asarray(js.src_rect))
    n, d = _candidates(rig, ts, n_w, d_w)
    parity = 1
    want = np.asarray(jrc.rect_per_view_costs_batch(
        js, jp, parity, jnp.asarray(n), jnp.asarray(d)))
    got = trc.rect_per_view_costs_batch(ts, tp, parity, torch.from_numpy(n),
                                        torch.from_numpy(d)).numpy()
    assert got.shape == want.shape == (3, 3) + n.shape[1:3]
    if layout == "census":
        assert np.mean(got == want) >= 0.995, np.mean(got == want)
    else:
        np.testing.assert_array_equal(got == MAXCOST, want == MAXCOST)
        live = want < MAXCOST
        assert live.mean() > 0.3
        np.testing.assert_allclose(got[live], want[live], rtol=0, atol=ATOL)
    # The true plane beats the random one at most live pixels.
    live = (want[:, 0] < MAXCOST) & (want[:, 2] < MAXCOST)
    assert np.mean(got[:, 0][live] < got[:, 2][live]) > 0.6
