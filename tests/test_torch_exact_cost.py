"""gipuma_tpu_torch exact cost path against the JAX package, on one small
scene (32x40, 3 source views, box 7):

* build_scene(lite=False): geometry fields to 1e-6; the padded reference
  windows and the source views' (image, gx, gy) channels bit-equal (the
  JAX package's block-split copy joined and cropped); convert carries the
  JAX scene across to the same arrays;
* per_view_costs for PM and CENSUS, both parities, to 1e-4 abs (the port
  sums the window terms over the offset axis at once, the JAX package one
  offset at a time; a degenerate PM plane ends at MAXCOST on both sides);
* candidate-batched evaluation equals per-candidate evaluation."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gipuma_tpu.config import AlgorithmParams as JParams
from gipuma_tpu.config import MatchingAlgorithm as JAlg
from gipuma_tpu.geometry.camera import FAKE_BASELINE
from gipuma_tpu.models import scene as jscene
from gipuma_tpu.ops import cost as jcost
from gipuma_tpu.utils.synthetic import plane_scene

from gipuma_tpu_torch.config import MAXCOST
from gipuma_tpu_torch.convert import (params_from_dict, scene_pack_from_numpy,
                                      to_numpy_tree)
from gipuma_tpu_torch.geometry import transforms as T
from gipuma_tpu_torch.models import scene as tscene
from gipuma_tpu_torch.ops import checkerboard as cb
from gipuma_tpu_torch.ops import cost as tcost

# The suite runs under pytest-xdist beside JAX's thread pools; at these
# sizes torch's intra-op threads only oversubscribe the cores.
torch.set_num_threads(1)
H, W = 32, 40


@pytest.fixture(scope="module")
def setup():
    images, rig, _, _ = plane_scene(num_cams=4, h=H, w=W, focal=60.0,
                                    plane_depth=5.0, slant=(0.2, -0.1),
                                    texture="noise")
    jp = JParams(box_hsize=7, box_vsize=7, seed=0).with_depth_range(
        3.0, 8.0, rig.f, FAKE_BASELINE)
    js = jscene.build_scene(images, rig, [1, 2, 3], jp, 3.0, 8.0)
    tp = params_from_dict(dataclasses.asdict(jp))
    ts = tscene.build_scene(images, rig, [1, 2, 3], tp, 3.0, 8.0,
                            lite=False, device="cpu")
    return dict(images=images, rig=rig, jp=jp, tp=tp, js=js, ts=ts)


def _planes(ts, seed, K=None):
    """Random planes facing the camera at depths in [3, 8] (numpy)."""
    rng = np.random.default_rng(seed)
    shape = (H, W) if K is None else (K, H, W)
    n = rng.normal(size=shape + (3,)).astype(np.float32)
    n = T.flip_to_hemisphere(T.normalize(torch.from_numpy(n), eps=1e-20),
                             ts.view_vec)
    depth = torch.from_numpy(rng.uniform(3.0, 8.0, size=shape)
                             .astype(np.float32))
    x, y = T.pixel_grid(H, W)
    d = T.plane_d_at_pixel(ts.M_inv, ts.P_col4, n, x, y, depth)
    return n, d


def test_build_scene_matches(setup):
    js, ts = setup["js"], setup["ts"]
    for f in ts._fields:
        v = getattr(ts, f)
        if f in ("ref_img", "ref_gx", "ref_gy"):
            jv = getattr(js, f)
            assert (v.pr, v.pc, v.h, v.w2) == (jv.pr, jv.pc, jv.h, jv.w2)
            np.testing.assert_array_equal(v.E.numpy(), np.asarray(jv.E))
            np.testing.assert_array_equal(v.O.numpy(), np.asarray(jv.O))
        elif f == "src":
            b = np.asarray(js.src_blocks)                 # [V, NB, 3C, H, 128]
            want = np.moveaxis(b, 1, 3).reshape(
                b.shape[0], b.shape[2], H, -1)[..., :W]
            np.testing.assert_array_equal(v.numpy(), want)
        else:
            np.testing.assert_allclose(v.numpy(), np.asarray(getattr(js, f)),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
    # convert carries the JAX scene across to the same exact-path arrays.
    cs = scene_pack_from_numpy(to_numpy_tree(js), device="cpu")
    assert torch.equal(cs.src, ts.src)
    for f in ("ref_img", "ref_gx", "ref_gy"):
        assert torch.equal(getattr(cs, f).E, getattr(ts, f).E)
        assert torch.equal(getattr(cs, f).O, getattr(ts, f).O)
    padded = tscene.pad_scene_views(ts, 4)
    assert padded.src.shape[0] == 4 and torch.equal(padded.src[3], ts.src[0])


@pytest.mark.parametrize("census", [False, True])
@pytest.mark.parametrize("parity", [0, 1])
def test_per_view_costs_match(setup, census, parity):
    jp, tp, js, ts = setup["jp"], setup["tp"], setup["js"], setup["ts"]
    if census:
        jp = jp.replace(algorithm=JAlg.CENSUS)
        tp = params_from_dict(dataclasses.asdict(jp))
    n, d = _planes(ts, 3 + parity)
    n_a, d_a = cb.extract(n, parity), cb.extract(d, parity).clone()
    if not census:
        # A degenerate plane: NaN samples, the cost ends at MAXCOST.  (Census
        # compares intensity classes and a NaN sample falls in class 1: the
        # JAX package counts those bits when run eagerly but returns MAXCOST
        # under jit; the port follows the eager semantics.)
        d_a[5, 3] = 0.0
    jf = jax.jit(lambda sc, nn, dd: jcost.per_view_costs(sc, jp, parity, nn,
                                                         dd))
    want = np.asarray(jf(js, jnp.asarray(n_a.numpy()),
                         jnp.asarray(d_a.numpy())))
    got = tcost.per_view_costs(ts, tp, parity, n_a, d_a).numpy()
    assert got.shape == want.shape == (3, H, W // 2)
    if not census:
        assert got[:, 5, 3].tolist() == want[:, 5, 3].tolist() == [MAXCOST] * 3
    assert (want < MAXCOST).mean() > 0.9
    np.testing.assert_array_equal(got >= MAXCOST, want >= MAXCOST)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("census", [False, True])
def test_candidate_batch_equals_per_candidate(setup, census):
    ts = setup["ts"]
    tp = setup["tp"]
    if census:
        tp = tp.replace(algorithm=tp.algorithm.CENSUS)
    n, d = _planes(ts, 11, K=3)
    parity = 1
    n_a = torch.stack([cb.extract(n[k], parity) for k in range(3)])
    d_a = torch.stack([cb.extract(d[k], parity) for k in range(3)])
    both = tcost.per_view_costs_batch(ts, tp, parity, n_a, d_a)
    for k in range(3):
        one = tcost.per_view_costs(ts, tp, parity, n_a[k], d_a[k])
        torch.testing.assert_close(both[:, k], one, rtol=0, atol=1e-6)
    mv = tcost.multiview_cost.batch(ts, tp, parity, n_a, d_a)
    torch.testing.assert_close(
        mv[2], tcost.multiview_cost(ts, tp, parity, n_a[2], d_a[2]),
        rtol=0, atol=1e-6)
