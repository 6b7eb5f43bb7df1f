"""gipuma_tpu_torch PatchMatch engine on the exact cost path against the
JAX package, one sweep at a time (32x40, 3 source views, box 7), from the
same state carried across with gipuma_tpu_torch.convert:

* one close propagation sweep: the port evaluates the four candidates in
  one batch, the JAX package one candidate after another (lax.map); the
  candidates are copies of neighbouring planes, so accepted planes are
  bit-equal on >= 99.5% of the active pixels;
* one sequential refinement sweep (the exact cost has no batched
  refinement in either package, whatever refine_batched says) fed the JAX
  package's per-round draws (patchmatch.py:336-357): planes agree to rtol
  1e-5 on >= 99.5% of the active pixels;
* one monolithic propagation sweep (MONOLITHIC_OFFSETS, 20 candidates):
  as the close sweep;
costs agree to 1e-4 abs where planes agree.

And, in the port alone: on the rect path, refine_batched=False runs the
same sequential rounds; with one round they equal the batched sweep."""
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
from gipuma_tpu.ops import checkerboard as jcb
from gipuma_tpu.ops.cost import multiview_cost as j_cost
from gipuma_tpu.utils.synthetic import plane_scene

from gipuma_tpu_torch.convert import (params_from_dict, scene_pack_from_numpy,
                                      state_from_numpy, to_numpy_tree)
from gipuma_tpu_torch.geometry import transforms as T
from gipuma_tpu_torch.models import patchmatch as tpm
from gipuma_tpu_torch.models.rect_scene import build_rect_scene
from gipuma_tpu_torch.ops import checkerboard as cb
from gipuma_tpu_torch.ops.cost import multiview_cost as t_cost
from gipuma_tpu_torch.ops.rect_cost import rect_multiview_cost

# The suite runs under pytest-xdist beside JAX's thread pools; at these
# sizes torch's intra-op threads only oversubscribe the cores.
torch.set_num_threads(1)
FRAC = 0.995
H, W = 32, 40


def _random_state(scene, params, seed):
    """Random planes facing the camera at depths in [3, 8], with their
    port-evaluated costs (the same state goes to both engines)."""
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(H, W, 3)).astype(np.float32)
    n = T.flip_to_hemisphere(T.normalize(torch.from_numpy(n), eps=1e-20),
                             scene.view_vec)
    depth = torch.from_numpy(rng.uniform(3.0, 8.0, size=(H, W))
                             .astype(np.float32))
    x, y = T.pixel_grid(H, W)
    d = T.plane_d_at_pixel(scene.M_inv, scene.P_col4, n, x, y, depth)
    cost = torch.zeros((H, W))
    for parity in (0, 1):
        cost = cb.interleave(cost, t_cost(scene, params, parity,
                                          cb.extract(n, parity),
                                          cb.extract(d, parity)), parity)
    return torch.cat([n, d[..., None]], -1).numpy(), cost.numpy()


@pytest.fixture(scope="module")
def setup():
    images, rig, _, _ = plane_scene(num_cams=4, h=H, w=W, focal=60.0,
                                    plane_depth=5.0, slant=(0.2, -0.1),
                                    texture="noise")
    jp = JParams(box_hsize=7, box_vsize=7, seed=0).with_depth_range(
        3.0, 8.0, rig.f, FAKE_BASELINE)
    js = jscene.build_scene(images, rig, [1, 2, 3], jp, 3.0, 8.0)
    tp = params_from_dict(dataclasses.asdict(jp))
    ts = scene_pack_from_numpy(to_numpy_tree(js), device="cpu")
    planes, cost = _random_state(ts, tp, 21)
    jstate = jpm.PMState(planes=jnp.asarray(planes), cost=jnp.asarray(cost),
                         key=jax.random.PRNGKey(3))
    return dict(images=images, rig=rig, jp=jp, tp=tp, js=js, ts=ts,
                planes=planes, cost=cost, jstate=jstate)


def _compare(jnew, tnew, parity, exact):
    jpl = np.asarray(jcb.extract(jnew.planes, parity))
    tpl = cb.extract(tnew.planes, parity).numpy()
    if exact:
        same = (jpl == tpl).all(-1)
    else:
        same = np.isclose(jpl, tpl, rtol=1e-5, atol=1e-6).all(-1)
    assert same.mean() >= FRAC, f"planes agree on {same.mean():.4f}"
    jc = np.asarray(jcb.extract(jnew.cost, parity))
    tc = cb.extract(tnew.cost, parity).numpy()
    np.testing.assert_allclose(tc[same], jc[same], rtol=0, atol=1e-4)
    other = 1 - parity
    np.testing.assert_array_equal(np.asarray(jcb.extract(jnew.planes, other)),
                                  cb.extract(tnew.planes, other).numpy())


def test_close_propagation_sweep(setup):
    parity = 0
    jp = setup["jp"]
    jsweep = jax.jit(lambda s, sc: jpm.axial_propagation_sweep(
        s, sc, jp, parity, 1, cost_fn=j_cost))
    jnew = jsweep(setup["jstate"], setup["js"])
    tnew = tpm.axial_propagation_sweep(
        state_from_numpy(setup["planes"], setup["cost"], device="cpu"),
        setup["ts"],
        setup["tp"], parity, 1, t_cost)
    changed = ~np.all(np.asarray(jnew.planes) == setup["planes"], axis=-1)
    assert changed.mean() > 0.05, "the sweep accepted too little"
    _compare(jnew, tnew, parity, exact=True)


def test_monolithic_propagation_sweep(setup):
    """propagation_sweep over MONOLITHIC_OFFSETS (20 candidates, the
    reference's gipuma_checkerboard_cu order) against the JAX sweep, from
    the injected state; the same equality as the close sweep.  (On the
    rect path the JAX sweep takes minutes in interpret mode here; the
    engine code is the same for both costs.)"""
    parity = 1
    jp = setup["jp"]
    assert tpm.MONOLITHIC_OFFSETS == jpm.MONOLITHIC_OFFSETS
    jsweep = jax.jit(lambda s, sc: jpm.propagation_sweep(
        s, sc, jp, parity, jpm.MONOLITHIC_OFFSETS, cost_fn=j_cost))
    jnew = jsweep(setup["jstate"], setup["js"])
    tnew = tpm.propagation_sweep(
        state_from_numpy(setup["planes"], setup["cost"], device="cpu"),
        setup["ts"], setup["tp"], parity, tpm.MONOLITHIC_OFFSETS, t_cost)
    changed = ~np.all(np.asarray(jnew.planes) == setup["planes"], axis=-1)
    assert changed.mean() > 0.05, "the sweep accepted too little"
    _compare(jnew, tnew, parity, exact=True)


@pytest.mark.parametrize("refine_batched", [True, False])
def test_sequential_refinement_with_jax_draws(setup, refine_batched):
    parity = 1
    jp = setup["jp"].replace(refine_batched=refine_batched)
    js = setup["jstate"]
    jref = jax.jit(lambda s, sc: jpm.refinement_sweep(s, sc, jp, parity,
                                                      cost_fn=j_cost))
    jnew = jref(js, setup["js"])
    # The per-round draws of the JAX package's sequential rounds
    # (patchmatch.py:336-357).
    R = len(jp.refinement_schedule())
    keys = jax.random.split(js.key, 2 * R + 1)[1:].reshape(R, 2, -1)
    u = np.stack([np.asarray(jax.random.uniform(keys[r, 0], (H, W // 2)))
                  for r in range(R)])
    u_n = np.stack([np.asarray(jax.random.uniform(keys[r, 1],
                                                  (H, W // 2, 3)))
                    for r in range(R)])
    tnew = tpm.refinement_sweep(
        state_from_numpy(setup["planes"], setup["cost"], device="cpu"),
        setup["ts"],
        params_from_dict(dataclasses.asdict(jp)), parity, t_cost,
        uniforms=(torch.from_numpy(u), torch.from_numpy(u_n)))
    changed = ~np.all(np.asarray(jnew.planes) == setup["planes"], axis=-1)
    assert changed.mean() > 0.05, "the sweep accepted too little"
    _compare(jnew, tnew, parity, exact=False)


def test_rect_sequential_refinement(setup):
    """refine_batched=False on the rect path runs the sequential rounds
    (one rect evaluation per round); with a single round it computes
    exactly what the batched sweep computes."""
    tp = setup["tp"].replace(cost_path="rect", rect_two_stage_cull=True,
                             cull_view_stride=2, refine_rounds_cap=1)
    rs, _ = build_rect_scene(setup["images"], setup["rig"], [1, 2, 3], tp,
                             3.0, 8.0, device="cpu")
    planes, _ = _random_state(setup["ts"], setup["tp"], 5)
    st = state_from_numpy(planes, np.zeros((H, W), np.float32),
                          device="cpu")
    st = st._replace(cost=tpm.init_state(rs, tp, tpm.make_generator(0, "cpu"),
                                         rect_multiview_cost).cost)
    rng = np.random.default_rng(8)
    uni = (torch.from_numpy(rng.random((1, H, W // 2), np.float32)),
           torch.from_numpy(rng.random((1, H, W // 2, 3), np.float32)))
    parity = 0
    seq = tpm.refinement_sweep(st, rs, tp.replace(refine_batched=False),
                               parity, rect_multiview_cost, uniforms=uni)
    bat = tpm.refinement_sweep(st, rs, tp, parity, rect_multiview_cost,
                               uniforms=uni)
    assert torch.equal(seq.planes, bat.planes)
    assert torch.equal(seq.cost, bat.cost)
    assert not torch.equal(seq.planes, st.planes)
