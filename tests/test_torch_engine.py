"""gipuma_tpu_torch PatchMatch engine against the JAX package, one sweep
at a time, on a small JAX RectScene and a JAX-initialized state carried
across with gipuma_tpu_torch.convert.

* one close propagation sweep (two-stage cull on, same first-minimum tie
  rule): candidates are copies of neighbouring planes, so the accepted
  planes must be bit-equal on >= 99.5% of the active pixels;
* one refine_batched refinement sweep with the uniforms JAX draws
  (jax.random.split(state.key, 3) -> kz, kn, as patchmatch.py:291-307)
  injected through refinement_sweep(uniforms=...): the candidate planes
  are computed in each framework, so planes agree to rtol 1e-5 on >= 99.5%
  of the active pixels.
Costs agree to 1e-3 abs (the fused-cost tolerance) where planes agree.

And in the port alone: one monolithic iteration on the synthetic scene
passes the JAX package's gate for that variant; save_state / load_state
round-trip a state and its generator continues the same stream."""
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
from gipuma_tpu.geometry.camera import FAKE_BASELINE
from gipuma_tpu.models import patchmatch as jpm
from gipuma_tpu.models.rect_scene import build_rect_scene as j_build
from gipuma_tpu.ops import checkerboard as jcb
from gipuma_tpu.ops.rect_cost import rect_multiview_cost as j_cost
from gipuma_tpu.utils.synthetic import plane_scene

from gipuma_tpu_torch.convert import (params_from_dict, rect_scene_from_numpy,
                                      state_from_numpy, to_numpy_tree)
from gipuma_tpu_torch.models import patchmatch as tpm
from gipuma_tpu_torch.ops.rect_cost import rect_multiview_cost as t_cost
from gipuma_tpu_torch.utils.checkpoint import load_state, save_state

REPO = Path(__file__).resolve().parents[1]

# The suite runs under pytest-xdist beside JAX's thread pools; at these
# sizes torch's intra-op threads only oversubscribe the cores.
torch.set_num_threads(1)
FRAC = 0.995


def test_port_imports_no_jax():
    """The port never imports JAX or the JAX package (fresh interpreter)."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import gipuma_tpu_torch as g; print(g.foreign_modules())"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


@pytest.fixture(scope="module")
def setup():
    images, rig, _, _ = plane_scene(num_cams=4, h=32, w=48, focal=70.0,
                                    plane_depth=5.0, slant=(0.2, -0.1),
                                    texture="noise")
    jp = JParams(box_hsize=7, box_vsize=7, iterations=1, seed=0,
                 cost_path="rect", rect_two_stage_cull=True,
                 cull_view_stride=2).with_depth_range(3.0, 8.0, rig.f,
                                                      FAKE_BASELINE)
    jscene, _ = j_build(images, rig, [1, 2, 3], jp, 3.0, 8.0)
    jinit = jax.jit(lambda sc, k: jpm.init_state(sc, jp, k, cost_fn=j_cost))
    jstate = jinit(jscene, jax.random.PRNGKey(7))
    return dict(jp=jp, jscene=jscene, jstate=jstate,
                tp=params_from_dict(dataclasses.asdict(jp)),
                tscene=rect_scene_from_numpy(to_numpy_tree(jscene),
                                             device="cpu"))


def _compare(jnew, tnew, parity, exact):
    jpl = np.asarray(jcb.extract(jnew.planes, parity))
    tpl = tnew.planes.numpy()
    tpl = np.where(((np.arange(tpl.shape[0])[:, None] + parity) % 2 == 0)
                   [..., None], tpl[:, 0::2], tpl[:, 1::2])
    if exact:
        same = (jpl == tpl).all(-1)
    else:
        same = np.isclose(jpl, tpl, rtol=1e-5, atol=1e-6).all(-1)
    assert same.mean() >= FRAC, f"planes agree on {same.mean():.4f}"
    jc = np.asarray(jcb.extract(jnew.cost, parity))
    tc = np.asarray(jcb.extract(jnp.asarray(tnew.cost.numpy()), parity))
    np.testing.assert_allclose(tc[same], jc[same], rtol=0, atol=1e-3)
    # Pixels of the other parity are untouched by the sweep.
    other = 1 - parity
    np.testing.assert_array_equal(
        np.asarray(jcb.extract(jnew.planes, other)),
        np.asarray(jcb.extract(jnp.asarray(tnew.planes.numpy()), other)))


def test_close_propagation_sweep(setup):
    parity = 0
    jsweep = jax.jit(lambda s, sc: jpm.axial_propagation_sweep(
        s, sc, setup["jp"], parity, 1, cost_fn=j_cost))
    jnew = jsweep(setup["jstate"], setup["jscene"])
    st = state_from_numpy(setup["jstate"].planes, setup["jstate"].cost,
                          device="cpu")
    tnew = tpm.axial_propagation_sweep(st, setup["tscene"], setup["tp"],
                                       parity, 1, t_cost)
    changed = ~np.all(np.asarray(jnew.planes)
                      == np.asarray(setup["jstate"].planes), axis=-1)
    assert changed.sum() > 0, "the sweep accepted nothing"
    _compare(jnew, tnew, parity, exact=True)


def test_refinement_sweep_with_jax_uniforms(setup):
    parity = 1
    jp = setup["jp"]
    js = setup["jstate"]
    jref = jax.jit(lambda s, sc: jpm.refinement_sweep(
        s, sc, jp, parity, cost_fn=j_cost))
    jnew = jref(js, setup["jscene"])
    # The uniforms refinement_sweep draws (patchmatch.py:291-307).
    _, kz, kn = jax.random.split(js.key, 3)
    h, w = js.cost.shape
    R = len(jp.refinement_schedule())
    u = np.array(jax.random.uniform(kz, (R, h, w // 2), jnp.float32))
    u_n = np.array(jax.random.uniform(kn, (R, h, w // 2, 3), jnp.float32))
    st = state_from_numpy(js.planes, js.cost, device="cpu")
    tnew = tpm.refinement_sweep(st, setup["tscene"], setup["tp"], parity,
                                t_cost, uniforms=(torch.from_numpy(u),
                                                  torch.from_numpy(u_n)))
    _compare(jnew, tnew, parity, exact=False)


def test_finalize_matches(setup):
    js = setup["jstate"]
    jd, jn, jc = jpm.finalize(js, setup["jscene"])
    td, tn, tc = tpm.finalize(
        state_from_numpy(js.planes, js.cost, device="cpu"), setup["tscene"])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_monolithic_iteration_quality():
    """Random init plus one iteration of monolithic propagation on the rect
    path, on tests/test_variants.py's scene, meets that file's gate for
    the variant (median rel depth err < 0.02 on [8:-8, 8:-8])."""
    from gipuma_tpu_torch.config import AlgorithmParams
    from gipuma_tpu_torch.models.rect_scene import build_rect_scene
    images, rig, gt, _ = plane_scene(num_cams=4, h=40, w=48, focal=80.0,
                                     plane_depth=5.0)
    tp = AlgorithmParams(box_hsize=7, box_vsize=7, iterations=1,
                         propagation_variant="monolithic", cost_path="rect",
                         rect_two_stage_cull=True, cull_view_stride=2
                         ).with_depth_range(3.0, 8.0, rig.f, FAKE_BASELINE)
    scene, _ = build_rect_scene(images, rig, [1, 2, 3], tp, 3.0, 8.0,
                                device="cpu")
    with torch.no_grad():
        state = tpm.run_patchmatch(scene, tp, tpm.make_generator(0, "cpu"),
                                   t_cost)
        depth = tpm.finalize(state, scene)[0].numpy()
    i = np.s_[8:-8, 8:-8]
    err = np.abs(depth[i] - gt[i]) / gt[i]
    assert np.median(err) < 0.02, np.median(err)


def test_save_load_state_roundtrip(tmp_path):
    rng = np.random.default_rng(12)
    gen = tpm.make_generator(11, "cpu")
    torch.rand(5, generator=gen)               # advance the stream
    st = state_from_numpy(rng.standard_normal((6, 8, 4)),
                          rng.uniform(0, 5, (6, 8)), generator=gen,
                          device="cpu")
    save_state(tmp_path / "s.npz", st)
    back = load_state(tmp_path / "s.npz", device="cpu")
    assert torch.equal(back.planes, st.planes)
    assert torch.equal(back.cost, st.cost)
    assert torch.equal(torch.rand(7, generator=back.gen),
                       torch.rand(7, generator=gen))
    save_state(tmp_path / "n.npz", st._replace(gen=None))
    assert load_state(tmp_path / "n.npz", device="cpu").gen is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_state(tmp_path / "s.npz")
