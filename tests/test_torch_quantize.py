"""gipuma_tpu_torch shape quantization (config.rect_quantize_shapes +
models/rect_scene.ShapeBucketLedger) against the JAX package, on the
scene of tests/test_shape_quantize.py:

* the quantized scene's ``info["shape_bucket"]``, padded shapes and view
  validity equal the JAX package's; the dummy views are invalid and the
  cost loop launches nothing for them (the strided cull slice keeps them
  where the JAX package does);
* the ledger's merged floor across two reference views equals the JAX
  package's, and both views build at identical shapes;
* the port's costs at the real views are bit-equal between the quantized
  and the unquantized scene, per view and combined (K=4, two-stage
  cull), and within 1e-3 of the JAX package's (the fused-cost
  tolerance)."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gipuma_tpu.models.rect_scene as jrs
from gipuma_tpu.config import AlgorithmParams as JParams
from gipuma_tpu.geometry.camera import FAKE_BASELINE
from gipuma_tpu.ops import rect_cost as jrc
from gipuma_tpu.utils.synthetic import plane_scene

from gipuma_tpu_torch.config import MAXCOST
from gipuma_tpu_torch.convert import params_from_dict
from gipuma_tpu_torch.models import rect_scene as trs
from gipuma_tpu_torch.ops import rect_cost as trc

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)
SUBSET = [1, 2, 3, 4]


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
    images, rig, _, (n_w, d_w) = plane_scene(
        num_cams=5, h=48, w=64, focal=100.0, plane_depth=5.0,
        slant=(0.2, -0.1))
    jp = JParams(box_hsize=9, box_vsize=9, iterations=2, n_best=2, seed=0,
                 max_views=6, cost_path="rect", rect_two_stage_cull=True,
                 cull_view_stride=2).with_depth_range(3.0, 8.0, rig.f,
                                                      FAKE_BASELINE)
    jq = jp.replace(rect_quantize_shapes=True, rect_quantum_rows=64,
                    rect_quantum_cols=256, rect_quantum_range=64.0)
    R0 = rig.cameras[0].R_orig_inv.T
    return dict(images=images, rig=rig, jp=jp, jq=jq,
                tp=params_from_dict(dataclasses.asdict(jp)),
                tq=params_from_dict(dataclasses.asdict(jq)),
                n_ref=R0 @ n_w, d_ref=float(d_w))


def _candidates(s, K, seed=0):
    """K candidate planes per active pixel: the true plane and jittered
    copies (numpy)."""
    rng = np.random.default_rng(seed)
    h, w2 = s["images"][0].shape[0], s["images"][0].shape[1] // 2
    n = np.broadcast_to(s["n_ref"], (K, h, w2, 3)).astype(np.float32).copy()
    d = np.full((K, h, w2), s["d_ref"], np.float32)
    n[1:] += rng.normal(scale=0.05, size=n[1:].shape).astype(np.float32)
    d[1:] *= rng.uniform(0.97, 1.03, size=d[1:].shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return n.astype(np.float32), d


def test_shape_bucket_and_dummy_views_match_jax(setup, monkeypatch):
    monkeypatch.setattr(jrs, "_HAVE_CV2", False)
    s = setup
    js, jinfo = jrs.build_rect_scene(s["images"], s["rig"], SUBSET, s["jq"],
                                     3.0, 8.0)
    ts, tinfo = trs.build_rect_scene(s["images"], s["rig"], SUBSET, s["tq"],
                                     3.0, 8.0, device="cpu")
    assert tinfo["shape_bucket"] == jinfo["shape_bucket"]
    assert tinfo["shape_bucket"]["views"] == 6
    assert tinfo["rect_shape_padded"] == tuple(jinfo["rect_shape_padded"])
    assert js.spans.shape == tuple(ts.spans.shape)
    for f in ("ref_rect", "src_rect", "fwd_c1", "fwd_r", "ret_c1", "ret_r",
              "hw_valid", "tile_ok", "fwd2_ok", "ret2_ok"):
        assert tuple(getattr(ts, f).shape) == getattr(js, f).shape, f
    np.testing.assert_array_equal(ts.view_valid.numpy(),
                                  np.asarray(js.view_valid))
    assert ts.valid_views() == (True,) * 4 + (False,) * 2
    np.testing.assert_array_equal(ts.hw_valid.numpy()[4:],
                                  [[0, 128], [0, 128]])
    assert int(ts.tile_ok[4:].sum()) == 0
    # The cull pass's strided slice keeps the dummies where JAX does.
    jsl, tsl = jrc._slice_views(js, 2), trc._slice_views(ts, 2)
    np.testing.assert_array_equal(tsl.view_valid.numpy(),
                                  np.asarray(jsl.view_valid))
    assert tsl.valid_views() == tuple(
        bool(v) for v in np.asarray(jsl.view_valid))


def test_ledger_floor_matches_jax(setup, monkeypatch):
    monkeypatch.setattr(jrs, "_HAVE_CV2", False)
    s = setup
    jq = s["jp"].replace(rect_quantize_shapes=True)
    tq = params_from_dict(dataclasses.asdict(jq))
    jl, tl = jrs.ShapeBucketLedger(), trs.ShapeBucketLedger()
    got = []
    for sub in (SUBSET, [2, 3]):
        _, ji = jrs.build_rect_scene(s["images"], s["rig"], sub, jq, 3.0,
                                     8.0, ledger=jl)
        ts, ti = trs.build_rect_scene(s["images"], s["rig"], sub, tq, 3.0,
                                      8.0, ledger=tl, device="cpu")
        assert ti["shape_bucket"] == ji["shape_bucket"]
        got.append(ts)
    # The JAX ledger keys by (h, w, rect_scale); the port's by (h, w, 1.0).
    assert list(tl._m.values()) == list(jl._m.values())
    a, b = got
    for f in ("ref_rect", "src_rect", "L", "fwd_c1", "fwd_r", "ret_c1",
              "ret_r", "rot_k", "disp_bounds", "spans", "hw_valid",
              "tile_ok", "fwd2_ok", "ret2_ok"):
        assert getattr(a, f).shape == getattr(b, f).shape, f
    assert a.view_valid.shape == b.view_valid.shape


def test_quantized_costs_bit_equal_and_match_jax(setup, monkeypatch):
    monkeypatch.setattr(jrs, "_HAVE_CV2", False)
    s = setup
    t0, _ = trs.build_rect_scene(s["images"], s["rig"], SUBSET, s["tp"],
                                 3.0, 8.0, device="cpu")
    t1, _ = trs.build_rect_scene(s["images"], s["rig"], SUBSET, s["tq"],
                                 3.0, 8.0, device="cpu")
    n, d = _candidates(s, 4)
    tn, td = torch.from_numpy(n), torch.from_numpy(d)
    parity = 0
    pv0 = trc.rect_per_view_costs_batch(t0, s["tp"], parity, tn, td)
    # The dummy views do no work: two permutes and one window cost per
    # real view only.
    calls = {"permute2d": 0, "rect_pair_cost_batch": 0}
    with monkeypatch.context() as m:
        for name in calls:
            def counted(*a, _fn=getattr(trc, name), _name=name, **k):
                calls[_name] += 1
                return _fn(*a, **k)
            m.setattr(trc, name, counted)
        pv1 = trc.rect_per_view_costs_batch(t1, s["tq"], parity, tn, td)
    assert calls == {"permute2d": 8, "rect_pair_cost_batch": 4}
    assert pv1.shape[0] == 6
    np.testing.assert_array_equal(pv1[:4].numpy(), pv0.numpy())
    assert bool((pv1[4:] == MAXCOST).all())
    c0 = trc.rect_multiview_cost_batch(t0, s["tp"], parity, tn, td).numpy()
    c1 = trc.rect_multiview_cost_batch(t1, s["tq"], parity, tn, td).numpy()
    np.testing.assert_array_equal(c1, c0)
    # Against the JAX package, one candidate (its interpret-mode kernels
    # take seconds per evaluation here): the JAX cost of the unquantized
    # scene, which tests/test_shape_quantize.py holds bit-equal to its
    # quantized one.
    js, _ = jrs.build_rect_scene(s["images"], s["rig"], SUBSET, s["jp"],
                                 3.0, 8.0)
    jfn = jax.jit(jrc.rect_multiview_cost, static_argnums=(1, 2))
    want = np.asarray(jfn(js, s["jp"], parity, jnp.asarray(n[0]),
                          jnp.asarray(d[0])))
    got = trc.rect_multiview_cost(t1, s["tq"], parity, tn[0], td[0]).numpy()
    np.testing.assert_array_equal(got == MAXCOST, want == MAXCOST)
    live = want < MAXCOST
    assert live.sum() > 0.5 * live.size
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-3)
