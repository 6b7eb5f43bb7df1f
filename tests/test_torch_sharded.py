"""gipuma_tpu_torch.parallel.sharded: view- and job-sharded PatchMatch on a
4-rank gloo world (spawned once for the file, CPU), on the scene of
tests/test_rect_sharding.py (6 cameras at 32x40, views 1-5, box 7, one
iteration):

* rect and exact, views over 4 ranks (5 views padded to 8), against the
  port's single-process run from the same seed, every run on the JAX
  package's scenes carried across by convert: cost within 1e-5, planes
  within 1e-4 (the tolerances of tests/test_sharding.py; the runs are in
  fact bit-equal: the gathered per-view costs are the stacked ones);
* job x view 2 x 2 on the exact path: each job equals its single run;
* 5 views padded to 6 over 2 view ranks: padding changes nothing;
* the combined cost of seeded candidates (4 on the exact path, 1 on the
  rect path, whose interpret-mode kernels make the JAX compile grow with
  every candidate) through the port's view_sharded_cost_fn (batch and single
  forms), against the JAX package's view_sharded_cost_fn under shard_map
  on its 8-device CPU mesh (view 4), both on the JAX scene carried across
  by convert: within 1e-5 on the exact path, 1e-3 on the rect path
  (KERNEL_EQUIV's window-cost tolerance)."""
import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as JP

from gipuma_tpu.config import AlgorithmParams as JParams
from gipuma_tpu.geometry.camera import FAKE_BASELINE
from gipuma_tpu.models import rect_scene as jrs
from gipuma_tpu.models import scene as jscene
from gipuma_tpu.parallel import mesh as jmesh
from gipuma_tpu.parallel import sharded as jsh
from gipuma_tpu.utils.synthetic import plane_scene

from gipuma_tpu_torch.convert import params_from_dict, to_numpy_tree
from gipuma_tpu_torch.models.patchmatch import make_generator, run_patchmatch
from gipuma_tpu_torch.ops.cost import multiview_cost
from gipuma_tpu_torch.ops.rect_cost import rect_multiview_cost
from gipuma_tpu_torch.parallel import launch

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)
VIEWS = [1, 2, 3, 4, 5]
K = {"exact": 4, "rect": 1}


def test_port_imports_no_jax():
    """The parallel layer imports neither JAX nor the JAX package (fresh
    interpreter)."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import gipuma_tpu_torch.parallel.sharded, "
         "gipuma_tpu_torch.parallel.launch, gipuma_tpu_torch as g; "
         "print(g.foreign_modules())"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def _candidates(K, h, w, seed):
    """K seeded plane candidates facing the camera, [K, H, W2, 3] / [K, H,
    W2]: normals near -z, plane offsets in [3, 8]."""
    rng = np.random.default_rng(seed)
    n = np.stack([rng.normal(0, 0.2, (K, h, w // 2)),
                  rng.normal(0, 0.2, (K, h, w // 2)),
                  -np.ones((K, h, w // 2))], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.uniform(3.0, 8.0, (K, h, w // 2))
    return n.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    images, rig, _, _ = plane_scene(num_cams=6, h=32, w=40, focal=70.0)
    jp = JParams(box_hsize=7, box_vsize=7, iterations=1,
                 cost_path="rect").with_depth_range(3.0, 8.0, rig.f,
                                                    FAKE_BASELINE)
    tp = params_from_dict(dataclasses.asdict(jp))
    tpe = tp.replace(cost_path="exact")
    # The JAX package's scenes, carried across: every run and cost of the
    # file starts from the same inputs.
    jr, _ = jrs.build_rect_scene(images, rig, VIEWS, jp, 3.0, 8.0)
    je = jscene.build_scene(images, rig, VIEWS, jp.replace(cost_path="exact"),
                            3.0, 8.0)
    rect = dict(tree=to_numpy_tree(jr), rect=True)
    exact = dict(tree=to_numpy_tree(je), rect=False)
    cand = {p: _candidates(k, 32, 40, 7) for p, k in K.items()}
    tasks = [
        dict(kind="view", scene=rect, params=tp, mesh=dict(view_shards=4)),
        dict(kind="view", scene=exact, params=tpe, mesh=dict(view_shards=4)),
        dict(kind="batch", scenes=[exact, exact], params=tpe,
             mesh=dict(view_shards=2), seeds=[5, 6]),
        dict(kind="view", scene=exact, params=tpe, mesh=dict(view_shards=2),
             seed=2),
        dict(kind="cost", scene=exact, params=tpe, mesh=dict(view_shards=4),
             parity=1, n=cand["exact"][0], d=cand["exact"][1]),
        dict(kind="cost", scene=rect, params=tp, mesh=dict(view_shards=4),
             parity=0, n=cand["rect"][0], d=cand["rect"][1]),
    ]
    recs = launch.spawn(launch.run_tasks, 4, args=(tasks,), device="cpu",
                        timeout=600)
    return dict(recs=recs, rect=rect, exact=exact, tp=tp, tpe=tpe, jp=jp,
                jr=jr, je=je, cand=cand)


def _single(spec, params, seed, cost_fn):
    scene = launch.build(spec, "cpu")[0]
    with torch.no_grad():
        return run_patchmatch(scene, params, make_generator(seed, "cpu"),
                              cost_fn=cost_fn)


def _results(setup, t):
    """Task t's results on every rank (the ranks of a view group agree)."""
    return [r[t]["result"] for r in setup["recs"]]


@pytest.mark.parametrize("path", ["rect", "exact"])
def test_view_sharded_matches_single(setup, path):
    t, params, cost_fn = ((0, setup["tp"], rect_multiview_cost)
                          if path == "rect"
                          else (1, setup["tpe"], multiview_cost))
    ref = _single(setup[path], params, params.seed, cost_fn)
    for got in _results(setup, t):
        np.testing.assert_allclose(got["cost"], ref.cost.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["planes"], ref.planes.numpy(),
                                   rtol=1e-4, atol=1e-5)
    # Every rank took part: 8 evaluations + the view_valid gather.
    for rec in setup["recs"]:
        assert rec[t]["collectives"]["calls"] >= 9


def test_batch_sharded_matches_single(setup):
    for got in _results(setup, 2):
        assert got["cost"].shape[0] == 2
        for j, seed in enumerate((5, 6)):
            ref = _single(setup["exact"], setup["tpe"], seed, multiview_cost)
            np.testing.assert_allclose(got["cost"][j], ref.cost.numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_view_padding_is_neutral(setup):
    """5 views over 2 view ranks pad to 6; the padded view changes
    nothing."""
    ref = _single(setup["exact"], setup["tpe"], 2, multiview_cost)
    for got in _results(setup, 3):
        np.testing.assert_allclose(got["cost"], ref.cost.numpy(),
                                   rtol=1e-5, atol=1e-5)


def _jax_cost(setup, rect, parity):
    """The JAX package's view_sharded_cost_fn under shard_map on its
    8-device CPU mesh (job 2 x view 4) for the candidates."""
    n, d = setup["cand"]["rect" if rect else "exact"]
    mesh = jmesh.make_mesh(8, view_shards=4)
    if rect:
        scene = jsh.pad_rect_scene_views(setup["jr"]._replace(cull=None), 4)
        params = setup["jp"]
    else:
        scene = jscene.pad_scene_views(setup["je"], 4)
        params = setup["jp"].replace(cost_path="exact")
    specs = jsh._scene_specs(scene, batched=False)
    cost_fn = jsh.view_sharded_cost_fn(rect=rect)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(specs, JP(), JP()),
                       out_specs=JP(), check_vma=False)
    def fn(sc, n, d):
        if rect:
            return cost_fn.batch(sc, params, parity, n, d)
        return jnp.stack([cost_fn(sc, params, parity, n[k], d[k])
                          for k in range(n.shape[0])])

    return np.asarray(fn(scene, jnp.asarray(n), jnp.asarray(d)))


@pytest.mark.parametrize("path,tol", [("exact", 1e-5), ("rect", 1e-3)])
def test_cost_fn_matches_jax(setup, path, tol):
    rect = path == "rect"
    t, parity = (5, 0) if rect else (4, 1)
    want = _jax_cost(setup, rect, parity)
    assert want.shape == (K[path], 32, 20)
    for got in _results(setup, t):
        np.testing.assert_allclose(got["batch"], want, rtol=tol, atol=tol)
        np.testing.assert_allclose(got["single"], want, rtol=tol, atol=tol)
