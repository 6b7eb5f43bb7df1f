"""gipuma_tpu_torch.fusion.sharded: view-sharded fusion over k ranks of a
gloo world (CPU) against the JAX package's fuse_depthmaps_sharded on a
k-device mesh and against the port's fuse_depthmaps, on the maps of
tests/test_fusion_sharded.py (tests/test_fusion.make_gt_depthmaps: a
plane seen by a ring of cameras, 32x40, f = 80) with a band of outliers
in view 0, at k in {1, 2, 3} for 5 views (not a multiple of 2 or 3) and
k = 2 for 4 views.  k = 1 runs in this process (no world); k = 2 and 3 are
spawned once each.  Held to: equal point counts, points and normals
within 1e-5, equal colours (each pixel's index, so the same pixels are
kept in the same order), on every rank."""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gipuma_tpu.config import FusionParams as JFusionParams
from gipuma_tpu.fusion.sharded import fuse_depthmaps_sharded as j_fuse_sh
from tests.test_fusion import make_gt_depthmaps

from gipuma_tpu_torch.config import FusionParams
from gipuma_tpu_torch.fusion.fuse import fuse_depthmaps as t_fuse
from gipuma_tpu_torch.fusion.sharded import fuse_depthmaps_sharded
from gipuma_tpu_torch.parallel import launch

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)
PARAMS = dict(disp_thresh=0.5, normal_thresh=30.0, num_consistent=2)
F = 80.0
CASES = [(5, 1), (5, 2), (5, 3), (4, 2)]


def test_port_imports_no_jax():
    """fusion/sharded.py imports neither JAX nor the JAX package (fresh
    interpreter)."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import gipuma_tpu_torch.fusion.sharded, gipuma_tpu_torch as g; "
         "print(g.foreign_modules())"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def _maps(n):
    depths, normals, Ps, _ = make_gt_depthmaps(num_cams=n)
    depths = depths.copy()
    depths[0, 5:10, 5:10] = 2.0          # outliers nobody agrees with
    colors = np.arange(depths.size, dtype=np.float32).reshape(depths.shape)
    return depths, normals, list(Ps), colors


@pytest.fixture(scope="module")
def sharded():
    """{(n, k): the records of every rank} for the spawned worlds."""
    out = {}
    for k in sorted({k for _, k in CASES if k > 1}):
        ns = [n for n, kk in CASES if kk == k]
        tasks = []
        for n in ns:
            depths, normals, Ps, colors = _maps(n)
            tasks.append(dict(kind="fuse", depths=depths, normals=normals,
                              Ps=Ps, params=FusionParams(**PARAMS),
                              mesh=dict(view_shards=k, max_view_shards=k),
                              f=F, colors=colors))
        recs = launch.spawn(launch.run_tasks, k, args=(tasks,), device="cpu",
                            timeout=300)
        for t, n in enumerate(ns):
            out[(n, k)] = [r[t]["result"] for r in recs]
    return out


@pytest.mark.parametrize("n,k", CASES)
def test_sharded_matches_jax_and_single(sharded, n, k):
    depths, normals, Ps, colors = _maps(n)
    if k == 1:
        got = [dict(zip(("points", "normals", "colors"),
                        fuse_depthmaps_sharded(depths, normals, Ps,
                                               FusionParams(**PARAMS), None,
                                               colors=colors, f=F,
                                               device="cpu")))]
    else:
        got = sharded[(n, k)]
    mesh = Mesh(np.asarray(jax.devices()[:k]), axis_names=("view",))
    jp, jn, jc = map(np.asarray, j_fuse_sh(
        depths, normals, Ps, JFusionParams(**PARAMS), mesh, colors=colors,
        f=F))
    tp, tn, tc = t_fuse(depths, normals, Ps, FusionParams(**PARAMS),
                        colors=colors, f=F, device="cpu")
    assert len(jp) > 500
    for g in got:
        for want_p, want_n, want_c in ((jp, jn, jc), (tp, tn, tc)):
            assert g["points"].shape == want_p.shape
            np.testing.assert_array_equal(g["colors"], want_c)
            np.testing.assert_allclose(g["points"], want_p, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(g["normals"], want_n, rtol=1e-5,
                                       atol=1e-5)
