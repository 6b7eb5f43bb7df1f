"""gipuma_tpu_torch consistency fusion against the JAX package.

Five views of a slanted plane at 32x40: depths from the analytic plane
(utils.synthetic.intersect_plane) with seeded noise, 5% outliers and 5%
zeros, normals with 5% rotated outliers.  Pixels are drawn again until
every compared pair (i, j, p) lies at least 1e-3 from both thresholds and
its projection at least 1e-4 px from a rounding tie (asserted), so the
two packages must keep the same pixels: identical keep masks (read back
through the colours, which carry each pixel's index) and point counts,
points within 1e-4 abs and normals within 1e-5.  An output budget of two
views per chunk gives the cloud of one chunk for all five."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gipuma_tpu.config import FusionParams as JFusionParams
from gipuma_tpu.fusion.fuse import fuse_depthmaps as j_fuse

from gipuma_tpu_torch.config import FusionParams
from gipuma_tpu_torch.fusion import fuse as fuse_mod
from gipuma_tpu_torch.fusion.fuse import fuse_depthmaps as t_fuse
from gipuma_tpu_torch.geometry.camera import FAKE_BASELINE
from gipuma_tpu_torch.utils.synthetic import intersect_plane, make_ring_P

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)
N, H, W, F = 5, 32, 40, 40.0
PARAMS = dict(disp_thresh=0.5, normal_thresh=30.0, num_consistent=2)


def test_port_imports_no_jax():
    """The port never imports JAX or the JAX package (fresh interpreter)."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import gipuma_tpu_torch as g; print(g.foreign_modules())"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def _checks(depths, normals, Ps, p):
    """Per compared pair (i, j, p), in float64: the distance of the
    disparity test to disp_thresh, of the normal test to cos(normal_thresh)
    and of the projection to a rounding tie (pixel centre +- 0.5).
    Returns (the three smallest distances, [N, H, W] bool of the pixels p
    of view i that take part in a pair with a distance under its margin:
    1e-3, 1e-3 and 1e-4 px)."""
    fb = F * FAKE_BASELINE
    cos_t = np.cos(np.radians(p["normal_thresh"]))
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    mins = np.full(3, np.inf)
    close = np.zeros((N, H, W), bool)
    for i in range(N):
        di = depths[i].astype(np.float64)
        M_inv = np.linalg.inv(Ps[i][:, :3])
        X = (np.stack([di * xs, di * ys, di], -1) - Ps[i][:, 3]) @ M_inv.T
        for j in range(N):
            if j == i:
                continue
            q = X @ Ps[j][:, :3].T + Ps[j][:, 3]
            with np.errstate(divide="ignore", invalid="ignore"):
                x, y = q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]
            ins = ((x >= -0.5) & (x <= W - 0.5) & (y >= -0.5)
                   & (y <= H - 0.5) & (q[..., 2] > 0) & (di > 0))
            xi = np.clip(np.round(np.nan_to_num(x)), 0, W - 1).astype(int)
            yi = np.clip(np.round(np.nan_to_num(y)), 0, H - 1).astype(int)
            dj = depths[j][yi, xi].astype(np.float64)
            live = ins & (dj > 0)
            with np.errstate(divide="ignore"):
                m_disp = np.abs(np.abs(fb / dj - fb / q[..., 2])
                                - p["disp_thresh"])
            m_dot = np.abs((normals[i] * normals[j][yi, xi]).sum(-1) - cos_t)
            m_tie = np.minimum(np.abs(x - np.floor(x) - 0.5),
                               np.abs(y - np.floor(y) - 0.5))
            for k, (m, lim, where) in enumerate(
                    ((m_disp, 1e-3, live), (m_dot, 1e-3, live),
                     (m_tie, 1e-4, ins))):
                if where.any():
                    mins[k] = min(mins[k], m[where].min())
                close[i] |= where & (m < lim)
    return mins, close


@pytest.fixture(scope="module")
def maps():
    rng = np.random.default_rng(20)
    Ps = np.stack(make_ring_P(N, H, W, F, target_depth=5.0, radius=1.0))
    n = np.array([0.2, -0.1, 1.0])
    n /= np.linalg.norm(n)
    d = -n @ np.array([0.0, 0.0, 5.0])
    z0 = np.stack([intersect_plane(P, H, W, n, d)[1] for P in Ps])
    side = np.cross(-n, [1.0, 0.0, 0.0])
    side /= np.linalg.norm(side)
    shape = (N, H, W)
    noise, outlier, zero = np.empty(shape), np.empty(shape), np.empty(shape)
    tip, tip_ang = np.empty(shape), np.empty(shape)
    n_noise = np.empty(shape + (3,))

    def draw(m):
        """Draw every random input of the pixels in mask m."""
        k = int(m.sum())
        noise[m] = 1.0 + 1e-4 * rng.standard_normal(k)
        # 5% outliers at 2-3x the depth, 5% zeros (invalid).
        outlier[m] = np.where(rng.uniform(size=k) < 0.05,
                              rng.uniform(2.0, 3.0, k), 1.0)
        zero[m] = rng.uniform(size=k) < 0.05
        n_noise[m] = 0.005 * rng.standard_normal((k, 3))
        # 5% normals tipped by 60-80 degrees.
        tip[m] = rng.uniform(size=k) < 0.05
        tip_ang[m] = np.radians(rng.uniform(60.0, 80.0, k))

    def build():
        z = np.where(zero > 0, 0.0, z0 * noise * outlier).astype(np.float32)
        rot = (np.cos(tip_ang)[..., None] * -n
               + np.sin(tip_ang)[..., None] * side)
        nn = np.where(tip[..., None] > 0, rot, -n + n_noise)
        nn /= np.linalg.norm(nn, axis=-1, keepdims=True)
        return z, nn.astype(np.float32)

    # Redraw the pixels of pairs near a threshold or a rounding tie until
    # none is left: there the two packages may legitimately disagree.
    draw(np.ones(shape, bool))
    for _ in range(50):
        depths, normals = build()
        _, close = _checks(depths, normals, Ps, PARAMS)
        if not close.any():
            break
        draw(close)
    # Colour = the pixel's global index (exact in float32): the fused
    # colours name the kept pixels.
    colors = np.arange(N * H * W, dtype=np.float32).reshape(N, H, W)
    return depths, normals, Ps, colors


def test_inputs_clear_the_thresholds(maps):
    depths, normals, Ps, _ = maps
    (m_disp, m_dot, m_tie), _ = _checks(depths, normals, Ps, PARAMS)
    assert m_disp >= 1e-3 and m_dot >= 1e-3 and m_tie >= 1e-4, (
        m_disp, m_dot, m_tie)
    assert 0.03 < (depths == 0).mean() < 0.07


def test_fuse_matches_jax(maps):
    depths, normals, Ps, colors = maps
    jp, jn, jc = j_fuse(depths, normals, list(Ps), JFusionParams(**PARAMS),
                        colors=colors)
    tp, tn, tc = t_fuse(depths, normals, list(Ps), FusionParams(**PARAMS),
                        colors=colors, device="cpu")
    assert len(tp) == len(jp) > 0.1 * N * H * W
    # The same pixels kept, in the same order.
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tn, np.asarray(jn), rtol=0, atol=1e-5)
    # The greedy marks consumed pixels: fewer points than kept-able pixels.
    assert len(tp) < int((depths > 0).sum())


def test_chunked_output_equals_unchunked(maps, monkeypatch):
    depths, normals, Ps, colors = maps
    a = t_fuse(depths, normals, list(Ps), FusionParams(**PARAMS),
               colors=colors, device="cpu")
    # Room for two views' output per chunk: chunks of 2, 2 and 1 views.
    monkeypatch.setattr(fuse_mod, "OUTPUT_BUDGET_BYTES", 2 * H * W * 28)
    b = t_fuse(depths, normals, list(Ps), FusionParams(**PARAMS),
               colors=colors, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_fuse_defaults_to_the_card(maps):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    depths, normals, Ps, _ = maps
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_fuse(depths, normals, list(Ps), FusionParams(**PARAMS))
