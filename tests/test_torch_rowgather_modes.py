"""gipuma_tpu_torch lerp row gather (f32, PACKED, GFWD) and affine row
gather against the JAX package's Pallas kernels in interpret mode (full
block scan, max_span_blocks=None), on identical numpy inputs.

Shapes: H not a multiple of 32, Ws not a multiple of 128, K <= 2, E <= 5;
positions include NaN and points 20 px outside [0, W-1].  Tolerance: 1e-4
abs on 0-255 data (XLA contracts the lerp's products and sums into FMAs in
interpret mode; the port rounds each on its own), and NaN exactly where
the JAX kernel gives NaN.  The affine gather reads a smooth source (at
most 3 per pixel): XLA also contracts a*x + b*y + c there, which moves a
position by an ulp of the disparity, and that must stay below 1e-4 of the
sample.  ``src_dy`` (the port's in-gather row shift) is held against the
JAX call on the shifted source, and so is each row of the many-row
gather."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gipuma_tpu.ops import pallas_rowgather as jrg

from gipuma_tpu_torch.ops import rowgather as trg

# The suite runs under pytest-xdist beside JAX's thread pools; at these
# sizes torch's intra-op threads only oversubscribe the cores.
torch.set_num_threads(1)
ATOL = 1e-4
C, H, W, WS = 2, 20, 128, 72


@pytest.fixture
def rng():
    """A fresh generator per test: inputs do not depend on test order."""
    return np.random.default_rng(4321)


def _positions(rng, B):
    x = rng.uniform(-20.0, W + 19.0, size=(B, H, WS)).astype(np.float32)
    x[:, 0, :6] = [np.nan, -20.0, W - 1 + 20.0, 0.0, W - 1.0, W - 1.5]
    x[:, 3, 7] = np.nan
    return x


def _shifted(src, dy):
    rows = np.clip(np.arange(src.shape[1]) + dy, 0, src.shape[1] - 1)
    return src[:, rows]


def _close(got, want):
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=0, atol=ATOL)


def _source(rng, mode):
    img = rng.uniform(0.0, 255.0, size=(C, H, W)).astype(np.float32)
    return img if mode == "f32" else trg.pack_taps(img)


def _smooth_packed(rng, c):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    ph = rng.uniform(0, 6, size=(c, 1, 1)).astype(np.float32)
    img = 120.0 + 60.0 * np.sin(xx / 20.0 + ph) * np.cos(yy / 7.0)
    return trg.pack_taps(img.astype(np.float32))


@pytest.mark.parametrize("src_dy", [0, -3])
@pytest.mark.parametrize("mode", ["f32", "packed", "gfwd"])
def test_row_gather_lerp_modes(rng, mode, src_dy):
    src = _source(rng, mode)
    x = _positions(rng, 2)
    gfwd = mode == "gfwd"
    want = np.asarray(jrg.row_gather_batch(
        jnp.asarray(_shifted(src, src_dy)), jnp.asarray(x), interpret=True,
        max_span_blocks=None, grad_fwd=gfwd))
    got = trg.row_gather_batch(torch.from_numpy(src), torch.from_numpy(x),
                               grad_fwd=gfwd, src_dy=src_dy).numpy()
    assert got.shape == (2, 3 if gfwd else C, H, WS)
    _close(got, want)
    # A NaN position gives NaN samples (gx = 2*(v1 - v0) of GFWD does not
    # depend on the position's fraction); rows without NaN are finite.
    assert np.isnan(got[:, 0, 0, 0]).all() and np.isfinite(got[:, :, 1]).all()


def test_row_gather_single_grid(rng):
    src = _source(rng, "packed")
    x = _positions(rng, 1)[0]
    want = np.asarray(jrg.row_gather(jnp.asarray(src), jnp.asarray(x),
                                     interpret=True))
    _close(trg.row_gather(torch.from_numpy(src), torch.from_numpy(x)).numpy(),
           want)


def _abc(rng, K):
    abc = np.empty((K, 3, H, WS), np.float32)
    abc[:, 0] = rng.uniform(-0.3, 0.3, size=(K, H, WS))
    abc[:, 1] = rng.uniform(-0.2, 0.2, size=(K, H, WS))
    abc[:, 2] = rng.uniform(-30.0, 60.0, size=(K, H, WS))
    abc[0, 2, 0, :3] = [np.nan, 400.0, -400.0]   # NaN plane; positions far
    abc[-1, 0, 5, 9] = np.inf                    # outside [0, W-1]
    return abc


@pytest.mark.parametrize("K,c,dxs,dy,bounds", [
    (2, 1, (-2, -1, 0, 1, 2), 0.0, (-10.0, 40.0)),
    (1, 2, (-4, 0, 4), 3.0, (-1e9, 1e9)),
    (2, 2, (0,), -2.0, (5.0, 25.0)),
])
def test_row_gather_affine(rng, K, c, dxs, dy, bounds):
    src = _smooth_packed(rng, c)
    abc = _abc(rng, K)
    want = np.asarray(jrg.row_gather_affine(
        jnp.asarray(_shifted(src, int(dy))), jnp.asarray(abc), dxs,
        jnp.float32(dy), jnp.float32(bounds[0]), jnp.float32(bounds[1]),
        interpret=True, max_span_blocks=None))
    got = trg.row_gather_affine(torch.from_numpy(src), torch.from_numpy(abc),
                                dxs, dy, bounds[0], bounds[1],
                                src_dy=int(dy)).numpy()
    assert got.shape == (K * len(dxs), c, H, WS)
    _close(got, want)
    assert np.isnan(got[:len(dxs), :, 0, 0]).all()


@pytest.mark.parametrize("K,c,dxs,dys,bounds", [
    (2, 1, (-2, -1, 0, 1, 2), (-3, 0, 2), (-10.0, 40.0)),
    (1, 2, (-4, 0, 4), (5, -1), (-1e9, 1e9)),
])
def test_row_gather_affine_rows(rng, K, c, dxs, dys, bounds):
    """The many-row gather (its plain version on the CPU): row r is the JAX
    row_gather_affine at dy = dys[r] on the source shifted by dys[r]."""
    src = _smooth_packed(rng, c)
    abc = _abc(rng, K)
    got = trg.row_gather_affine_rows(torch.from_numpy(src),
                                     torch.from_numpy(abc), dxs, dys,
                                     torch.tensor(bounds)).numpy()
    assert got.shape == (len(dys), K * len(dxs), c, H, WS)
    for r, dy in enumerate(dys):
        want = np.asarray(jrg.row_gather_affine(
            jnp.asarray(_shifted(src, dy)), jnp.asarray(abc), dxs,
            jnp.float32(dy), jnp.float32(bounds[0]), jnp.float32(bounds[1]),
            interpret=True, max_span_blocks=None))
        _close(got[r], want)


def test_row_gather_affine_device_bounds(rng):
    """The disparity clamp given as a float32 [2] tensor (the scene's
    disp_bounds row) is the same clamp as two floats."""
    src = torch.from_numpy(_source(rng, "packed"))
    abc = torch.from_numpy(_abc(rng, 2))
    a = trg.row_gather_affine(src, abc, (-1, 0, 1), 1.0, -5.0, 30.0)
    b = trg.row_gather_affine(src, abc, (-1, 0, 1), 1.0,
                              disp_bounds=torch.tensor([-5.0, 30.0]))
    assert torch.equal(a.nan_to_num(-1.0), b.nan_to_num(-1.0))


def test_lerp_rejects_a_tile_mask(rng):
    """The tile mask is a NEAREST option (the permute passes), as in the
    JAX callers."""
    src = torch.from_numpy(_source(rng, "f32"))
    x = torch.from_numpy(_positions(rng, 1))
    with pytest.raises(ValueError, match="NEAREST"):
        trg.row_gather_batch(src, x, tile_ok=torch.ones((3, 1),
                                                        dtype=torch.int32))
