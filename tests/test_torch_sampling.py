"""gipuma_tpu_torch sampler against the JAX package.

* bilinear_sample_plain vs JAX's bilinear_sample (the XLA gather) and
  bilinear_sample_chw(interpret=True) (the Pallas sampler in interpret
  mode), at 48x128 with C in {1, 3} and coordinates up to 20 px outside
  the image: within 1e-6 (the two frameworks may round the lerp's products
  apart by an ulp);
* central_gradients bit-equal;
* the dispatching bilinear_sample runs the plain version on a CPU tensor,
  and the kernel's wrapper refuses a CPU tensor instead of falling back;
* the kernel's route rule by the number of position rows B, and the
  refusal of a route the kernel does not have."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gipuma_tpu.ops.pallas_sampling import bilinear_sample_chw
from gipuma_tpu.ops.sampling import bilinear_sample as j_sample
from gipuma_tpu.ops.sampling import central_gradients as j_grads

from gipuma_tpu_torch.ops import sampling as ts

# The suite runs under pytest-xdist beside JAX's thread pools; at these
# sizes torch's intra-op threads only oversubscribe the cores.
torch.set_num_threads(1)


def _inputs(seed, C, H=48, W=128, Hs=40, Ws=200):
    rng = np.random.default_rng(seed)
    src = rng.random((H, W, C)).astype(np.float32)
    x = (rng.random((Hs, Ws)) * (W + 40) - 20).astype(np.float32)
    y = (rng.random((Hs, Ws)) * (H + 40) - 20).astype(np.float32)
    return src, x, y


@pytest.mark.parametrize("C", [1, 3])
def test_plain_sampler_matches_jax(C):
    src, x, y = _inputs(C, C)
    want = np.asarray(j_sample(jnp.asarray(src), jnp.asarray(x),
                               jnp.asarray(y)))                # [Hs, Ws, C]
    got = ts.bilinear_sample_plain(
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(src, -1, 0))),
        torch.from_numpy(x)[None], torch.from_numpy(y)[None])[0]
    got = np.moveaxis(got.numpy(), 0, -1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("C", [1, 3])
def test_plain_sampler_matches_pallas_interpret(C):
    src, x, y = _inputs(10 + C, C)
    src_chw = np.ascontiguousarray(np.moveaxis(src, -1, 0))
    want = np.asarray(bilinear_sample_chw(jnp.asarray(src_chw),
                                          jnp.asarray(x), jnp.asarray(y),
                                          interpret=True))     # [Hs, Ws, C]
    got = ts.bilinear_sample(torch.from_numpy(src_chw),
                             torch.from_numpy(x)[None],
                             torch.from_numpy(y)[None])[0]
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 0, -1), want,
                               rtol=0, atol=1e-6)


def test_sampler_batch_and_nan():
    """A leading batch axis samples each grid on its own; NaN coordinates
    give NaN samples (jnp.clip passes NaN), so degenerate planes still end
    as MAXCOST."""
    src, x, y = _inputs(3, 3, Hs=8, Ws=16)
    src_t = torch.from_numpy(np.ascontiguousarray(np.moveaxis(src, -1, 0)))
    xb = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    yb = torch.from_numpy(np.stack([y, y[:, ::-1].copy()]))
    both = ts.bilinear_sample_plain(src_t, xb, yb)
    for b in range(2):
        one = ts.bilinear_sample_plain(src_t, xb[b:b + 1], yb[b:b + 1])[0]
        assert torch.equal(both[b], one)
    xn = xb.clone()
    xn[0, 0, 0] = float("nan")
    out = ts.bilinear_sample_plain(src_t, xn, yb)
    assert torch.isnan(out[0, :, 0, 0]).all()
    assert torch.isfinite(out[1]).all()


def test_central_gradients_bitwise():
    rng = np.random.default_rng(5)
    img = (rng.random((3, 24, 34)) * 255).astype(np.float32)
    jgx, jgy = j_grads(jnp.asarray(img))
    tgx, tgy = ts.central_gradients(torch.from_numpy(img))
    np.testing.assert_array_equal(tgx.numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(tgy.numpy(), np.asarray(jgy))


def test_cuda_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the dispatcher takes the plain version; the kernel's
    wrapper itself raises rather than fall back."""
    src, x, y = _inputs(4, 1, Hs=4, Ws=8)
    src_t = torch.from_numpy(np.ascontiguousarray(np.moveaxis(src, -1, 0)))
    with pytest.raises(ValueError, match="CUDA device"):
        ts.bilinear_sample_cuda(src_t, torch.from_numpy(x)[None],
                                torch.from_numpy(y)[None])


@pytest.mark.parametrize("B,route", [(0, 0), (1, 0), (31, 0), (32, 32),
                                     (36, 32), (63, 32), (64, 64), (120, 32),
                                     (128, 64), (144, 32)])
def test_sampler_route_rule(B, route):
    """One thread a sample below 32 rows (CENSUS's centre sample); the
    64-row tile where B is a whole number of 64-offset windows (box 15,
    increment 2); the 32-row tile otherwise."""
    assert ts.sampler_route(B) == route
    assert route in ts.SAMPLER_ROUTES


def test_sampler_refuses_an_unknown_route():
    src, x, y = _inputs(4, 1, Hs=4, Ws=8)
    src_t = torch.from_numpy(np.ascontiguousarray(np.moveaxis(src, -1, 0)))
    with pytest.raises(ValueError, match="route"):
        ts.bilinear_sample_on_route(src_t, torch.from_numpy(x)[None],
                                    torch.from_numpy(y)[None], 48)
