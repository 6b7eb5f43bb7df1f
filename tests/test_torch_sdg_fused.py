"""gipuma_tpu_torch fused window cost (plain version) against the JAX
package's fused kernel in interpret mode, on identical numpy inputs —
the scenarios of tests/test_sdg_fused.py at smaller shapes.

Tolerance: 1e-3 abs at covered pixels (the tolerance KERNEL_EQUIV.json
holds the TPU kernel to): the plain version transcribes the unfused
arithmetic, whose weight and sums are rounded in another order than the
fused kernel's.  Pixels outside hw_valid / tile_ok are unspecified."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gipuma_tpu.config import AlgorithmParams as JParams
from gipuma_tpu.ops.pallas_rowgather import _unpack_taps as j_unpack_taps
from gipuma_tpu.ops.pallas_rowgather import pack_taps
from gipuma_tpu.ops.pallas_sdg_fused import fused_sdg_cost_batch as j_fused

from gipuma_tpu_torch.config import AlgorithmParams as TParams
from gipuma_tpu_torch.ops import rowgather as trg
from gipuma_tpu_torch.ops import sdg_fused as tsf

REPO = Path(__file__).resolve().parents[1]

# The suite runs under pytest-xdist beside JAX's thread pools; at these
# sizes torch's intra-op threads only oversubscribe the cores.
torch.set_num_threads(1)
ATOL = 1e-3


def test_port_imports_no_jax():
    """The port never imports JAX or the JAX package (fresh interpreter)."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import gipuma_tpu_torch as g; print(g.foreign_modules())"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def _inputs(seed, C, hr, wr, K):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0.0, 255.0, size=(3 * C, hr, wr)).astype(np.float32)
    src = rng.uniform(0.0, 255.0, size=(C, hr, wr)).astype(np.float32)
    coef = rng.uniform(-0.05, 0.05, size=(K, 3, 1, 1)).astype(np.float32)
    abc = np.broadcast_to(coef, (K, 3, hr, wr)).copy()
    abc[:, 2] += 10.0
    return ref, pack_taps(src), abc


def _both(ref, src, abc, box, lo, hi, hw_valid=None, tile_ok=None, **kw):
    jp = JParams(box_hsize=box, box_vsize=box, **kw)
    tp = TParams(box_hsize=box, box_vsize=box, **kw)
    want = np.asarray(j_fused(
        jnp.asarray(ref), jnp.asarray(src), jnp.asarray(abc), jp,
        interpret=True, disp_lo=jnp.float32(lo), disp_hi=jnp.float32(hi),
        span_blocks=wr_blocks(ref),
        hw_valid=None if hw_valid is None else jnp.asarray(hw_valid),
        tile_ok=None if tile_ok is None else jnp.asarray(tile_ok)))
    got = tsf.fused_sdg_cost_batch(
        torch.from_numpy(ref), torch.from_numpy(src), torch.from_numpy(abc),
        tp, disp_lo=lo, disp_hi=hi,
        hw_valid=None if hw_valid is None else torch.from_numpy(hw_valid),
        tile_ok=None if tile_ok is None else torch.from_numpy(tile_ok)
    ).numpy()
    return got, want


def wr_blocks(ref):
    return ref.shape[-1] // 128


@pytest.mark.parametrize("C,K,onesided", [(1, 1, False), (1, 2, True),
                                          (3, 1, True)])
def test_plain_matches_fused_kernel(C, K, onesided):
    ref, src, abc = _inputs(C * 10 + K, C, 16, 128, K)
    got, want = _both(ref, src, abc, 5, -20.0, 40.0,
                      sdg_onesided_edges=onesided)
    assert got.shape == want.shape == (K, 16, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_hw_valid_and_tile_ok_covered_pixels():
    ref, src, abc = _inputs(5, 1, 24, 128, 1)
    hwv = np.array([20, 128], np.int32)      # partial last row tile
    tm = np.array([[1], [0], [1]], np.int32)
    got, want = _both(ref, src, abc, 5, -20.0, 40.0, hw_valid=hwv,
                      tile_ok=tm)
    cov = np.repeat(np.repeat(tm > 0, 8, 0), 128, 1)
    np.testing.assert_allclose(got[:, cov], want[:, cov], rtol=0, atol=ATOL)


def test_unpack_taps_bitwise():
    rng = np.random.default_rng(2)
    w = rng.integers(-2**31, 2**31 - 1, size=(4, 64), dtype=np.int64)
    w = w.astype(np.int32)
    jv0, jv1 = j_unpack_taps(jnp.asarray(w))
    tv0, tv1 = trg.unpack_taps(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(jv0).view(np.int32),
                                  tv0.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(jv1).view(np.int32),
                                  tv1.numpy().view(np.int32))
