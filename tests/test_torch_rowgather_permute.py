"""gipuma_tpu_torch nearest row gather and 2-pass permutation against the
JAX package (Pallas kernels in interpret mode), on identical numpy inputs.

Tolerance: bitwise.  The gather is pure selection of 32-bit words, and the
table builders are numpy copies; with tile masks, outputs are compared at
masked-on coordinates only (masked-off tiles are unspecified by contract).
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gipuma_tpu.ops import pallas_rowgather as jrg
from gipuma_tpu.ops import permute2d as jpm

from gipuma_tpu_torch.ops import permute2d as tpm
from gipuma_tpu_torch.ops import rowgather as trg

REPO = Path(__file__).resolve().parents[1]

# The suite runs under pytest-xdist beside JAX's thread pools; at these
# sizes torch's intra-op threads only oversubscribe the cores.
torch.set_num_threads(1)


@pytest.fixture
def rng():
    """A fresh generator per test: inputs do not depend on test order."""
    return np.random.default_rng(1234)


def test_port_imports_no_jax():
    """The port never imports JAX or the JAX package (fresh interpreter)."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import gipuma_tpu_torch as g; print(g.foreign_modules())"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def _edge_floats(rng, shape):
    x = rng.uniform(-300, 300, size=shape).astype(np.float32)
    flat = x.reshape(-1)
    specials = np.array(
        [0.0, -0.0, 1e-45, -1e-45, 1e-40, np.inf, -np.inf, np.nan,
         3.4e38, -3.4e38,
         # bf16 round-half-even ties: low half-word exactly 0x8000
         np.uint32(0x3F808000).view(np.float32),
         np.uint32(0x3F818000).view(np.float32),
         np.uint32(0x7F7F8000).view(np.float32)], np.float32)
    flat[:specials.size] = specials
    return x


def test_pack_taps_bitwise(rng):
    x = _edge_floats(rng, (3, 8, 40))
    np.testing.assert_array_equal(jrg.pack_taps(x), trg.pack_taps(x))


def _positions(rng, B, H, Ws, W):
    x = rng.uniform(-3.0, W + 2.0, size=(B, H, Ws)).astype(np.float32)
    x[..., :4] = np.array([0.49999997, 0.5, W - 1.5, W - 0.5], np.float32)
    return x


@pytest.mark.parametrize("dtype", ["f32", "i32"])
@pytest.mark.parametrize("masked", [False, True])
def test_row_gather_nearest_bitwise(rng, dtype, masked):
    C, H, W, B, Ws = 2, 16, 128, 2, 128
    if dtype == "f32":
        src = rng.normal(size=(C, H, W)).astype(np.float32)
    else:
        src = rng.integers(-2**31, 2**31 - 1, size=(C, H, W),
                           dtype=np.int64).astype(np.int32)
    x = _positions(rng, B, H, Ws, W)
    tm = None
    if masked:
        tm = np.array([[1], [0]], np.int32)
    want = np.asarray(jrg.row_gather_batch(
        jnp.asarray(src), jnp.asarray(x), interpret=True, nearest=True,
        tile_ok=None if tm is None else jnp.asarray(tm)))
    got = trg.row_gather_batch(torch.from_numpy(src), torch.from_numpy(x),
                               nearest=True, tile_ok=None if tm is None
                               else torch.from_numpy(tm)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    rows = slice(0, 8) if masked else slice(None)
    np.testing.assert_array_equal(got.view(np.int32)[:, :, rows],
                                  want.view(np.int32)[:, :, rows])


def _smooth_map(out_h, out_w, in_h, in_w, rot=0.12, scale=1.15,
                shift=(2.3, -1.7)):
    s, c = np.sin(rot), np.cos(rot)
    ys, xs = np.meshgrid(np.arange(out_h), np.arange(out_w), indexing="ij")
    xi = scale * (c * xs - s * ys) + shift[0]
    yi = scale * (s * xs + c * ys) + shift[1]
    R = np.clip(np.round(yi).astype(np.int64), 0, in_h - 1)
    C = np.clip(np.round(xi).astype(np.int64), 0, in_w - 1)
    return R, C


@pytest.mark.parametrize("fill_mode", ["interp", "affine"])
def test_build_tables_and_masks_bitwise(fill_mode):
    R, C = _smooth_map(40, 56, 48, 64)
    valid = np.ones(R.shape, bool)
    valid[:3, :5] = False
    tj = jpm.build_tables(R, C, 48, 64, valid=valid, fill_mode=fill_mode)
    tt = tpm.build_tables(R, C, 48, 64, valid=valid, fill_mode=fill_mode)
    for a, b in zip(tj, tt):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for tr in (False, True):
        assert (jpm.tile_span_blocks(tj.c1, transposed=tr)
                == tpm.tile_span_blocks(tt.c1, transposed=tr))
    # Permute masks over a synthetic target set (hr=40, wr=128, S=64).
    hr, wr, s_sq = 40, 128, 64
    Rf, Cf = _smooth_map(hr, wr, s_sq, s_sq, rot=0.05, scale=0.5)
    fwd_j = jpm.build_tables(Rf, Cf, s_sq, s_sq)
    Rr, Cr = _smooth_map(s_sq, s_sq, hr, wr, rot=-0.05, scale=0.6)
    ret_j = jpm.build_tables(Rr, Cr, hr, wr)
    tgt = np.zeros((hr, wr), bool)
    tgt[5:30, 10:90] = True
    for k_rot in (0, 1):
        # The JAX package's (tile_ok, fwd1_ok, fwd2_ok, ret1_ok, ret2_ok):
        # the one-pass permute2d takes no first-pass masks.
        mj = jpm.build_permute_masks(tgt, fwd_j, ret_j, hr, wr, s_sq, k_rot,
                                     48, 64)
        mt = tpm.build_permute_masks(tgt, hr, wr, s_sq, k_rot, 48, 64)
        assert len(mt) == 3
        for a, b in zip((mj[0], mj[2], mj[4]), mt):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_permute2d_bitwise_at_consumed(rng, masked):
    in_h, in_w, out_h, out_w = 24, 32, 20, 28
    R, C = _smooth_map(out_h, out_w, in_h, in_w)
    t = jpm.build_tables(R, C, in_h, in_w)
    x = rng.normal(size=(3, in_h, in_w)).astype(np.float32)
    m1 = m2 = None
    if masked:
        # Pass-2 tile (rows 0-7 of the transposed output = output columns
        # 0-7) on; pass-1 tiles holding the rows those outputs read on.
        m2 = np.zeros((-(-out_w // 8), -(-out_h // 128)), np.int32)
        m2[0, 0] = 1
        m1 = np.zeros((-(-in_h // 8), -(-out_w // 128)), np.int32)
        rows = np.unique(R[:, :8]) // 8
        m1[rows, 0] = 1
    want = np.asarray(jpm.permute2d(
        jnp.asarray(x), jnp.asarray(t.c1), jnp.asarray(t.r), interpret=True,
        mask1=None if m1 is None else jnp.asarray(m1),
        mask2=None if m2 is None else jnp.asarray(m2)))
    got = tpm.permute2d(
        torch.from_numpy(x), torch.from_numpy(t.c1), torch.from_numpy(t.r),
        mask2=None if m2 is None else torch.from_numpy(m2)).numpy()
    cols = slice(0, 8) if masked else slice(None)
    np.testing.assert_array_equal(got[:, :, cols], want[:, :, cols])
    # ... and both equal direct indexing wherever the slot was uncontended.
    ok = ~t.affected[:, cols]
    np.testing.assert_array_equal(got[:, :, cols][:, ok],
                                  x[:, R, C][:, :, cols][:, ok])


def _consumed_masks(r, out_h, out_w, in_h, on2):
    """Pass masks of a chain: mask2 with the tiles `on2` on (over the
    transposed [out_w, out_h] output), mask1 with every pass-1 tile that a
    consumed output reads (row nearest(R[s, l]), lane l) on."""
    m2 = np.zeros((-(-out_w // 8), -(-out_h // 128)), np.int32)
    for a, b in on2:
        m2[a, b] = 1
    cons = np.repeat(np.repeat(m2 > 0, 8, 0), 128, 1)[:out_w, :out_h].T
    ri = np.clip((np.clip(np.nan_to_num(r, nan=0.0), 0, in_h - 1) + 0.5)
                 .astype(np.int64), 0, in_h - 1)
    lanes = np.broadcast_to(np.arange(out_w), r.shape)
    m1 = np.zeros((-(-in_h // 8), -(-out_w // 128)), np.int32)
    m1[ri[cons] // 8, lanes[cons] // 128] = 1
    return m1, m2, cons


@pytest.mark.parametrize("case", ["f32", "f16_pairs", "masked_f32",
                                  "masked_f16_pairs", "nan_entries",
                                  "masked_nan_entries", "two_d"])
def test_permute2d_one_pass_bitwise_vs_jax(rng, case):
    """The port's one-pass permute2d (its plain version on the CPU) against
    the JAX package's two-pass permute2d in interpret mode, bit for bit at
    consumed coordinates: f32 words, int32 words carrying f16 pairs
    (ops/rect_cost._pack_f16_pairs), a NaN in each table, a 2-D input."""
    in_h, in_w, out_h, out_w = 40, 36, 30, 140
    R, C = _smooth_map(out_h, out_w, in_h, in_w, rot=0.08, scale=0.3,
                       shift=(3.0, 2.0))
    t = jpm.build_tables(R, C, in_h, in_w)
    c1, r = t.c1.copy(), t.r.copy()
    if "nan" in case:
        c1[5, 7] = np.nan
        r[3, 9] = np.nan
        r[4, 130] = np.nan
    if "f16" in case:
        h = rng.normal(size=(2, 3, in_h, in_w)).astype(np.float16)
        x = (h[0].view(np.uint16).astype(np.uint32) << 16
             | h[1].view(np.uint16).astype(np.uint32)).view(np.int32)
    elif case == "two_d":
        x = rng.normal(size=(in_h, in_w)).astype(np.float32)
    else:
        x = rng.normal(size=(3, in_h, in_w)).astype(np.float32)
    m1 = m2 = None
    cons = np.ones((out_h, out_w), bool)
    if case.startswith("masked"):
        m1, m2, cons = _consumed_masks(r, out_h, out_w, in_h,
                                       [(0, 0), (3, 0), (17, 0)])
    want = np.asarray(jpm.permute2d(
        jnp.asarray(x), jnp.asarray(c1), jnp.asarray(r), interpret=True,
        mask1=None if m1 is None else jnp.asarray(m1),
        mask2=None if m2 is None else jnp.asarray(m2)))
    got = tpm.permute2d(
        torch.from_numpy(x), torch.from_numpy(c1), torch.from_numpy(r),
        mask2=None if m2 is None else torch.from_numpy(m2))
    assert got.is_contiguous()
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32)[..., cons],
                                  want.view(np.int32)[..., cons])
    assert cons.sum() > 0
