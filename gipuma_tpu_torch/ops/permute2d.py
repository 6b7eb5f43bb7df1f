"""Exact 2-D nearest-neighbor permutation: two-pass tables, one pass.

Counterpart of ``gipuma_tpu/ops/permute2d.py``.  The table builders are
numpy copies (bitwise equal to the JAX package's).  The JAX package applies
a permutation as two row-aligned gather passes, because a TPU gathers only
along lanes:

    pass 1 (horizontal):  A[r, l] = in[r, C1[r, l]]      r in [0, in_h)
    pass 2 (vertical):    out[s, l] = A[R[s, l], l]       (row gather on
                                                           transposed data)

``permute2d`` computes their composite in one pass,
out[s, l] = in[R[s, l], C1[R[s, l], l]] (each index rounded and clipped as
its pass rounds it), so it equals the two passes index for index
(``csrc/permute2d.cu`` on the card).

Exactness requires a consistent pass-1 table: C1[R[s, l], l] == C[s, l] for
every (s, l); `build_tables` reports the residual.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from .rowgather import _cuda_fn, _tile_mask


class PermuteTables(NamedTuple):
    """Static index tables of one smooth-map permutation (numpy).

    c1: [in_h, out_w] float32 — pass-1 horizontal gather positions;
    r:  [out_h, out_w] float32 — pass-2 row indices (the map's R);
    in_h, in_w: source shape (python ints, static);
    conflicts: number of (s, l) pairs whose exact value is unreachable
        (C1 slot contention; 0 for all rectification maps in practice —
        affected outputs read a horizontal neighbor of the wanted pixel).
    """

    c1: np.ndarray
    r: np.ndarray
    in_h: int
    in_w: int
    conflicts: int
    # [out_h, out_w] bool: outputs whose slot lost the contention and will
    # read a horizontally adjacent input pixel instead of the exact one.
    affected: np.ndarray


def _smooth_fill(R: np.ndarray, C: np.ndarray, valid: np.ndarray,
                 in_h: int, in_w: int) -> np.ndarray:
    """Per-column inverse-map interpolation: the ideal pass-1 table
    C1[r, l] = C at the output row s where R(s, l) == r.  Used as the fill
    for unwritten/contended slots so the table stays SMOOTH — junk fills
    would blow up the per-tile span the scratch-window gather relies on.

    Fully vectorized (one argsort + one searchsorted over all columns via
    the per-column-offset-key trick): the previous per-column
    np.interp loop dominated rect-scene build time at image scale."""
    out_h, out_w = R.shape
    rows = np.arange(in_h, dtype=np.float64)

    # Sort each column's valid (R, C) pairs by R; invalids sort to the end.
    # int32 keys + f32 values: the f64 argsort/take chain dominated this
    # function at image scale (indices are < 2^24, exact in f32).
    big = float(in_h + 2)
    xp = np.where(valid, R, in_h + 2).astype(np.int32)
    order = np.argsort(xp, axis=0, kind="stable")
    xs = np.take_along_axis(xp, order, axis=0).T.astype(np.float32)
    fs = np.take_along_axis(C.astype(np.int32), order,
                            axis=0).T.astype(np.float32)  # [out_w, out_h]
    cnt = valid.sum(axis=0)                                 # [out_w]
    good = cnt >= 2

    # Per-column searchsorted of the row grid, batched with offset keys:
    # column l's sorted xs live in [l*stride, (l+1)*stride) of the flat key
    # space, so one global searchsorted answers every (column, row) query.
    stride = big + 1.0
    colkey = np.arange(out_w, dtype=np.float64) * stride
    flat_xs = (xs + colkey[:, None]).ravel()
    flat_q = (rows[None, :] + colkey[:, None]).ravel()
    pos = np.searchsorted(flat_xs, flat_q, side="right")
    pos = pos.reshape(out_w, in_h) - np.arange(out_w)[:, None] * out_h
    hi = np.clip(pos, 1, np.maximum(cnt, 2)[:, None] - 1)
    lo = hi - 1
    x0 = np.take_along_axis(xs, lo, axis=1)
    x1 = np.take_along_axis(xs, hi, axis=1)
    f0 = np.take_along_axis(fs, lo, axis=1)
    f1 = np.take_along_axis(fs, hi, axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        t = (rows.astype(np.float32)[None, :] - x0) / (x1 - x0)
    t = np.clip(np.where(np.isfinite(t), t, 0.0), 0.0, 1.0)
    fill_t = f0 + t * (f1 - f0)                             # [out_w, in_h]

    if good.any() and not good.all():
        # Columns with no valid writers copy the nearest filled column —
        # a 0-fill next to real values would blow up the per-tile span.
        good_idx = np.nonzero(good)[0]
        p = np.clip(np.searchsorted(good_idx, np.arange(out_w)),
                    1, len(good_idx) - 1) if len(good_idx) > 1 else \
            np.zeros(out_w, np.int64)
        left = good_idx[np.maximum(p - 1, 0)]
        right = good_idx[np.minimum(p, len(good_idx) - 1)]
        nearest = np.where(np.abs(left - np.arange(out_w))
                           <= np.abs(right - np.arange(out_w)), left, right)
        bad = ~good
        fill_t[bad] = fill_t[nearest[bad]]
    elif not good.any():
        fill_t[:] = 0.0

    return np.clip(np.round(fill_t.T), 0, in_w - 1).astype(np.int64)


def _affine_fill_c1(R: np.ndarray, C: np.ndarray, valid: np.ndarray,
                    in_h: int, in_w: int, step: int = 16) -> np.ndarray:
    """Cheap smooth fill for the pass-1 table: global affine (least-
    squares) fit of C over (column l, target row R) on a sampled grid.

    Fill values only need SMOOTHNESS (they bound the scratch-window gather
    span; non-consumed slots are never read back — see _smooth_fill), and
    the affine trend of a rectification map is as smooth as it gets.  The
    per-column inverse interpolation (_smooth_fill) is ~50x this cost at
    image scale; callers retry with it only if the span bound breaks."""
    out_h, out_w = R.shape
    sub_R = R[::step, ::step]
    sub_v = valid[::step, ::step]
    if sub_v.sum() < 8:
        return _smooth_fill(R, C, valid, in_h, in_w)
    ls = np.broadcast_to(
        np.arange(0, out_w, step, dtype=np.float64)[None, :], sub_R.shape)
    n = int(sub_v.sum())
    A = np.stack([ls[sub_v], sub_R[sub_v].astype(np.float64),
                  np.ones(n)], axis=-1)
    c, *_ = np.linalg.lstsq(A, C[::step, ::step][sub_v].astype(np.float64),
                            rcond=None)
    fill = (c[1] * np.arange(in_h, dtype=np.float64))[:, None] + \
        (c[0] * np.arange(out_w, dtype=np.float64) + c[2])[None, :]
    return np.clip(np.round(fill), 0, in_w - 1).astype(np.int64)


def build_tables(R: np.ndarray, C: np.ndarray, in_h: int, in_w: int,
                 valid: np.ndarray | None = None,
                 fill_mode: str = "interp") -> PermuteTables:
    """Build 2-pass tables for out[s, l] = in[R[s, l], C[s, l]].

    R, C: integer arrays [out_h, out_w]; values are clipped into range.
    valid: optional [out_h, out_w] bool — outputs whose exact value does
        not matter (e.g. the map left the source image and was clamped).
        They are excluded from table construction so they cannot steal
        slots from real outputs, and read whatever their slot holds.
    fill_mode: "interp" (per-column inverse interpolation, _smooth_fill)
        or "affine" (global affine fit — ~50x cheaper, same smoothness
        class for rectification maps; written slots and the `affected`
        accounting are identical under either fill).
    """
    # int32 throughout: table indices are < 2^24 and flat slots < 2^31;
    # the int64 passes doubled build_tables' memory traffic at DTU scale.
    R = np.clip(np.asarray(R).astype(np.int32, copy=False), 0, in_h - 1)
    C = np.clip(np.asarray(C).astype(np.int32, copy=False), 0, in_w - 1)
    out_h, out_w = R.shape
    if valid is None:
        valid = np.ones(R.shape, bool)
    l = np.broadcast_to(np.arange(out_w, dtype=np.int32), R.shape)
    flat_all = R * np.int32(out_w) + l
    flat = flat_all[valid]

    # Scatter C into the pass-1 table; detect slot contention by comparing
    # min- and max-scatters (same-value collisions are harmless).
    cmin = np.full(in_h * out_w, np.iinfo(np.int32).max, np.int32)
    cmax = np.full(in_h * out_w, -1, np.int32)
    cv = C[valid]
    np.minimum.at(cmin, flat, cv)
    np.maximum.at(cmax, flat, cv)
    written = cmax >= 0
    conflicts = int(np.sum((cmax - cmin)[written] > 0))

    if fill_mode == "affine":
        fill = _affine_fill_c1(R, C, valid, in_h, in_w).ravel()
    else:
        fill = _smooth_fill(R, C, valid, in_h, in_w).ravel()
    c1 = np.where(written, np.clip(cmin, 0, in_w - 1),
                  fill.astype(np.int32, copy=False))
    affected = (c1[flat_all] != C) & valid
    c1 = c1.reshape(in_h, out_w).astype(np.float32)
    return PermuteTables(c1=c1, r=R.astype(np.float32), in_h=in_h,
                         in_w=in_w, conflicts=conflicts, affected=affected)


def _nearest(t: torch.Tensor, n: int) -> torch.Tensor:
    """A pass's row or column index, as the gather rounds it:
    clip(int(clip(t, 0, n-1) + 0.5), 0, n-1), a NaN entry read as 0 (the
    kernel's clip does that; a float-to-int cast of NaN is undefined on
    the CPU)."""
    t = torch.nan_to_num(t, nan=0.0).clamp(0.0, float(n - 1))
    return (t + 0.5).to(torch.int64).clamp(0, n - 1)


def permute2d_index(c1: torch.Tensor, r: torch.Tensor, in_h: int,
                    in_w: int) -> torch.Tensor:
    """The composite flat source index ri * in_w + col, [out_h, out_w]
    int64: ri from r (pass 2), col from c1 at row ri (pass 1)."""
    ri = _nearest(r, in_h)
    lanes = torch.arange(r.shape[1], device=r.device)
    return ri * in_w + _nearest(c1[ri, lanes], in_w)


def permute2d_plain(x: torch.Tensor, c1: torch.Tensor, r: torch.Tensor
                    ) -> torch.Tensor:
    """Plain torch version of the one-pass permutation: x [C, in_h, in_w]
    (any dtype) -> [C, out_h, out_w].  Computes every output (a mask only
    makes outputs unspecified, so ignoring it is a valid result)."""
    C, in_h, in_w = x.shape
    flat = permute2d_index(c1, r, in_h, in_w)
    return x.reshape(C, in_h * in_w)[:, flat]


def permute2d_cuda(x: torch.Tensor, c1: torch.Tensor, r: torch.Tensor,
                   mask2: torch.Tensor | None = None) -> torch.Tensor:
    """Launch csrc/permute2d.cu: same contract as the plain version, 32-bit
    words; outputs on tiles of `mask2` that are off are unspecified."""
    C, in_h, in_w = x.shape
    out_h, out_w = r.shape
    if x.element_size() != 4 or x.is_complex():
        raise TypeError(f"permute2d: 32-bit words, got {x.dtype}")
    if (c1.dtype != torch.float32 or r.dtype != torch.float32
            or c1.shape != (in_h, out_w)):
        raise ValueError(f"permute2d: float32 tables c1 [in_h, out_w], r "
                         f"[out_h, out_w]; got {c1.dtype} "
                         f"{tuple(c1.shape)}, {r.dtype} {tuple(r.shape)} "
                         f"for x {tuple(x.shape)}")
    for t in (x, c1, r):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("permute2d: contiguous inputs on one device")
    if max(x.numel(), C * out_h * out_w) >= 2 ** 31:
        raise ValueError("permute2d: 32-bit offsets")
    tm = None if mask2 is None else _tile_mask(mask2, out_w, out_h)
    out = torch.empty((C, out_h, out_w), dtype=torch.int32, device=x.device)
    fn = _cuda_fn("permute2d", "gtt_permute2d",
                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p])
    rc = fn(kernels.ptr(x.view(torch.int32)), kernels.ptr(c1),
            kernels.ptr(r), kernels.ptr(tm), kernels.ptr(out), C, in_h, in_w,
            out_h, out_w, 0 if tm is None else tm.shape[1],
            kernels.stream_ptr(x.device))
    kernels.check(rc, "permute2d")
    kernels.counts["permute2d"] += 1
    return out.view(x.dtype)


def permute2d(x: torch.Tensor, c1: torch.Tensor, r: torch.Tensor,
              mask2: torch.Tensor | None = None) -> torch.Tensor:
    """Apply a permutation built by `build_tables`, in one pass.

    x: [in_h, in_w] or [C, in_h, in_w]; c1: [in_h, out_w]; r: [out_h, out_w]
    (float32 tensors on x's device).  Returns a contiguous [out_h, out_w] /
    [C, out_h, out_w].

    mask2: optional int32 output-tile mask (`build_permute_masks`),
    [ceil(out_w/8), ceil(out_h/128)] tiles over the TRANSPOSED [out_w,
    out_h] output (the layout of the JAX package's second gather pass).
    Outputs whose tile is off hold unspecified values; the caller consumes
    only coordinates on tiles that are on.  The JAX package's first-pass
    mask has no counterpart: where it is off, its two-pass chain was
    unspecified too.  The kernel on a CUDA tensor, the plain version on a
    CPU tensor.
    """
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    if x.device.type == "cpu":
        out = permute2d_plain(x, c1, r)
    else:
        out = permute2d_cuda(x.contiguous(), c1.contiguous(), r.contiguous(),
                             mask2)
    return out[0] if squeeze else out


def _tile_minmax(x: np.ndarray, bh: int, bw: int):
    """Per-[bh, bw]-tile (min, max) of a 2-D array; partial edge tiles use
    their true extents (equivalent to the former edge-replicated pad)."""
    h, w = x.shape
    nth, ntw = -(-h // bh), -(-w // bw)
    h0, w0 = (h // bh) * bh, (w // bw) * bw
    mn = np.empty((nth, ntw), x.dtype)
    mx = np.empty((nth, ntw), x.dtype)
    if h0 and w0:
        c = np.ascontiguousarray(x[:h0, :w0]).reshape(
            h0 // bh, bh, w0 // bw, bw)
        mn[:h0 // bh, :w0 // bw] = c.min(axis=(1, 3))
        mx[:h0 // bh, :w0 // bw] = c.max(axis=(1, 3))
    if w0 < w and h0:
        e = np.ascontiguousarray(x[:h0, w0:]).reshape(h0 // bh, -1)
        mn[:h0 // bh, -1] = e.min(axis=1)
        mx[:h0 // bh, -1] = e.max(axis=1)
    if h0 < h and w0:
        e = np.ascontiguousarray(x[h0:, :w0]).reshape(-1, w0 // bw, bw)
        mn[-1, :w0 // bw] = e.min(axis=(0, 2))
        mx[-1, :w0 // bw] = e.max(axis=(0, 2))
    if h0 < h and w0 < w:
        e = x[h0:, w0:]
        mn[-1, -1] = e.min()
        mx[-1, -1] = e.max()
    return mn, mx


def tile_span_blocks(x: np.ndarray, transposed: bool = False) -> int:
    """Worst-case number of 128-column source blocks any [8, 128] tile of
    gather positions `x` touches (the row_gather scratch-window bound),
    accounting for arbitrary 128-block alignment of the window base.

    transposed=True measures x.T without materializing it ([128, 8] tiles
    of x have the same per-tile value sets as [8, 128] tiles of x.T).

    Blocked f32 min/max (not a padded full-array floor/int cast): this
    function ran 32 times per DTU-scale rect build and dominated prep
    (~3 s/call on multi-megapixel tables before the rewrite)."""
    bh, bw = (128, 8) if transposed else (8, 128)
    mn, mx = _tile_minmax(np.asarray(x), bh, bw)
    # floor is monotone: per-tile floor-min == floor(per-tile min).
    x0 = np.floor(mn).astype(np.int64)
    x1 = np.floor(mx).astype(np.int64) + 1
    return int(((x1 - (x0 // 128) * 128) // 128 + 1).max())


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def build_permute_masks(tgt: np.ndarray, hr: int, wr: int, s_sq: int,
                        k_rot: int, h: int, w: int):
    """Tile masks for the rect fast path's skip machinery, all derived from
    one read-back-target set `tgt` ([hr, wr] bool: rect coordinates the
    return permutation addresses — see models/rect_scene.build_rect_scene).

    Returns (tile_ok, fwd2_ok, ret2_ok) int32 masks -- one per fused-kernel
    tile plus one per permutation, so every permute2d skips tiles whose
    outputs are never consumed:

    * tile_ok [ceil(hr/8), wr/128]: per-[8, 128]-tile target mask — the
      fused cost kernel (ops/pallas_sdg_fused.py) skips tiles with no
      target (the empty bbox triangles of a tilted footprint quad plus the
      source-footprint column margin); skipped tiles are never read back.
    * fwd2_ok [wr/8, ceil(hr/128)]: mask of the state->rect forward
      permutation (TRANSPOSED [wr, hr] output space): a tile must run iff
      it covers any pixel of any fused-kernel-evaluated (tile_ok) rect
      tile — the kernel reads the permuted plane field over WHOLE [8, 128]
      tiles it evaluates.
    * ret2_ok [ceil(s_sq/8), ceil(s_sq/128)]: mask of the rect->state
      return permutation (TRANSPOSED [s_sq, s_sq] output space): the
      consumed state outputs form the un-rotated [hk, wk] rectangle, so
      this is a static rectangle mask — the S x S square pad beyond it
      (~25% at 4:3 images) is never consumed.

    The JAX package's function also takes the two permutations' tables and
    returns the masks of their first gather passes (fwd1_ok, ret1_ok),
    which the one-pass permute2d does not need.
    """
    hp8 = _round_up(hr, 8)
    tgt_p = np.zeros((hp8, wr), bool)
    tgt_p[:hr] = tgt
    tile_ok = tgt_p.reshape(hp8 // 8, 8, wr // 128, 128).any(
        axis=(1, 3)).astype(np.int32)

    hp128 = _round_up(hr, 128)
    pix = np.zeros((hp128, wr), bool)
    pix[:hp8] = np.repeat(np.repeat(tile_ok > 0, 8, 0), 128, 1)
    fwd2_ok = pix.T.reshape(wr // 8, 8, hp128 // 128, 128).any(
        axis=(1, 3)).astype(np.int32)

    hk, wk = (w, h) if k_rot % 2 else (h, w)

    ret2_ok = np.zeros((_round_up(s_sq, 8) // 8,
                        _round_up(s_sq, 128) // 128), np.int32)
    ret2_ok[:-(-wk // 8), :-(-hk // 128)] = 1
    return tile_ok, fwd2_ok, ret2_ok
