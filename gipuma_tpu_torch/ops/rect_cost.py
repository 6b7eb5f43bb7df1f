"""Rectified-frame multiview cost — the rect path's cost function.

Counterpart of ``gipuma_tpu/ops/rect_cost.py``.  The PatchMatch state
stays on the reference grid; per-candidate plane vectors m = n/d are
carried to each pair's rect grid, and per-view costs carried back, by
static 2-pass permutations (ops/permute2d.py, the nearest row gather).
The window cost on the rect grid follows the scene's layout, as in the
JAX package: the fused window_grads kernel (ops/sdg_fused.py) on the
default packed layout, or the unfused window_grads cost and census, whose
sampled window rows are affine row gathers (ops/rowgather.
row_gather_affine_rows: all window rows of a pass and view in one launch),
or the full-channel, grad_fwd and f32 scans over the window offsets, one
lerp row gather per offset.

The JAX package scans the view axis with ``lax.scan``; here the view loop
is a Python loop with one launch of each kernel per pass and view.  Per-
view scalars (the disparity clamp, the valid extent, the view's validity)
stay on the device; the only host values are static: the rotation counts
(``rot_k_host``) and the span bounds (``spans.shape``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..config import MAXCOST, AlgorithmParams, MatchingAlgorithm
from ..geometry import transforms as T
from . import checkerboard as cb
from .cost import ScenePack, _census_bits, combine_view_costs
from .permute2d import permute2d
from .rowgather import (_to_i32, row_gather, row_gather_affine,
                        row_gather_affine_rows, row_gather_batch)
from .sdg_fused import (_clip, fused_sdg_cost_batch, window_geometry,
                        window_grads_cost)


class RectScene(NamedTuple):
    """ScenePack + per-pair rectified data, stacked over the view axis and
    padded to a common rect shape [Hrp, Wrp] (Wrp % 128 == 0).  Exposes
    the base scene's engine-facing fields as properties.  S = max(H, W):
    the k*90-degree-rotated reference grid padded to a square."""

    base: ScenePack
    ref_rect: torch.Tensor   # [V, 3C, Hrp, Wrp] rect-ref channels
    # src_rect by layout: [V, C] int32 packed image tap words (window_grads),
    # [V, 2C] packed [img, gy] (grad_fwd), [V, 3C] packed or f32 (full).
    src_rect: torch.Tensor   # [V, C | 2C | 3C, Hrp, Wrp]
    L: torch.Tensor          # [V, 3, 3]: abc_local = L @ m
    fwd_c1: torch.Tensor     # [V, S, Wrp]  rotated state -> rect, pass 1
    fwd_r: torch.Tensor      # [V, Hrp, Wrp]                         pass 2
    ret_c1: torch.Tensor     # [V, Hrp, S]  rect -> rotated state, pass 1
    ret_r: torch.Tensor      # [V, S, S]                             pass 2
    rot_k: torch.Tensor      # [V] int32
    disp_bounds: torch.Tensor  # [V, 2] = (lo, hi) rect-pixel clamp
    # spans.shape = (sample_span_blocks, permute_span_blocks), as in the
    # JAX package (TPU scratch-window bounds; no effect on the card).
    spans: torch.Tensor
    hw_valid: torch.Tensor = None  # [V, 2] int32 valid (rows, cols)
    tile_ok: torch.Tensor = None   # [V, Hrp/8, Wrp/128] int32
    fwd2_ok: torch.Tensor = None   # [V, Wrp/8, ceil(Hrp/128)]
    ret2_ok: torch.Tensor = None   # [V, ceil(S/8), ceil(S/128)]
    # Nested screening scene (config.cull_downscale): downscaled rect grids
    # over the cull_view_stride view subset, built with the cull window
    # geometry (models/rect_scene.build_rect_scene); the sparse pass of the
    # two-stage cull reads it when present.
    cull: "RectScene" = None
    # Host copy of rot_k (python ints): picks each view's rotation without
    # a device sync.
    rot_k_host: tuple = ()
    # Host copy of view_valid (bools): invalid views (dropped pairs, the
    # dummy views of rect_quantize_shapes) launch no kernel.
    valid_host: tuple = ()

    @property
    def rays(self):
        return self.base.rays

    @property
    def view_vec(self):
        return self.base.view_vec

    @property
    def f(self):
        return self.base.f

    @property
    def baseline(self):
        return self.base.baseline

    @property
    def fx(self):
        return self.base.fx

    @property
    def cx(self):
        return self.base.cx

    @property
    def cy(self):
        return self.base.cy

    @property
    def alpha_focal(self):
        return self.base.alpha_focal

    @property
    def M_inv(self):
        return self.base.M_inv

    @property
    def P_col4(self):
        return self.base.P_col4

    @property
    def R_orig_inv(self):
        return self.base.R_orig_inv

    @property
    def depth_min(self):
        return self.base.depth_min

    @property
    def depth_max(self):
        return self.base.depth_max

    @property
    def texture_ok(self):
        return self.base.texture_ok

    @property
    def row_offset(self):
        return self.base.row_offset

    @property
    def global_h(self):
        return self.base.global_h

    @property
    def view_valid(self):
        return self.base.view_valid

    @property
    def num_views(self) -> int:
        return self.ref_rect.shape[0]

    def rotations(self) -> tuple:
        return self.rot_k_host or tuple(int(k) for k in self.rot_k.tolist())

    def valid_views(self) -> tuple:
        return self.valid_host or tuple(
            bool(v) for v in self.view_valid.tolist())


def _slice_views(scene: RectScene, stride: int) -> RectScene:
    """Strided view subset of a RectScene (the two-stage cull's sparse
    screening pass, config.cull_view_stride)."""
    def sl(a):
        return None if a is None else a[::stride]

    base = scene.base._replace(view_valid=scene.base.view_valid[::stride])
    return scene._replace(
        base=base, ref_rect=sl(scene.ref_rect), src_rect=sl(scene.src_rect),
        L=sl(scene.L), fwd_c1=sl(scene.fwd_c1), fwd_r=sl(scene.fwd_r),
        ret_c1=sl(scene.ret_c1), ret_r=sl(scene.ret_r),
        rot_k=sl(scene.rot_k), disp_bounds=sl(scene.disp_bounds),
        hw_valid=sl(scene.hw_valid), tile_ok=sl(scene.tile_ok),
        fwd2_ok=sl(scene.fwd2_ok), ret2_ok=sl(scene.ret2_ok),
        rot_k_host=tuple(scene.rotations()[::stride]),
        valid_host=tuple(scene.valid_views()[::stride]))


# --- f16 / f32 word packing for the nearest permutes (bitwise equal to the
# --- JAX package's packers; the bit arithmetic runs in int64).

def _f16_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its f16 (round-half-even) bit pattern in int64 [0, 65535]."""
    return x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF


def _bits_f16(v: torch.Tensor) -> torch.Tensor:
    """int64 f16 bit pattern in [0, 65535] -> float32 value."""
    v = torch.where(v >= 32768, v - 65536, v).to(torch.int16)
    return v.view(torch.float16).to(torch.float32)


def _pack_m(m_chw: torch.Tensor) -> torch.Tensor:
    """[K, 3, H, W] f32 -> [K, 2, H, W] int32: channel 0 =
    (f16(m0) << 16) | f16(m1), channel 1 = bitcast(m2)."""
    w01 = _to_i32((_f16_bits(m_chw[:, 0]) << 16) | _f16_bits(m_chw[:, 1]))
    w2 = m_chw[:, 2].contiguous().view(torch.int32)
    return torch.stack([w01, w2], dim=1)


def _unpack_m(mp: torch.Tensor) -> torch.Tensor:
    """Inverse of _pack_m: [K, 2, Hr, Wr] int32 -> [K, 3, Hr, Wr] f32."""
    w01 = mp[:, 0].to(torch.int64) & 0xFFFFFFFF
    m0 = _bits_f16(w01 >> 16)
    m1 = _bits_f16(w01 & 0xFFFF)
    m2 = mp[:, 1].contiguous().view(torch.float32)
    return torch.stack([m0, m1, m2], dim=1)


def _pack_f16_pairs(x: torch.Tensor) -> torch.Tensor:
    """[N, ...] f32 -> [ceil(N/2), ...] int32: element 2j in the high
    half-word, 2j+1 in the low (odd N zero-padded)."""
    if x.shape[0] % 2:
        x = torch.cat([x, torch.zeros_like(x[:1])], dim=0)
    return _to_i32((_f16_bits(x[0::2]) << 16) | _f16_bits(x[1::2]))


def _unpack_f16_pairs(w: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of _pack_f16_pairs: [ceil(n/2), ...] int32 -> [n, ...] f32."""
    u = w.to(torch.int64) & 0xFFFFFFFF
    hi = _bits_f16(u >> 16)
    lo = _bits_f16(u & 0xFFFF)
    return torch.stack([hi, lo], dim=1).reshape(-1, *w.shape[1:])[:n]


def _pack_m_tri(m_chw: torch.Tensor) -> torch.Tensor:
    """All-f16 plane packing: [K, 3, H, W] -> [ceil(3K/2), H, W] int32."""
    K = m_chw.shape[0]
    return _pack_f16_pairs(m_chw.reshape(K * 3, *m_chw.shape[2:]))


def _unpack_m_tri(mp: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of _pack_m_tri -> [k, 3, Hr, Wr] f32."""
    return _unpack_f16_pairs(mp, 3 * k).reshape(k, 3, *mp.shape[1:])


@functools.lru_cache(maxsize=64)
def _const(values: tuple, dtype: torch.dtype, dev: torch.device
           ) -> torch.Tensor:
    """`values` as a tensor on `dev`, made once per (values, dtype, device):
    a later call copies nothing from the host, so a CUDA graph can capture
    it."""
    return torch.tensor(values, dtype=dtype, device=dev)


def _iotas(hr: int, wr: int, dev):
    """Column and row index grids as float32 [hr, wr]."""
    xg = torch.arange(wr, device=dev).to(torch.float32)[None, :].expand(hr, wr)
    yg = torch.arange(hr, device=dev).to(torch.float32)[:, None].expand(hr, wr)
    return xg, yg


def _shift2d(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-replicated integer shift of the last two dims:
    out[..., y, x] = a[..., clip(y + dy), clip(x + dx)]."""
    h, w = a.shape[-2:]
    rows = (torch.arange(h, device=a.device) + dy).clamp(0, h - 1)
    cols = (torch.arange(w, device=a.device) + dx).clamp(0, w - 1)
    return a[..., rows, :][..., cols]


def _l1(x: torch.Tensor) -> torch.Tensor:
    """Channel mean of |x| over the channel axis (-3)."""
    return x.abs().mean(dim=-3)


def _row_positions(abc_k, dxs, dy: int, bounds) -> torch.Tensor:
    """Sample positions of window row dy at column offsets dxs for every
    candidate, materialized for the lerp gather: x = (j+dx) - disp with
    disp = a*(j+dx) + (b*(i+dy) + c), clipped to bounds = (lo, hi) when
    given.  [K*E, Hr, Wr]."""
    K, _, hr, wr = abc_k.shape
    xg, yg = _iotas(hr, wr, abc_k.device)
    dx_e = _const(tuple(dxs), torch.float32, abc_k.device)
    xse = xg[None, None] + dx_e[None, :, None, None]          # [1, E, hr, wr]
    disp = (abc_k[:, 0, None] * xse
            + (abc_k[:, 1] * (yg + float(dy)) + abc_k[:, 2])[:, None])
    if bounds is not None:
        disp = _clip(disp, bounds[0], bounds[1])
    return (xse - disp).reshape(K * len(dxs), hr, wr)


def _default_bounds(disp_bounds, dev) -> torch.Tensor:
    """The clamp of the sampling paths: disp_bounds, or (-1e9, 1e9)."""
    if disp_bounds is not None:
        return disp_bounds
    return _const((-1e9, 1e9), torch.float32, dev)


def rect_window_cost(ref_rect: torch.Tensor, ref_gx: torch.Tensor,
                     src_rect_chw: torch.Tensor, abc: torch.Tensor,
                     params: AlgorithmParams) -> torch.Tensor:
    """Per-pixel window cost on the rectified grid, one hypothesis, with
    x-gradients only (the JAX package's rect_window_cost): ref_rect,
    ref_gx [Hr, Wr]; src_rect_chw [2, Hr, Ws] (intensity, x-gradient) f32;
    abc [Hr, Wr, 3] (disp = a*x + b*y + c).  One lerp gather per window
    offset.  Returns [Hr, Wr]."""
    hr, wr = ref_rect.shape
    xg, yg = _iotas(hr, wr, ref_rect.device)
    inv_gamma = 1.0 / params.gamma
    alpha = params.alpha
    acc = torch.zeros((hr, wr), dtype=torch.float32, device=ref_rect.device)
    for (dx, dy) in params.window_offsets():
        ref_i = _shift2d(ref_rect, dy, dx)
        ref_g = _shift2d(ref_gx, dy, dx)
        xs = xg + dx
        ys = yg + dy
        disp = abc[..., 0] * xs + abc[..., 1] * ys + abc[..., 2]
        smp = row_gather(src_rect_chw, xs - disp, src_dy=dy)   # [2, Hr, Wr]
        w = torch.exp(-(ref_i - ref_rect).abs() * inv_gamma)
        col = torch.clamp((ref_i - smp[0]).abs(), max=params.tau_color)
        grad = torch.clamp((ref_g - smp[1]).abs() * 0.125,
                           max=params.tau_gradient)
        acc = acc + w * ((1.0 - alpha) * col + alpha * grad)
    return torch.where(torch.isnan(acc) | (acc >= MAXCOST), MAXCOST, acc)


def rect_pair_cost(ref_chw, src_chw, abc, params: AlgorithmParams,
                   disp_bounds=None) -> torch.Tensor:
    """Window cost of one hypothesis field abc [3, Hr, Wr] on one
    rectified pair: [Hr, Wr] (rect_pair_cost_batch at K = 1, which
    computes the same values as the JAX package's single-field scan)."""
    return rect_pair_cost_batch(ref_chw, src_chw, abc[None], params,
                                disp_bounds)[0]


def _rect_pair_cost_batch_sdg(ref_chw, src_chw, abc_k,
                              params: AlgorithmParams, disp_bounds=None,
                              hw_valid=None, tile_ok=None) -> torch.Tensor:
    """window_grads path: src_chw holds only the image channels ([C]
    packed tap words, or f32), and both source gradients come from
    neighbouring window samples (ops/sdg_fused.window_grads_cost).  Packed
    words with fused_window_cost take the fused kernel; otherwise packed
    words take one row_gather_affine_rows launch for all sampled window
    rows, K candidates and E columns, and f32 one lerp gather of
    materialized positions per window row."""
    dev = ref_chw.device
    affine = src_chw.dtype == torch.int32
    db = _default_bounds(disp_bounds, dev)
    if affine and params.fused_window_cost:
        return fused_sdg_cost_batch(ref_chw, src_chw, abc_k, params,
                                    hw_valid=hw_valid, tile_ok=tile_ok,
                                    disp_bounds=db)
    ch, hr, wr = ref_chw.shape
    K = abc_k.shape[0]
    _, _, xs_ext, ys_ext = window_geometry(params)

    shape = (K, len(xs_ext), ch // 3, hr, wr)
    dys = [int(dy) for dy in ys_ext]
    if affine:
        smps = row_gather_affine_rows(src_chw, abc_k, xs_ext, dys,
                                      disp_bounds=db).reshape(
                                          len(dys), *shape).unbind(0)
    else:
        smps = [row_gather_batch(
            src_chw, _row_positions(abc_k, xs_ext, dy, disp_bounds),
            src_dy=dy).reshape(shape) for dy in dys]
    return window_grads_cost(ref_chw, abc_k, params, list(smps))


def _rect_pair_cost_batch_census(ref_chw, src_chw, abc_k,
                                 params: AlgorithmParams,
                                 disp_bounds=None) -> torch.Tensor:
    """Census window cost on the rectified grid (the rect path's `-a ct`,
    censusTransform_Arma_cu, gipuma.cu:362-450): the full window at
    increment 1, center excluded; the cost is the number of differing
    3-way sign classes between the reference window (against its center)
    and the warped source samples (against the warped center), on channel
    means.  On packed image words one row_gather_affine_rows launch
    serves every window row, K candidates x box_hsize columns, and one
    row_gather_affine launch the warped center; on an f32 layout each
    window row is one lerp gather launch.  The counts are whole numbers,
    so adding a row's columns at once gives the JAX package's per-offset
    sums exactly."""
    ch, hr, wr = ref_chw.shape
    dev = ref_chw.device
    K = abc_k.shape[0]
    vr, hrad = params.box_vrad, params.box_hrad
    eps = params.census_epsilon
    packed = src_chw.dtype == torch.int32
    # Image channels only: [C] packed words (window_grads), the first C of
    # [2C] packed (grad_fwd) or [3C] channel layouts.
    C = ch // 3
    src_img = src_chw[:C]
    ref_mean = ref_chw[:C].mean(dim=0)                          # [Hr, Wr]
    db = _default_bounds(disp_bounds, dev)
    xs_all = list(range(-hrad, hrad + 1))

    def gather_row(dy: int, dxs: list) -> torch.Tensor:
        if packed:
            smp = row_gather_affine(src_img, abc_k, dxs, float(dy),
                                    disp_bounds=db, src_dy=dy)
        else:
            smp = row_gather_batch(src_img, _row_positions(abc_k, dxs, dy, db),
                                   src_dy=dy)
        return smp.reshape(K, len(dxs), C, hr, wr).mean(dim=2)

    # Warped center intensity (censusTransform_Arma_cu:429-430).
    src_center = gather_row(0, [0])                              # [K, 1, Hr, Wr]
    rows = torch.arange(hr, device=dev)
    cols = (torch.arange(wr, device=dev)[None, :]
            + _const(tuple(xs_all), torch.int64, dev)[:, None]).clamp(
                0, wr - 1)
    acc = torch.zeros((K, hr, wr), dtype=torch.float32, device=dev)
    dys = list(range(-vr, vr + 1))
    if packed:   # every window row in one launch: [R, K, E, C, Hr, Wr]
        stack = row_gather_affine_rows(src_img, abc_k, xs_all, dys,
                                       disp_bounds=db).reshape(
                                           len(dys), K, len(xs_all), C, hr, wr)
    for t, dy in enumerate(dys):
        if packed:
            smp = stack[t].mean(dim=2)                       # [K, E, Hr, Wr]
        else:
            smp = gather_row(dy, xs_all)
        ref_w = ref_mean[(rows + dy).clamp(0, hr - 1)][:, cols]  # [Hr, E, Wr]
        bit_l = _census_bits(ref_mean, ref_w.permute(1, 0, 2), eps)
        bit_r = _census_bits(src_center, smp, eps)               # [K, E, Hr, Wr]
        diff = bit_l[None] != bit_r
        if dy == 0:
            diff[:, hrad] = False   # center excluded (gipuma.cu:435-439)
        acc = acc + diff.sum(dim=1).to(torch.float32)
    return torch.where(torch.isnan(acc) | (acc >= MAXCOST), MAXCOST, acc)


def rect_pair_cost_batch(ref_chw, src_chw, abc_k, params: AlgorithmParams,
                         disp_bounds=None, hw_valid=None, tile_ok=None
                         ) -> torch.Tensor:
    """Window cost of K candidate fields on one rectified pair:
    abc_k [K, 3, Hr, Wr] -> [K, Hr, Wr].

    The layout of src_chw picks the path, as in the JAX package: census
    (any layout; image channels only); [C] image words — window_grads
    (fused kernel or unfused gathers); [2C] packed words — grad_fwd; [3C]
    — full channels, packed or f32.  The last two scan the window offsets,
    one lerp gather launch per offset serving all K candidates.
    disp_bounds: float32 [2] disparity clamp on the device (None: no clamp
    on the scan, (-1e9, 1e9) on the sampled-row paths); hw_valid / tile_ok
    skip fused-kernel work (outputs there unspecified)."""
    if params.algorithm == MatchingAlgorithm.CENSUS:
        return _rect_pair_cost_batch_census(ref_chw, src_chw, abc_k, params,
                                            disp_bounds)
    ch, hr, wr = ref_chw.shape
    C = ch // 3
    K = abc_k.shape[0]
    sch = src_chw.shape[0]
    if sch == C:
        return _rect_pair_cost_batch_sdg(ref_chw, src_chw, abc_k, params,
                                         disp_bounds, hw_valid, tile_ok)
    # [2C] int32 = grad_fwd packing ([img-taps, gy-taps], gx in-kernel).
    grad_fwd = sch == 2 * C
    dev = ref_chw.device
    xg, yg = _iotas(hr, wr, dev)
    ref_center = ref_chw[:C]
    inv_gamma = 1.0 / params.gamma
    alpha = params.alpha
    a, b, c = abc_k[:, 0], abc_k[:, 1], abc_k[:, 2]
    acc = torch.zeros((K, hr, wr), dtype=torch.float32, device=dev)
    for dx, dy in params.window_offsets():
        ref_w = _shift2d(ref_chw, dy, dx)
        xs = xg + float(dx)
        disp = a * xs + b * (yg + float(dy)) + c              # [K, Hr, Wr]
        if disp_bounds is not None:
            disp = _clip(disp, disp_bounds[0], disp_bounds[1])
        smp = row_gather_batch(src_chw, xs - disp, grad_fwd=grad_fwd,
                               src_dy=dy)                    # [K, 3C, Hr, Wr]
        w = torch.exp(-_l1(ref_w[:C] - ref_center) * inv_gamma)
        col = torch.clamp(_l1(ref_w[None, :C] - smp[:, :C]),
                          max=params.tau_color)
        grad = torch.clamp(
            (_l1(ref_w[None, C:2 * C] - smp[:, C:2 * C])
             + _l1(ref_w[None, 2 * C:] - smp[:, 2 * C:])) * 0.0625,
            max=params.tau_gradient)
        acc = acc + w[None] * ((1.0 - alpha) * col + alpha * grad)
    return torch.where(torch.isnan(acc) | (acc >= MAXCOST), MAXCOST, acc)


def _apply_L(Lv: torch.Tensor, m_rect: torch.Tensor) -> torch.Tensor:
    """abc[k, i] = sum_j L[i, j] m[k, j], written elementwise (no matmul
    precision mode is involved)."""
    return torch.stack([Lv[i, 0] * m_rect[:, 0] + Lv[i, 1] * m_rect[:, 1]
                        + Lv[i, 2] * m_rect[:, 2] for i in range(3)], dim=1)


def rect_per_view_costs(scene: RectScene, params: AlgorithmParams,
                        parity: int, n: torch.Tensor, d: torch.Tensor
                        ) -> torch.Tensor:
    """Per-view costs of one candidate: n [H, W2, 3], d [H, W2] ->
    [V, H, W2]."""
    return rect_per_view_costs_batch(scene, params, parity,
                                     n[None], d[None])[:, 0]


def rect_per_view_costs_batch(scene: RectScene, params: AlgorithmParams,
                              parity: int, n: torch.Tensor, d: torch.Tensor,
                              m_pack: str | None = None,
                              cost_pack: bool = False,
                              extra_mask: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Per-view costs for K candidates: n [K, H, W2, 3], d [K, H, W2] ->
    [V, K, H, W2].

    m_pack: forward-permute plane packing — None derives "pair"
    (config.rect_pack_m) or "none"; "tri" = all-f16 (sparse cull pass).
    cost_pack: return the per-view costs through the return permute as f16
    pairs (sparse cull pass).  extra_mask ([H, W2] bool,
    config.cull_early_term): pixels that need evaluation; it rides the
    forward permute as one extra channel, rect tiles without a flagged
    target skip the fused kernel, and masked-off pixels report MAXCOST."""
    K = n.shape[0]
    dev = n.device
    if m_pack is None:
        m_pack = "pair" if params.rect_pack_m else "none"
    m = n / d[..., None]                                   # [K, H, W2, 3]
    m_full = torch.repeat_interleave(m, 2, dim=2)          # [K, H, W, 3]
    m_chw = m_full.permute(0, 3, 1, 2)                     # [K, 3, H, W]
    if m_pack == "pair":
        m_ch = _pack_m(m_chw).reshape(2 * K, *m_chw.shape[2:])
    elif m_pack == "tri":
        m_ch = _pack_m_tri(m_chw)
    else:
        m_ch = m_chw.reshape(3 * K, *m_chw.shape[2:])
    CH = m_ch.shape[0]
    if extra_mask is not None:
        em = torch.repeat_interleave(extra_mask.to(m_ch.dtype), 2, dim=1)
        m_ch = torch.cat([m_ch, em[None]], dim=0)
    h, w = m_full.shape[1:3]
    s = scene.fwd_c1.shape[-2]

    rots: dict[int, torch.Tensor] = {}

    def rot_pad(k: int) -> torch.Tensor:
        if k not in rots:
            rk = torch.rot90(m_ch, k, dims=(-2, -1))
            out = rk.new_zeros((rk.shape[0], s, s))
            out[:, :rk.shape[-2], :rk.shape[-1]] = rk
            rots[k] = out
        return rots[k]

    rp = cb.row_parity(h, parity, dev)[None]               # [1, H, 1]
    hrp, wrp = scene.ref_rect.shape[-2:]
    footprint = scene.tile_ok is not None and params.rect_footprint_skip
    pskip = (params.rect_permute_skip and params.rect_footprint_skip
             and params.pack_taps and params.window_grads
             and scene.tile_ok is not None
             and scene.fwd2_ok is not None and scene.ret2_ok is not None)

    costs = []
    for v, (kv, ok) in enumerate(zip(scene.rotations(),
                                     scene.valid_views())):
        if not ok:   # invalid view: MAXCOST, as the combine would force
            costs.append(torch.full((K, h, w // 2), MAXCOST,
                                    dtype=torch.float32, device=dev))
            continue
        m_rect = permute2d(rot_pad(kv), scene.fwd_c1[v], scene.fwd_r[v],
                           mask2=scene.fwd2_ok[v] if pskip else None)
        tmv = scene.tile_ok[v] if footprint else None
        if extra_mask is not None:
            # Dynamic kernel-tile mask: a tile runs iff any of its slots
            # carries a flagged pixel (AND'd with the footprint mask).
            flag = m_rect[CH]
            fr8 = flag.reshape(hrp // 8, 8, wrp // 128, 128)
            dyn = (fr8.amax(dim=(1, 3)) > 0).to(torch.int32)
            tmv = dyn if tmv is None else tmv * dyn
            m_rect = m_rect[:CH]
        if m_pack == "pair":
            m_rect = _unpack_m(m_rect.reshape(K, 2, *m_rect.shape[1:]))
        elif m_pack == "tri":
            m_rect = _unpack_m_tri(m_rect, K)
        else:
            m_rect = m_rect.reshape(K, 3, *m_rect.shape[1:])
        abc = _apply_L(scene.L[v], m_rect).contiguous()    # [K, 3, Hrp, Wrp]
        cost_rect = rect_pair_cost_batch(
            scene.ref_rect[v], scene.src_rect[v], abc, params,
            scene.disp_bounds[v],
            hw_valid=None if scene.hw_valid is None else scene.hw_valid[v],
            tile_ok=tmv)
        if cost_pack:
            cost_rect = _pack_f16_pairs(cost_rect)
        cost_sq = permute2d(cost_rect, scene.ret_c1[v], scene.ret_r[v],
                            mask2=scene.ret2_ok[v] if pskip else None)
        hk, wk = (w, h) if kv % 2 else (h, w)
        cost_full = torch.rot90(cost_sq[:, :hk, :wk], (-kv) % 4, dims=(1, 2))
        cost_act = torch.where(rp == 0, cost_full[:, :, 0::2],
                               cost_full[:, :, 1::2])      # [Kc, H, W2]
        if cost_pack:
            cost_act = _unpack_f16_pairs(cost_act, K)
        if extra_mask is not None:
            cost_act = torch.where(extra_mask[None], cost_act, MAXCOST)
        cost_act = torch.where(torch.isnan(cost_act) | (cost_act >= MAXCOST)
                               | (scene.view_valid[v] == 0.0), MAXCOST,
                               cost_act)
        costs.append(cost_act)
    return torch.stack(costs)                              # [V, K, H, W2]


def rect_multiview_cost(scene: RectScene, params: AlgorithmParams,
                        parity: int, n: torch.Tensor, d: torch.Tensor
                        ) -> torch.Tensor:
    """pmCostMultiview on the rectified path — the engine's cost_fn."""
    return combine_view_costs(
        rect_per_view_costs(scene, params, parity, n, d), params,
        view_valid=scene.view_valid)


def rect_multiview_cost_batch(scene: RectScene, params: AlgorithmParams,
                              parity: int, n: torch.Tensor, d: torch.Tensor,
                              cand_ok: torch.Tensor | None = None,
                              cur: tuple | None = None) -> torch.Tensor:
    """Combined multiview cost for K stacked candidates: [K, H, W2].

    With config.rect_two_stage_cull (and K > 1): a sparse-window screening
    pass ranks the K candidates per pixel (cull_box at cull_increment, on
    every cull_view_stride-th view), the full window is evaluated only for
    each pixel's sparse winner (first minimum), and the losers report
    MAXCOST.  The sparse pass runs on ``scene.cull`` (config.cull_downscale:
    downscaled, already view-strided) when the scene has one; its ranking
    masks stay on the full-resolution state grid.  cur = (n_now, d_now)
    joins the sparse pass under
    config.cull_early_term; pixels whose best candidate does not beat it
    (plus cull_early_slack) skip the full pass."""
    K = n.shape[0]
    if (K > 1 and params.rect_two_stage_cull
            and params.pack_taps and params.window_grads):
        sp = params.replace(box_hsize=int(params.cull_box),
                            box_vsize=int(params.cull_box),
                            window_increment=int(params.cull_increment))
        stride = max(1, int(params.cull_view_stride))
        if scene.cull is not None:
            sc_s = scene.cull
        else:
            sc_s = scene if stride == 1 else _slice_views(scene, stride)
        cpk = bool(params.cull_pack)
        early = cur is not None and params.cull_early_term
        n_s, d_s = n, d
        if early:
            n_s = torch.cat([n, cur[0][None]], dim=0)
            d_s = torch.cat([d, cur[1][None]], dim=0)
        c_all = combine_view_costs(
            rect_per_view_costs_batch(sc_s, sp, parity, n_s, d_s,
                                      m_pack="tri" if cpk else None,
                                      cost_pack=cpk), sp,
            view_valid=sc_s.view_valid)                     # [K(+1), H, W2]
        c_s = c_all[:K]
        h = scene.rays.shape[0]
        w2 = scene.rays.shape[1] // 2
        dev = n.device
        x = cb.active_x(h, w2, parity, device=dev)
        y = cb.active_y(h, w2, device=dev) + scene.row_offset.to(torch.float32)
        depth_all = T.depth_from_plane(n, d, x, y, scene.fx, scene.cx,
                                       scene.cy, scene.alpha_focal)
        in_range = ((depth_all >= scene.depth_min)
                    & (depth_all <= scene.depth_max))
        if cand_ok is not None:
            in_range = in_range & cand_ok
        c_msk = torch.where(in_range, c_s, MAXCOST + 1.0)
        kb = torch.argmin(c_msk, dim=0)                     # first minimum
        need_full = None
        if early:
            need_full = c_msk.amin(dim=0) <= c_all[K] + float(
                params.cull_early_slack)
        n_sel = torch.gather(n, 0, kb[None, :, :, None].expand(1, h, w2, 3))
        d_sel = torch.gather(d, 0, kb[None])
        c_f = combine_view_costs(
            rect_per_view_costs_batch(scene, params, parity, n_sel, d_sel,
                                      extra_mask=need_full),
            params, view_valid=scene.view_valid)            # [1, H, W2]
        kk = torch.arange(K, device=dev)[:, None, None]
        return torch.where(kk == kb[None], c_f, MAXCOST)
    return combine_view_costs(
        rect_per_view_costs_batch(scene, params, parity, n, d), params,
        view_valid=scene.view_valid)


# The engine (models/patchmatch._fold_better) uses the `batch` attribute to
# evaluate all propagation candidates in one pass.
rect_multiview_cost.batch = rect_multiview_cost_batch
# ... and, under config.refine_batched, all refinement rounds of a sweep in
# one batch (models/patchmatch.refinement_sweep), as the JAX package does
# for this cost.
rect_multiview_cost.batched_refinement = True
