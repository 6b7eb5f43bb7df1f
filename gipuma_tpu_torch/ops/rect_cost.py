"""Rectified-frame multiview cost — the main path's cost function.

Counterpart of ``gipuma_tpu/ops/rect_cost.py:180-336,475-1010`` on the
window_grads path (packed taps, fused window cost).  The PatchMatch state
stays on the reference grid; per-candidate plane vectors m = n/d are
carried to each pair's rect grid, and per-view costs carried back, by
static 2-pass permutations (ops/permute2d.py, kernel 1); the window cost
on the rect grid is the fused kernel (ops/sdg_fused.py, kernel 2).

The JAX package scans the view axis with ``lax.scan``; here the view loop
is a Python loop with one launch of each kernel per pass and view.  Per-
view scalars (the disparity clamp, the valid extent, the view's validity)
stay on the device; the only host values are static: the rotation counts
(``rot_k_host``) and the span bounds (``spans.shape``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MAXCOST, AlgorithmParams, MatchingAlgorithm
from ..geometry import transforms as T
from . import checkerboard as cb
from .cost import ScenePack, combine_view_costs
from .permute2d import permute2d
from .sdg_fused import _to_i32, fused_sdg_cost_batch


class RectScene(NamedTuple):
    """ScenePack + per-pair rectified data, stacked over the view axis and
    padded to a common rect shape [Hrp, Wrp] (Wrp % 128 == 0).  Exposes
    the base scene's engine-facing fields as properties.  S = max(H, W):
    the k*90-degree-rotated reference grid padded to a square."""

    base: ScenePack
    ref_rect: torch.Tensor   # [V, 3C, Hrp, Wrp] rect-ref channels
    src_rect: torch.Tensor   # [V, C, Hrp, Wrp] int32 packed src tap words
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
    ret1_ok: torch.Tensor = None   # [V, ceil(Hrp/8), ceil(S/128)]
    fwd1_ok: torch.Tensor = None   # [V, ceil(S/8), Wrp/128]
    ret2_ok: torch.Tensor = None   # [V, ceil(S/8), ceil(S/128)]
    cull: "RectScene" = None       # cull_downscale scene: a later slice
    # Host copy of rot_k (python ints): picks each view's rotation without
    # a device sync.
    rot_k_host: tuple = ()

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
        fwd2_ok=sl(scene.fwd2_ok), ret1_ok=sl(scene.ret1_ok),
        fwd1_ok=sl(scene.fwd1_ok), ret2_ok=sl(scene.ret2_ok),
        rot_k_host=tuple(scene.rotations()[::stride]))


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


def rect_pair_cost_batch(ref_chw, src_chw, abc_k, params: AlgorithmParams,
                         disp_bounds, hw_valid=None, tile_ok=None):
    """Window cost of K candidate fields on one rectified pair:
    abc_k [K, 3, Hr, Wr] -> [K, Hr, Wr] (window_grads path: src_chw holds
    only the packed image tap words; disp_bounds [2] = the disparity clamp
    on the device).  The other rect cost paths (census, full channels,
    grad_fwd, unfused) are a later slice of the port."""
    C = ref_chw.shape[0] // 3
    if (params.algorithm == MatchingAlgorithm.CENSUS
            or src_chw.shape[0] != C or src_chw.dtype != torch.int32
            or not params.fused_window_cost):
        raise NotImplementedError(
            "only the packed window_grads fused rect cost is ported; the "
            "census and non-fused rect paths are a later slice")
    return fused_sdg_cost_batch(ref_chw, src_chw, abc_k, params,
                                hw_valid=hw_valid, tile_ok=tile_ok,
                                disp_bounds=disp_bounds)


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
             and scene.fwd2_ok is not None and scene.ret1_ok is not None)
    pskip2 = pskip and scene.fwd1_ok is not None \
        and scene.ret2_ok is not None

    costs = []
    for v, kv in enumerate(scene.rotations()):
        m_rect = permute2d(rot_pad(kv), scene.fwd_c1[v], scene.fwd_r[v],
                           mask1=scene.fwd1_ok[v] if pskip2 else None,
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
                            mask1=scene.ret1_ok[v] if pskip else None,
                            mask2=scene.ret2_ok[v] if pskip2 else None)
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
    MAXCOST.  cur = (n_now, d_now) joins the sparse pass under
    config.cull_early_term; pixels whose best candidate does not beat it
    (plus cull_early_slack) skip the full pass."""
    K = n.shape[0]
    if (K > 1 and params.rect_two_stage_cull
            and params.pack_taps and params.window_grads):
        if scene.cull is not None:
            raise NotImplementedError(
                "cull_downscale screening scenes are a later slice")
        sp = params.replace(box_hsize=int(params.cull_box),
                            box_vsize=int(params.cull_box),
                            window_increment=int(params.cull_increment))
        stride = max(1, int(params.cull_view_stride))
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
