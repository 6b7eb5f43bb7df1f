"""gipuma_tpu_torch CUDA kernels against their plain torch versions, on the
card.  Skips (with the reason) where no CUDA device is present; imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Tolerances: the nearest gather and the one-pass permutation are
bit-equal at masked-on coordinates; the fused window cost agrees to 1e-3
abs at covered pixels (the plain version rounds the weight and the window
sums in another order, and the kernel contracts to FMA); the exact PM
cost's window sum agrees to 1e-4 abs where finite and puts MAXCOST at the
same places (it sums the offsets in another order); its warp prologue is
bit-equal to warped_coords, and the exact costs with it to the costs
with warped_coords; the bilinear
sampler and the lerp and affine row gathers are bit-equal (NaN where the
plain version gives NaN), the affine gather's rows launch also to the
stack of its one-row launches."""
import numpy as np
import pytest
import torch

from gipuma_tpu_torch.config import MAXCOST, AlgorithmParams
from gipuma_tpu_torch.ops import checkerboard as tcb
from gipuma_tpu_torch.ops import cost as tco
from gipuma_tpu_torch.ops import permute2d as tpm
from gipuma_tpu_torch.ops import rowgather as trg
from gipuma_tpu_torch.ops import sampling as tsm
from gipuma_tpu_torch.ops import sdg_fused as tsf

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_row_gather_kernel_matches_plain(cuda_device, dtype):
    g = torch.Generator().manual_seed(0)
    src = torch.randint(-2**31, 2**31 - 1, (3, 40, 256), generator=g,
                        dtype=torch.int64).to(torch.int32).view(dtype)
    x = torch.rand((2, 40, 200), generator=g) * 260 - 2
    tm = torch.tensor([[1, 0], [0, 1], [1, 1], [0, 0], [1, 0]],
                      dtype=torch.int32)
    src, x, tm = src.to(cuda_device), x.to(cuda_device), tm.to(cuda_device)
    want = trg.row_gather_nearest_plain(src, x).view(torch.int32)
    got = trg.row_gather_nearest_cuda(src, x).view(torch.int32)
    assert torch.equal(got, want)
    got_m = trg.row_gather_nearest_cuda(src, x, tm).view(torch.int32)
    on = tm.bool().repeat_interleave(8, 0).repeat_interleave(128, 1)[:, :200]
    assert torch.equal(got_m[..., on], want[..., on])


def _inputs(seed, C, hr, wr, K):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0.0, 255.0, size=(3 * C, hr, wr)).astype(np.float32)
    src = rng.uniform(0.0, 255.0, size=(C, hr, wr)).astype(np.float32)
    coef = rng.uniform(-0.05, 0.05, size=(K, 3, 1, 1)).astype(np.float32)
    abc = np.broadcast_to(coef, (K, 3, hr, wr)).copy()
    abc[:, 2] += 10.0
    return ref, trg.pack_taps(src), abc


@pytest.mark.parametrize("C,K,box,inc,onesided", [(1, 4, 11, 2, True),
                                                  (1, 4, 9, 4, True),
                                                  (3, 2, 7, 2, False),
                                                  (1, 1, 25, 2, False)])
def test_fused_kernel_matches_plain(cuda_device, C, K, box, inc, onesided):
    ref, src, abc = _inputs(7, C, 40, 384, K)
    p = AlgorithmParams(box_hsize=box, box_vsize=box, window_increment=inc,
                        sdg_onesided_edges=onesided)
    dev = cuda_device
    ref_t = torch.from_numpy(ref).to(dev)
    src_t = torch.from_numpy(src).to(dev)
    abc_t = torch.from_numpy(abc).to(dev)
    db = torch.tensor([-20.0, 40.0], device=dev)
    want = tsf.fused_sdg_cost_batch_plain(ref_t, src_t, abc_t, p, db[0],
                                          db[1])
    got = tsf.fused_sdg_cost_batch_cuda(ref_t, src_t, abc_t, p, db)
    assert float((got - want).abs().max()) <= 1e-3
    # hw_valid / tile_ok: covered pixels unchanged.
    hwv = torch.tensor([30, 256], dtype=torch.int32, device=dev)
    tm = torch.ones((5, 3), dtype=torch.int32, device=dev)
    tm[1, 0] = 0
    got_m = tsf.fused_sdg_cost_batch_cuda(ref_t, src_t, abc_t, p, db, hwv, tm)
    cov = tm.bool().repeat_interleave(8, 0).repeat_interleave(128, 1)
    cov[32:] = False
    cov[:, 256:] = False
    assert torch.equal(got_m[:, cov], got[:, cov])


# The tile kernel's windows (T in {3, 4, 6}: box 9 / inc 4, box 7 / inc 2,
# box 11 / inc 2 one-sided), the same boxes with the extension ring (T 5, 6,
# 8: generic but for box 7), and box 25 (T 13: the generic kernel).
@pytest.mark.parametrize("box,inc,onesided", [
    (7, 2, True), (9, 4, True), (11, 2, True), (7, 2, False), (9, 4, False),
    (11, 2, False), (25, 2, True)])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("C", [1, 3])
def test_fused_tile_kernel_matches_plain(cuda_device, C, K, box, inc,
                                         onesided):
    """Every tile of a 37 x 384 grid touches an image border (the last
    row tile is partial); per-pixel planes, a NaN plane pixel (MAXCOST),
    and hw_valid / tile_ok skips checked at covered pixels."""
    hr, wr = 37, 384
    rng = np.random.default_rng(11)
    ref, src, abc = _inputs(5, C, hr, wr, K)
    abc = abc + rng.normal(0.0, 0.003, size=abc.shape).astype(np.float32)
    abc[K - 1, 0, 4, 200] = np.nan
    p = AlgorithmParams(box_hsize=box, box_vsize=box, window_increment=inc,
                        sdg_onesided_edges=onesided)
    dev = cuda_device
    ref_t = torch.from_numpy(ref).to(dev)
    src_t = torch.from_numpy(src).to(dev)
    abc_t = torch.from_numpy(abc).to(dev)
    db = torch.tensor([-20.0, 40.0], device=dev)
    want = tsf.fused_sdg_cost_batch_plain(ref_t, src_t, abc_t, p, db[0],
                                          db[1])
    got = tsf.fused_sdg_cost_batch_cuda(ref_t, src_t, abc_t, p, db)
    assert float((got - want).abs().max()) <= 1e-3
    assert float(got[K - 1, 4, 200]) == MAXCOST
    hwv = torch.tensor([30, 256], dtype=torch.int32, device=dev)
    tm = torch.ones((5, 3), dtype=torch.int32, device=dev)
    tm[0, 1] = 0
    tm[2, 0] = 0
    got_m = tsf.fused_sdg_cost_batch_cuda(ref_t, src_t, abc_t, p, db, hwv, tm)
    cov = tm.bool().repeat_interleave(8, 0).repeat_interleave(128, 1)[:hr]
    cov[32:] = False
    cov[:, 256:] = False
    assert float((got_m[:, cov] - want[:, cov]).abs().max()) <= 1e-3


@pytest.mark.parametrize("onesided", [True, False])
def test_fused_kernel_reference_from_global_memory(cuda_device, onesided):
    """C=3 at box 41 / inc 4: the reference tile with its halo, 48 x 168 x
    9 floats (290 KB), exceeds the shared memory of an SM, so the generic
    kernel reads the reference window from global memory; held to
    the plain version like every window, with hw_valid / tile_ok skips."""
    C, K, hr, wr, box, inc = 3, 2, 37, 384, 41, 4
    tile_bytes = 3 * C * (8 + 2 * (box // 2)) * (128 + 2 * (box // 2)) * 4
    # No block gets more shared memory than its SM has.
    assert tile_bytes > torch.cuda.get_device_properties(
        cuda_device).shared_memory_per_multiprocessor
    ref, src, abc = _inputs(9, C, hr, wr, K)
    p = AlgorithmParams(box_hsize=box, box_vsize=box, window_increment=inc,
                        sdg_onesided_edges=onesided)
    dev = cuda_device
    ref_t = torch.from_numpy(ref).to(dev)
    src_t = torch.from_numpy(src).to(dev)
    abc_t = torch.from_numpy(abc).to(dev)
    db = torch.tensor([-20.0, 40.0], device=dev)
    want = tsf.fused_sdg_cost_batch_plain(ref_t, src_t, abc_t, p, db[0],
                                          db[1])
    got = tsf.fused_sdg_cost_batch_cuda(ref_t, src_t, abc_t, p, db)
    assert float((got - want).abs().max()) <= 1e-3
    hwv = torch.tensor([30, 256], dtype=torch.int32, device=dev)
    tm = torch.ones((5, 3), dtype=torch.int32, device=dev)
    tm[1, 1] = 0
    got_m = tsf.fused_sdg_cost_batch_cuda(ref_t, src_t, abc_t, p, db, hwv, tm)
    cov = tm.bool().repeat_interleave(8, 0).repeat_interleave(128, 1)[:hr]
    cov[32:] = False
    cov[:, 256:] = False
    assert float((got_m[:, cov] - want[:, cov]).abs().max()) <= 1e-3


def _permute_case(seed):
    """Tables of a smooth rotation-and-scale map (300 x 260 -> 280 x 330)
    with a NaN entry in each table, and a tile mask drawn at random."""
    in_h, in_w, out_h, out_w = 300, 260, 280, 330
    ys, xs = np.meshgrid(np.arange(out_h), np.arange(out_w), indexing="ij")
    s, c = np.sin(0.1), np.cos(0.1)
    R = np.clip(np.round(0.9 * (s * xs + c * ys) + 3.0), 0, in_h - 1)
    C = np.clip(np.round(0.9 * (c * xs - s * ys) + 20.0), 0, in_w - 1)
    t = tpm.build_tables(R.astype(np.int64), C.astype(np.int64), in_h, in_w)
    c1, r = t.c1.copy(), t.r.copy()
    c1[7, 9] = np.nan
    r[11, 13] = np.nan
    rng = np.random.default_rng(seed)
    m2 = rng.integers(0, 2, size=(-(-out_w // 8), -(-out_h // 128)),
                      dtype=np.int64).astype(np.int32)
    return in_h, in_w, c1, r, m2


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_permute2d_kernel_matches_plain(cuda_device, dtype, masked):
    """Bit-equal at consumed coordinates (the outputs of masked-on tiles),
    NaN table entries included."""
    in_h, in_w, c1, r, m2 = _permute_case(5)
    g = torch.Generator().manual_seed(6)
    x = torch.randint(-2**31, 2**31 - 1, (3, in_h, in_w), generator=g,
                      dtype=torch.int64).to(torch.int32).view(dtype)
    dev = cuda_device
    x, c1, r = x.to(dev), torch.from_numpy(c1).to(dev), \
        torch.from_numpy(r).to(dev)
    m2 = torch.from_numpy(m2).to(dev) if masked else None
    want = tpm.permute2d_plain(x, c1, r).view(torch.int32)
    got = tpm.permute2d(x, c1, r, mask2=m2)
    assert got.shape == want.shape and got.dtype == dtype
    assert got.is_contiguous()
    got = got.view(torch.int32)
    if masked:
        on = m2.bool().repeat_interleave(8, 0).repeat_interleave(128, 1)
        on = on[:r.shape[1], :r.shape[0]].t()
        assert torch.equal(got[:, on], want[:, on])
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("C", [1, 3, 9])
def test_sampler_kernel_matches_plain(cuda_device, C):
    """Bit-equal: the kernel rounds each product and sum on its own, in the
    plain version's order; coordinates reach 20 px outside the image, and a
    NaN coordinate gives NaN, as in the plain version."""
    g = torch.Generator().manual_seed(C)
    src = torch.rand((C, 48, 200), generator=g) * 255
    x = torch.rand((3, 40, 96), generator=g) * 240 - 20
    y = torch.rand((3, 40, 96), generator=g) * 88 - 20
    x[1, 2, 3] = float("nan")
    src, x, y = src.to(cuda_device), x.to(cuda_device), y.to(cuda_device)
    want = tsm.bilinear_sample_plain(src, x, y)
    got = tsm.bilinear_sample_cuda(src, x, y)
    assert torch.isnan(got[1, :, 2, 3]).all()
    assert torch.equal(got.nan_to_num(-1.0), want.nan_to_num(-1.0))


def _sampler_field(g, B, kind, H=48, W=200, Hs=7, Ws=45):
    """Positions x, y [B, Hs, Ws] (Hs * Ws = 315 pixels: no whole number
    of 32-pixel tiles) at B window offsets laid out as the PM path lays
    them out (dx-major, 8 rows a column).  "smooth": every pixel the
    identity warp of its place (2 j + i % 2, 5 i) plus the offset, so
    neighbouring pixels read neighbouring texels; "planes": every pixel
    its own random affine window (centre up to 20 px outside the image,
    scale and shear up to 3).  A NaN in the first and the last row."""
    k = torch.arange(B)
    dx, dy = (k // 8 % 8 * 2 - 7).float(), (k % 8 * 2 - 7).float()
    if kind == "smooth":
        i = torch.arange(Hs).float()[:, None]
        cx = (2 * torch.arange(Ws).float()[None] + i.remainder(2))
        cy = (5 * i).expand(Hs, Ws)
        a, b, c, d = 1.0, 0.0, 0.0, 1.0
    else:
        cx = torch.rand((Hs, Ws), generator=g) * (W + 40) - 20
        cy = torch.rand((Hs, Ws), generator=g) * (H + 40) - 20
        a, b, c, d = (torch.rand((Hs, Ws), generator=g) * 6 - 3
                      for _ in range(4))
    x = cx + a * dx[:, None, None] + b * dy[:, None, None]
    y = cy + c * dx[:, None, None] + d * dy[:, None, None]
    x[0, 1, 2] = float("nan")
    y[-1, -1, -1] = float("nan")
    return x.contiguous(), y.contiguous()


@pytest.mark.parametrize("kind", ["smooth", "planes"])
@pytest.mark.parametrize("C", [1, 3, 9])
@pytest.mark.parametrize("B", [1, 31, 32, 36, 64, 120, 144])
def test_sampler_routes_match_plain(cuda_device, B, C, kind):
    """Every route of the kernel (one thread a sample, the 32- and 64-row
    tiles) is bit-equal to the plain version, NaN for NaN, at any B (the
    tiles' last rows ragged), over pixels that fill no whole tile, with
    coordinates NaN and 20 px outside the image; the route the shape
    picks too."""
    g = torch.Generator().manual_seed(B * 10 + C)
    src = (torch.rand((C, 48, 200), generator=g) * 255).to(cuda_device)
    x, y = (t.to(cuda_device) for t in _sampler_field(g, B, kind))
    want = tsm.bilinear_sample_plain(src, x, y)
    assert torch.isnan(want[0, :, 1, 2]).all()
    for route in tsm.SAMPLER_ROUTES:
        assert _same(tsm.bilinear_sample_on_route(src, x, y, route), want)
    assert _same(tsm.bilinear_sample_cuda(src, x, y), want)


def test_sampler_tiled_count_follows_the_route_rule(cuda_device):
    """kernels.counts["bilinear_sample_tiled"] counts exactly the calls
    with B >= 32, one launch a call either way; CENSUS's centre sample (B
    = the chunk's candidates) takes the one-thread-a-sample route and its
    window (B = candidates x 120 offsets) a tile."""
    from gipuma_tpu_torch import kernels
    from gipuma_tpu_torch.config import MatchingAlgorithm
    g = torch.Generator().manual_seed(17)
    src = (torch.rand((3, 48, 200), generator=g) * 255).to(cuda_device)
    x, y = (t.to(cuda_device) for t in _sampler_field(g, 144, "planes"))
    Bs = (1, 31, 32, 36, 64, 120, 144)
    kernels.reset_counts()
    for B in Bs:
        tsm.bilinear_sample_cuda(src, x[:B], y[:B])
    assert kernels.counts["bilinear_sample"] == len(Bs)
    assert kernels.counts["bilinear_sample_tiled"] == 5
    sc, p, gt = _exact_scene(cuda_device, 1, 11, 2)
    n, d = _exact_planes(sc, gt, 4, seed=3)
    na, da = _half_planes(n, d, 0)
    kernels.reset_counts()
    tco.per_view_costs_batch(
        sc, p.replace(algorithm=MatchingAlgorithm.CENSUS), 0, na, da)
    torch.cuda.synchronize()
    assert kernels.counts["bilinear_sample"] == 2 * sc.num_views
    assert kernels.counts["bilinear_sample_tiled"] == sc.num_views


def _exact_scene(dev, C, box, inc, h=48, w=64):
    """An exact-path scene on the card: a slanted noise-textured plane seen
    by 3 source views (C = 3: three distinct channels), padded to 4 views
    (view 3 has view_valid 0), and its ground-truth depth."""
    from gipuma_tpu_torch.models import scene as tscene
    from gipuma_tpu_torch.utils.synthetic import plane_scene
    images, rig, gt, _ = plane_scene(num_cams=4, h=h, w=w, focal=80.0,
                                     plane_depth=5.0, slant=(0.2, -0.1),
                                     texture="noise")
    if C == 3:
        images = [np.stack([im, 0.8 * im + 20.0, 255.0 - im], -1)
                  .astype(np.float32) for im in images]
    p = AlgorithmParams(box_hsize=box, box_vsize=box, window_increment=inc)
    sc = tscene.build_scene(images, rig, [1, 2, 3], p, 3.0, 8.0, device=dev)
    return tscene.pad_scene_views(sc, 4), p, torch.from_numpy(gt)


def _exact_planes(sc, gt, K, seed):
    """K planes per pixel [K, H, W, 3] / [K, H, W]: candidate 0 near the
    true plane (depth within 1%), the others random at depths in [3, 8]."""
    from gipuma_tpu_torch.geometry import transforms as T
    dev = sc.rays.device
    g = torch.Generator().manual_seed(seed)
    h, w = gt.shape
    n = torch.randn((K, h, w, 3), generator=g)
    depth = torch.rand((K, h, w), generator=g) * 5.0 + 3.0
    depth[0] = gt * (1.0 + 0.01 * torch.randn((h, w), generator=g))
    n = T.flip_to_hemisphere(T.normalize(n.to(dev), eps=1e-20), sc.view_vec)
    x, y = T.pixel_grid(h, w, device=dev)
    return n, T.plane_d_at_pixel(sc.M_inv, sc.P_col4, n, x, y,
                                 depth.to(dev))


def _window_costs(sc, p, parity, n, d, nan_at=None):
    """Every view's samples of the K candidates (n, d on the full grid),
    then the kernel's and the plain version's window sums: [V, K, H, W2]
    each.  nan_at (k, o, i, j): a NaN x coordinate planted there."""
    offsets = tco.window_offsets(p)
    K = n.shape[0]
    na = torch.stack([tcb.extract(n[k], parity) for k in range(K)])
    da = torch.stack([tcb.extract(d[k], parity) for k in range(K)])
    warp = tco._plane_terms(sc, parity, na, da)
    ref, gx, gy, table = tco.exact_window_inputs(sc, offsets, da.device)
    terms = tco.pm_reference_terms(sc, p, offsets, parity)
    got, want = [], []
    for v in range(sc.num_views):
        xw, yw = tco.warped_coords(sc, v, warp, offsets)
        if nan_at is not None:
            k, o, i, j = nan_at
            xw[k * len(offsets) + o, i, j] = float("nan")
        smp = tsm.bilinear_sample(sc.src[v], xw, yw)
        out = torch.empty_like(da)
        tco.exact_window_cost_cuda(smp, ref, gx, gy, table, sc.view_valid,
                                   v, out, parity, sc.ref_img.pr,
                                   sc.ref_img.pc, p)
        got.append(out)
        want.append(tco.pm_window_cost_plain(smp, terms, p,
                                             sc.view_valid[v]))
    return torch.stack(got), torch.stack(want)


def _costs_agree(got, want):
    bad = want >= MAXCOST
    assert torch.equal(got >= MAXCOST, bad)
    assert bool((got[bad] == MAXCOST).all())
    assert (~bad).any()
    assert float((got - want).abs()[~bad].max()) <= 1e-4


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("box,inc", [(11, 2), (15, 2), (9, 1)])
@pytest.mark.parametrize("C", [1, 3])
def test_exact_window_cost_kernel_matches_plain(cuda_device, C, box, inc, K,
                                                parity):
    """csrc/exact_cost.cu against pm_window_cost_plain at the presets'
    windows (O = 36 and 64, the compiled loops at C = 1) and at box 9 /
    increment 1 (81 offsets of both dx parities, the generic loop): a NaN
    coordinate planted in candidate K-1's window ends at MAXCOST, and the
    padded view 3 is MAXCOST everywhere."""
    sc, p, gt = _exact_scene(cuda_device, C, box, inc)
    n, d = _exact_planes(sc, gt, K, seed=10 * box + K + parity)
    got, want = _window_costs(sc, p, parity, n, d, nan_at=(K - 1, 2, 5, 7))
    _costs_agree(got, want)
    assert bool((got[:3, K - 1, 5, 7] == MAXCOST).all())
    assert bool((got[3] == MAXCOST).all())


@pytest.mark.parametrize("parity", [0, 1])
def test_exact_window_cost_row_band(cuda_device, parity):
    """A row band (rows 16..31 of 48, row_offset 16) whose reference planes
    carry real halo rows (PaddedEO.build_row_padded), as tile sharding
    builds it: the kernel against its plain version, and bit-equal to the
    whole scene's kernel costs at the band's rows."""
    sc, p, gt = _exact_scene(cuda_device, 1, 11, 2)
    n, d = _exact_planes(sc, gt, 4, seed=5 + parity)
    r0, hb = 16, 16
    pr = sc.ref_img.pr

    def band(eo):
        full = torch.stack([eo.E, eo.O], 2).reshape(eo.E.shape[0], -1,
                                                    eo.E.shape[-1])
        full = full[pr:-pr, eo.pc:full.shape[1] - eo.pc]
        rows = torch.arange(r0 - pr, r0 + hb + pr,
                            device=full.device).clamp(0, full.shape[0] - 1)
        return tcb.PaddedEO.build_row_padded(full[rows], pr, eo.pc)

    rs = slice(r0, r0 + hb)
    bs = sc._replace(ref_img=band(sc.ref_img), ref_gx=band(sc.ref_gx),
                     ref_gy=band(sc.ref_gy), rays=sc.rays[rs],
                     view_vec=sc.view_vec[rs], texture_ok=sc.texture_ok[rs],
                     row_offset=torch.tensor(r0, dtype=torch.int32,
                                             device=cuda_device))
    got, want = _window_costs(bs, p, parity, n[:, rs], d[:, rs])
    _costs_agree(got, want)
    whole, _ = _window_costs(sc, p, parity, n, d)
    assert torch.equal(got, whole[:, :, rs])


def test_exact_window_cost_engages_on_pm_only(cuda_device):
    """per_view_costs_batch on the card: PM launches the window-sum kernel
    and the warp kernel once per sampler launch each, CENSUS neither."""
    from gipuma_tpu_torch import kernels
    from gipuma_tpu_torch.config import MatchingAlgorithm
    sc, p, gt = _exact_scene(cuda_device, 1, 11, 2)
    n, d = _exact_planes(sc, gt, 4, seed=3)
    na = torch.stack([tcb.extract(n[k], 0) for k in range(4)])
    da = torch.stack([tcb.extract(d[k], 0) for k in range(4)])
    for alg, launches in ((MatchingAlgorithm.PM, 4),
                          (MatchingAlgorithm.CENSUS, 0)):
        kernels.reset_counts()
        tco.per_view_costs_batch(sc, p.replace(algorithm=alg), 0, na, da)
        torch.cuda.synchronize()
        assert kernels.counts["exact_window_cost"] == launches
        assert kernels.counts["bilinear_sample"] >= 4
        assert kernels.counts["exact_warp_coords"] == (
            kernels.counts["bilinear_sample"] if launches else 0)


def _half_planes(n, d, parity, degenerate=None):
    """n, d [K, H, W(, 3)] on the parity's half-grid; degenerate (k, i, j):
    d = 0 planted there (the half-grid's index)."""
    K = n.shape[0]
    na = torch.stack([tcb.extract(n[k], parity) for k in range(K)])
    da = torch.stack([tcb.extract(d[k], parity) for k in range(K)])
    if degenerate is not None:
        da[degenerate] = 0.0
    return na, da


def _kernel_coords(sc, v, warp, offsets):
    """The warp kernel's (xw, yw) for view v, as per_view_costs_batch
    launches it."""
    kc, h, w2 = warp.mr.shape
    O = len(offsets)
    xw = torch.full((kc * O, h, w2), 7.0, device=warp.mr.device)
    yw = torch.full_like(xw, 7.0)
    ar, ac0, ac1 = tco.view_warp_terms(sc, v, warp.rays)
    tco.exact_warp_coords_cuda(ar, ac0, ac1, sc.b[v], warp.mr, warp.mc0,
                               warp.mc1,
                               tco.offset_tables(offsets, xw.device)[0],
                               xw, yw)
    return xw, yw


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("box,inc", [(11, 2), (15, 2), (9, 1)])
@pytest.mark.parametrize("C", [1, 3])
def test_exact_warp_coords_kernel_matches_warped_coords(cuda_device, C, box,
                                                        inc, K, parity):
    """csrc/exact_cost.cu's warp prologue against warped_coords at the
    presets' windows (O = 36 and 64, the compiled loops) and at box 9 /
    increment 1 (O = 80, the generic loop), every view: bit-equal, NaN at
    the same places; a degenerate plane (d = 0) planted in candidate K-1
    gives non-finite positions, the same bits."""
    from gipuma_tpu_torch import kernels
    sc, p, gt = _exact_scene(cuda_device, C, box, inc)
    n, d = _exact_planes(sc, gt, K, seed=10 * box + K + parity)
    na, da = _half_planes(n, d, parity, degenerate=(K - 1, 5, 7))
    offsets = tco.window_offsets(p)
    O = len(offsets)
    warp = tco._plane_terms(sc, parity, na, da)
    kernels.reset_counts()
    for v in range(sc.num_views):
        got = _kernel_coords(sc, v, warp, offsets)
        want = tco.warped_coords(sc, v, warp, offsets)
        for g, w in zip(got, want):
            assert _same(g, w)
        assert not bool(torch.isfinite(want[0][(K - 1) * O:, 5, 7]).all())
    torch.cuda.synchronize()
    assert kernels.counts["exact_warp_coords"] == sc.num_views


@pytest.mark.parametrize("parity", [0, 1])
def test_exact_warp_coords_row_band(cuda_device, parity):
    """A row band (rows 16..31 of 48, row_offset 16), as tile sharding
    builds it: the kernel against warped_coords on the band, and bit-equal
    to the whole scene's kernel positions at the band's rows."""
    sc, p, gt = _exact_scene(cuda_device, 1, 11, 2)
    n, d = _exact_planes(sc, gt, 4, seed=7 + parity)
    r0, hb = 16, 16
    rs = slice(r0, r0 + hb)
    bs = sc._replace(rays=sc.rays[rs], view_vec=sc.view_vec[rs],
                     texture_ok=sc.texture_ok[rs],
                     row_offset=torch.tensor(r0, dtype=torch.int32,
                                             device=cuda_device))
    offsets = tco.window_offsets(p)
    O = len(offsets)
    na, da = _half_planes(n, d, parity)
    warp = tco._plane_terms(sc, parity, na, da)
    bwarp = tco._plane_terms(bs, parity, na[:, rs], da[:, rs])
    for v in range(sc.num_views):
        got = _kernel_coords(bs, v, bwarp, offsets)
        want = tco.warped_coords(bs, v, bwarp, offsets)
        whole = _kernel_coords(sc, v, warp, offsets)
        for g, w, a in zip(got, want, whole):
            assert _same(g, w)
            assert g.shape == (4 * O, hb, a.shape[-1])
            assert _same(g, a[:, rs])


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("box,inc", [(11, 2), (15, 2)])
def test_exact_costs_equal_the_torch_warp_composition(cuda_device, box, inc,
                                                      parity):
    """per_view_costs_batch on the card (the warp kernel, the sampler, the
    window-sum kernel) is bit-equal to the same costs with torch's
    warped_coords in place of the warp kernel, a degenerate plane
    included (MAXCOST at the same places)."""
    from gipuma_tpu_torch import kernels
    sc, p, gt = _exact_scene(cuda_device, 1, box, inc)
    n, d = _exact_planes(sc, gt, 4, seed=3 * box + parity)
    na, da = _half_planes(n, d, parity, degenerate=(3, 5, 7))
    offsets = tco.window_offsets(p)
    kernels.reset_counts()
    got = tco.per_view_costs_batch(sc, p, parity, na, da)
    torch.cuda.synchronize()
    assert kernels.counts["exact_warp_coords"] == sc.num_views
    warp = tco._plane_terms(sc, parity, na, da)
    ref, gx, gy, table = tco.exact_window_inputs(sc, offsets, da.device)
    want = torch.empty_like(got)
    for v in range(sc.num_views):
        xw, yw = tco.warped_coords(sc, v, warp, offsets)
        smp = tsm.bilinear_sample(sc.src[v], xw, yw)
        tco.exact_window_cost_cuda(smp, ref, gx, gy, table, sc.view_valid,
                                   v, want[v], parity, sc.ref_img.pr,
                                   sc.ref_img.pc, p)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got[:3, 3, 5, 7] == MAXCOST).all())


def test_exact_pm_run_launches_each_kernel_once_a_unit(cuda_device,
                                                       monkeypatch):
    """A PM run on a CUDA scene (the exact path, every candidate in one
    chunk, then one candidate a chunk): each (view, chunk) unit launches
    the warp kernel, the sampler and the window-sum kernel once each, and
    the chunked run gives the same planes and costs."""
    from gipuma_tpu_torch import kernels
    from gipuma_tpu_torch.models import patchmatch as tpmm
    job, _ = _ring(cuda_device, h=64, w=96, cost_path="exact")
    out = []
    for samples in (tco.MAX_SAMPLES, 1):
        monkeypatch.setattr(tco, "MAX_SAMPLES", samples)
        kernels.reset_counts()
        with torch.no_grad():
            st = tpmm.run_patchmatch(job.prep, job.params,
                                     tpmm.make_generator(5, cuda_device),
                                     tco.multiview_cost)
        torch.cuda.synchronize()
        n = kernels.counts
        assert n["exact_warp_coords"] == n["bilinear_sample"] \
            == n["exact_window_cost"] > 0
        # Every unit (B = candidates x 36 offsets) takes a tile.
        assert n["bilinear_sample_tiled"] == n["bilinear_sample"]
        out.append((st, n["bilinear_sample"]))
    (whole, units), (chunked, chunked_units) = out
    assert chunked_units > units
    assert torch.equal(chunked.planes.view(torch.int32),
                       whole.planes.view(torch.int32))
    assert torch.equal(chunked.cost.view(torch.int32),
                       whole.cost.view(torch.int32))


def _same(got, want):
    """Bit-equal, NaN at the same places."""
    return torch.equal(torch.isnan(got), torch.isnan(want)) and torch.equal(
        got.nan_to_num(-1.0).view(torch.int32),
        want.nan_to_num(-1.0).view(torch.int32))


@pytest.mark.parametrize("mode", ["f32", "packed", "gfwd"])
def test_row_gather_lerp_kernel_matches_plain(cuda_device, mode):
    g = torch.Generator().manual_seed(3)
    img = torch.rand((4, 40, 256), generator=g) * 255
    src = img if mode == "f32" else torch.from_numpy(
        trg.pack_taps(img.numpy()))
    x = torch.rand((3, 40, 200), generator=g) * 296 - 20
    x[1, 2, 3] = float("nan")
    src, x = src.to(cuda_device), x.to(cuda_device)
    for src_dy in (0, -3):
        want = trg.row_gather_lerp_plain(src, x, mode == "gfwd", src_dy)
        got = trg.row_gather_lerp_cuda(src, x, mode == "gfwd", src_dy)
        assert got.shape == want.shape == (3, 6 if mode == "gfwd" else 4,
                                           40, 200)
        assert torch.isnan(got[1, 0, 2, 3])
        assert _same(got, want)


def test_row_gather_affine_kernel_matches_plain(cuda_device):
    g = torch.Generator().manual_seed(4)
    img = torch.rand((2, 40, 256), generator=g) * 255
    src = torch.from_numpy(trg.pack_taps(img.numpy())).to(cuda_device)
    abc = torch.empty((2, 3, 40, 200))
    abc[:, 0] = torch.rand((2, 40, 200), generator=g) * 0.6 - 0.3
    abc[:, 1] = torch.rand((2, 40, 200), generator=g) * 0.4 - 0.2
    abc[:, 2] = torch.rand((2, 40, 200), generator=g) * 90 - 30
    abc[0, 2, 0, :3] = torch.tensor([float("nan"), 400.0, -400.0])
    abc = abc.to(cuda_device)
    db = torch.tensor([-10.0, 40.0], device=cuda_device)
    dxs = tuple(range(-5, 6))
    for dy in (0, 2, -5):
        want = trg.row_gather_affine_plain(src, abc, dxs, float(dy), db, dy)
        got = trg.row_gather_affine_cuda(src, abc, dxs, float(dy), db, dy)
        assert got.shape == (2 * len(dxs), 2, 40, 200)
        assert torch.isnan(got[:len(dxs), :, 0, 0]).all()
        assert _same(got, want)


# The affine kernel's templated column counts (census 11, 9, 1; unfused
# one-sided 6, 3 and two-sided 8, 5) and one generic count (7).
AFFINE_E = [11, 9, 1, 6, 3, 8, 5, 7]


def _affine_case(seed, C, K, H, W, Ws, c_lo=-30.0, c_span=90.0):
    """Packed source [C, H, W] and planes [K, 3, H, Ws] on the CPU: a NaN
    plane and planes far outside the clamp in the first and last rows."""
    g = torch.Generator().manual_seed(seed)
    img = torch.rand((C, H, W), generator=g) * 255
    src = torch.from_numpy(trg.pack_taps(img.numpy()))
    abc = torch.empty((K, 3, H, Ws))
    abc[:, 0] = torch.rand((K, H, Ws), generator=g) * 0.6 - 0.3
    abc[:, 1] = torch.rand((K, H, Ws), generator=g) * 0.4 - 0.2
    abc[:, 2] = torch.rand((K, H, Ws), generator=g) * c_span + c_lo
    abc[0, 2, 0, :3] = torch.tensor([float("nan"), 1e4, -1e4])
    abc[K - 1, 2, H - 1, -3:] = torch.tensor([-1e4, float("nan"), 1e4])
    return src, abc


@pytest.mark.parametrize("E", AFFINE_E)
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("C", [1, 3])
def test_row_gather_affine_rows_kernel_matches_plain(cuda_device, C, K, E):
    """The rows launch is bit-equal to its plain version (the stack of the
    one-row plain calls) and to the stack of one-row launches, NaN
    included: Ws = 200 (16-byte loads and stores, not a multiple of 128)
    and 197 (the scalar tail), the scene-like and an open clamp, six
    window rows in two row groups, one beyond the last source row."""
    H, W = 24, 256
    dxs = tuple(range(-(E // 2), E - E // 2))
    dys = (-5, -2, 0, 2, 7, 30)
    for Ws in (200, 197):
        src, abc = _affine_case(E, C, K, H, W, Ws)
        src, abc = src.to(cuda_device), abc.to(cuda_device)
        for lo, hi in ((-10.0, 40.0), (-1e9, 1e9)):
            db = torch.tensor([lo, hi], device=cuda_device)
            want = trg.row_gather_affine_rows_plain(src, abc, dxs, dys, db)
            got = trg.row_gather_affine_rows_cuda(src, abc, dxs, dys, db)
            assert got.shape == (len(dys), K * E, C, H, Ws)
            assert torch.isnan(got[:, :E, :, 0, 0]).all()
            assert _same(got, want)
            one = torch.stack([trg.row_gather_affine_cuda(
                src, abc, dxs, float(dy), db, dy) for dy in dys])
            assert _same(got, one)


@pytest.mark.parametrize("E", [11, 7])
def test_row_gather_affine_kernel_global_branch(cuda_device, E):
    """A [3, 12, 4200] source row (50 KB) exceeds the kernel's shared-
    memory budget, so it reads the source from global memory; positions
    reach across the whole row.  Bit-equal, rows and one-row launches."""
    C, K, H, W, Ws = 3, 2, 12, 4200, 300
    assert trg.row_gather_affine_staged_rows(6, C, W) == 0
    assert trg.row_gather_affine_staged_rows(6, C, 256) > 0
    src, abc = _affine_case(E, C, K, H, W, Ws, c_lo=-3950.0, c_span=4000.0)
    src, abc = src.to(cuda_device), abc.to(cuda_device)
    dxs = tuple(range(-(E // 2), E - E // 2))
    db = torch.tensor([-1e9, 1e9], device=cuda_device)
    dys = (-3, 0, 4)
    want = trg.row_gather_affine_rows_plain(src, abc, dxs, dys, db)
    got = trg.row_gather_affine_rows_cuda(src, abc, dxs, dys, db)
    assert _same(got, want)
    got1 = trg.row_gather_affine_cuda(src, abc, dxs, 4.0, db, 4)
    assert _same(got1, want[2])


def _ring(cuda_device, h=96, w=128, **kw):
    """A rect job on the card: a 5-camera ring at h x w with the bench's
    two-stage cull (cull_view_stride 2) and the settings `kw`."""
    from gipuma_tpu_torch import pipeline as tpipe
    from gipuma_tpu_torch.utils.synthetic import make_ring_P, plane_scene
    images, _, gt, _ = plane_scene(num_cams=5, h=h, w=w, focal=1.25 * w,
                                   plane_depth=5.0, slant=(0.2, -0.1),
                                   texture="noise")
    Ps = make_ring_P(5, h, w, 1.25 * w, target_depth=5.0)
    p = AlgorithmParams(box_hsize=11, box_vsize=11, iterations=3,
                        depth_min=3.0, depth_max=8.0, min_angle=0.01,
                        max_angle=60.0, cost_path="rect",
                        rect_two_stage_cull=True,
                        cull_view_stride=2).replace(**kw)
    return tpipe.prepare_job(images, Ps, p, device=cuda_device), gt


def test_cull_scene_kernels_match_plain(cuda_device):
    """The fused cost and permute2d at the nested cull scene's shapes
    (cull_downscale=2): the forward permute of K=4 f16-packed planes and
    the return permute of f16-packed costs bit-equal at consumed
    coordinates, the K=4 sparse-window cost within 1e-3 at covered
    pixels."""
    from gipuma_tpu_torch.ops import rect_cost as trc
    job, _ = _ring(cuda_device, cull_downscale=2)
    sc, p = job.prep.cull, job.params
    assert sc is not None
    sp = p.replace(box_hsize=p.cull_box, box_vsize=p.cull_box,
                   window_increment=p.cull_increment)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    s = sc.fwd_c1.shape[-2]
    hr, wr = sc.ref_rect.shape[-2:]
    K = 4
    for v in range(sc.num_views):
        m = torch.randn((K, 3, s, s), generator=g, device=cuda_device)
        words = trc._pack_m_tri(m).contiguous()
        m2 = sc.fwd2_ok[v]
        want = tpm.permute2d_plain(words, sc.fwd_c1[v], sc.fwd_r[v])
        got = tpm.permute2d_cuda(words, sc.fwd_c1[v], sc.fwd_r[v], m2)
        on = m2.bool().repeat_interleave(8, 0).repeat_interleave(
            128, 1)[:wr, :hr].t()
        assert torch.equal(got[:, on], want[:, on])
        mr = trc._unpack_m_tri(want, K)
        abc = trc._apply_L(sc.L[v], mr).contiguous()
        db = sc.disp_bounds[v].contiguous()
        want_c = tsf.fused_sdg_cost_batch_plain(sc.ref_rect[v],
                                                sc.src_rect[v], abc, sp,
                                                db[0], db[1])
        got_c = tsf.fused_sdg_cost_batch_cuda(sc.ref_rect[v], sc.src_rect[v],
                                              abc, sp, db, sc.hw_valid[v],
                                              sc.tile_ok[v])
        hv, wv = (int(a) for a in sc.hw_valid[v].tolist())
        cov = sc.tile_ok[v].bool().repeat_interleave(8, 0).repeat_interleave(
            128, 1)[:hr, :wr].clone()
        cov[(hv + 7) // 8 * 8:] = False
        cov[:, (wv + 127) // 128 * 128:] = False
        assert cov.any()
        assert float((got_c - want_c).abs()[:, cov].max()) <= 1e-3
        cw = trc._pack_f16_pairs(want_c).contiguous()
        r2 = sc.ret2_ok[v]
        want_r = tpm.permute2d_plain(cw, sc.ret_c1[v], sc.ret_r[v])
        got_r = tpm.permute2d_cuda(cw, sc.ret_c1[v], sc.ret_r[v], r2)
        on = r2.bool().repeat_interleave(8, 0).repeat_interleave(
            128, 1)[:s, :s].t()
        assert torch.equal(got_r[:, on], want_r[:, on])


@pytest.mark.parametrize("path", ["rect", "exact", "cull_downscale"])
def test_scan_graph_matches_host_loop(cuda_device, monkeypatch, path):
    """level_dispatch="scan" on the card (iteration 1 eager, the others
    replays of one captured iteration) against the host loop from the same
    seed: planes and costs bit-equal, the same kernel launches counted,
    the generator left at the same offset, and no host sync inside the
    capture (sync debug mode "error")."""
    from gipuma_tpu_torch import kernels
    from gipuma_tpu_torch.models import patchmatch as tpmm
    from gipuma_tpu_torch.ops.cost import multiview_cost
    from gipuma_tpu_torch.ops.rect_cost import rect_multiview_cost
    kw = {"exact": dict(cost_path="exact"),
          "cull_downscale": dict(cull_downscale=2)}.get(path, {})
    job, _ = _ring(cuda_device, h=64, w=96, **kw)
    cost_fn = multiview_cost if path == "exact" else rect_multiview_cost
    monkeypatch.setattr(tpmm, "CAPTURE_SYNC_DEBUG_MODE", "error")
    out = {}
    for mode in ("host", "scan"):
        gen = tpmm.make_generator(5, cuda_device)
        kernels.reset_counts()
        tpmm.SCAN_LOG.clear()
        with torch.no_grad():
            st = tpmm.run_patchmatch(job.prep, job.params.replace(
                level_dispatch=mode), gen, cost_fn)
        torch.cuda.synchronize()
        out[mode] = (st, dict(kernels.counts), gen.get_offset(),
                     list(tpmm.SCAN_LOG))
    (h_st, h_n, h_off, _), (s_st, s_n, s_off, log) = out["host"], out["scan"]
    assert len(log) == 1 and log[0]["replays"] == job.params.iterations - 1
    assert torch.equal(s_st.planes.view(torch.int32),
                       h_st.planes.view(torch.int32))
    assert torch.equal(s_st.cost.view(torch.int32),
                       h_st.cost.view(torch.int32))
    assert s_n == h_n and any(v > 0 for v in s_n.values())
    # The exact path sums every PM sampler launch's windows in the kernel,
    # inside the captured graph too; the rect paths never launch it.
    assert h_n["exact_window_cost"] == (
        h_n["bilinear_sample"] if path == "exact" else 0)
    # So does the warp kernel build every PM sampler launch's positions.
    assert h_n["exact_warp_coords"] == (
        h_n["bilinear_sample"] if path == "exact" else 0)
    assert s_off == h_off


def test_graph_replays_draw_new_uniforms(cuda_device):
    """A torch.Generator registered with a CUDA graph: every replay draws
    the next uniforms of the generator's stream (the ones an eager call
    would draw), not the captured ones again."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    ref = torch.Generator(device=cuda_device).manual_seed(9)
    out = torch.empty(1000, device=cuda_device)
    torch.rand(1000, generator=gen, device=cuda_device)     # warm-up draw
    torch.rand(1000, generator=ref, device=cuda_device)
    g = torch.cuda.CUDAGraph()
    g.register_generator_state(gen)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        g.capture_begin()
        out.copy_(torch.rand(1000, generator=gen, device=cuda_device))
        g.capture_end()
    torch.cuda.current_stream().wait_stream(s)
    draws = []
    for _ in range(3):
        g.replay()
        draws.append(out.clone())
    for d in draws:
        assert torch.equal(d, torch.rand(1000, generator=ref,
                                         device=cuda_device))
    assert not torch.equal(draws[0], draws[1])
