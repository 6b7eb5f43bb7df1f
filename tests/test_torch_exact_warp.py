"""gipuma_tpu_torch exact PM cost's warp prologue (csrc/exact_cost.cu,
exact_warp_coords_kernel), checked on the CPU without building it: its
wrapper refuses a CPU, non-f32, non-contiguous or misshapen argument by
name before any build; its offset table is the sampled list; its plain
version (the kernel's arithmetic in torch, from the same inputs) is
bit-equal to warped_coords; and a CPU scene, PM or CENSUS, never takes
the kernel.  The kernel itself against warped_coords runs on the card
(tests/test_torch_kernels_gpu.py)."""
import numpy as np
import pytest
import torch

from gipuma_tpu_torch import kernels
from gipuma_tpu_torch.config import AlgorithmParams, MatchingAlgorithm
from gipuma_tpu_torch.models import scene as tscene
from gipuma_tpu_torch.ops import cost as tcost
from gipuma_tpu_torch.utils.synthetic import plane_scene

torch.set_num_threads(1)
H, W = 24, 32
WINDOWS = [(11, 2), (15, 2), (9, 1)]


def _scene(box=7, inc=2):
    images, rig, _, _ = plane_scene(num_cams=3, h=H, w=W, focal=40.0,
                                    plane_depth=5.0, slant=(0.2, -0.1),
                                    texture="noise")
    p = AlgorithmParams(box_hsize=box, box_vsize=box, window_increment=inc)
    return tscene.build_scene(images, rig, [1, 2], p, 3.0, 8.0,
                              device="cpu"), p


def _planes(K, seed, degenerate=False):
    """K planes on the half-grid: normals facing the camera, d in [-8, -3];
    `degenerate` sets d = 0 for candidate K-1 at one pixel."""
    g = torch.Generator().manual_seed(seed)
    n = torch.randn((K, H, W // 2, 3), generator=g) * 0.2
    n[..., 2] = -1.0
    n = n / n.norm(dim=-1, keepdim=True)
    d = -3.0 - 5.0 * torch.rand((K, H, W // 2), generator=g)
    if degenerate:
        d[K - 1, 5, 7] = 0.0
    return n, d


def _args(O=4, kc=2):
    w2 = W // 2
    return dict(ar=torch.rand(H, w2, 3), ac0=torch.rand(3),
                ac1=torch.rand(3), b=torch.rand(3),
                mr=torch.rand(kc, H, w2), mc0=torch.rand(kc, H, w2),
                mc1=torch.rand(kc, H, w2), table=torch.zeros(O, 2),
                xw=torch.empty(kc * O, H, w2), yw=torch.empty(kc * O, H, w2))


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the wrapper reached the kernel build")
    monkeypatch.setattr(kernels, "library", refuse)
    monkeypatch.setattr(kernels, "_entries", {})


@pytest.mark.parametrize("name,fault", [
    ("ar", "cpu"), ("ar", "float64"), ("b", "float16"), ("mc1", "int32"),
    ("table", "int32"), ("yw", "float64"), ("mr", "strided"),
    ("ar", "strided"), ("xw", "strided")])
def test_wrapper_rejects_before_build(no_build, name, fault):
    args = _args()
    t = args[name]
    if fault == "strided":
        args[name] = torch.cat([t, t])[::2]
        assert not args[name].is_contiguous()
        err = ValueError
    elif fault != "cpu":
        args[name] = t.to(getattr(torch, fault))
        err = TypeError
    else:
        err = ValueError
    with pytest.raises(err, match=f"exact_warp_coords: {name} must be"):
        tcost.exact_warp_coords_cuda(**args)
    assert kernels.counts["exact_warp_coords"] == 0


@pytest.mark.parametrize("name,shape", [
    ("ar", (H, W // 2, 4)), ("ac0", (4,)), ("b", (1, 3)),
    ("mr", (2, H, W // 2, 1)), ("mc0", (2, H, W // 2 + 1)),
    ("table", (4, 3)), ("table", (0, 2)), ("xw", (7, H, W // 2)),
    ("yw", (8, H - 1, W // 2))])
def test_wrapper_rejects_a_wrong_shape(no_build, name, shape):
    args = _args()
    args[name] = torch.zeros(shape)
    with pytest.raises(ValueError, match=f"exact_warp_coords: {name} "):
        tcost.exact_warp_coords_cuda(**args)


@pytest.mark.parametrize("box,inc", WINDOWS)
def test_warp_table_is_the_sampled_list(box, inc):
    p = AlgorithmParams(box_hsize=box, box_vsize=box, window_increment=inc)
    offsets = tcost.window_offsets(p)
    table = tcost.offset_tables(offsets, torch.device("cpu"))[0]
    assert table.dtype == torch.float32 and table.shape == (len(offsets), 2)
    assert [tuple(map(int, r)) for r in table.tolist()] == \
        [tuple(o) for o in offsets]
    assert tcost.offset_tables(offsets, torch.device("cpu"))[0] is table


def _kernel_arithmetic(sc, v, warp, table):
    """The warp op's plain version from the inputs per_view_costs_batch
    hands it: [kc * O, H, W2] each."""
    ar, ac0, ac1 = tcost.view_warp_terms(sc, v, warp.rays)
    xw = torch.full((warp.mr.shape[0] * table.shape[0],) + warp.mr.shape[1:],
                    7.0)
    yw = torch.full_like(xw, 7.0)
    tcost.exact_warp_coords_plain(ar, ac0, ac1, sc.b[v], warp.mr, warp.mc0,
                                  warp.mc1, table, xw, yw)
    return xw, yw


def _bits(t):
    return t.nan_to_num(0.5).view(torch.int32), torch.isnan(t)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("box,inc", WINDOWS)
def test_kernel_arithmetic_is_warped_coords(box, inc, parity):
    """The folding the kernel and its plain version rely on (view terms A
    r, A c0, A c1 from view_warp_terms; - b m.r etc. per candidate; the
    table's offsets) gives warped_coords' bits, NaN and inf included (a
    planted d = 0)."""
    sc, p = _scene(box, inc)
    offsets = tcost.window_offsets(p)
    table = tcost.offset_tables(offsets, torch.device("cpu"))[0]
    n, d = _planes(3, seed=box + parity, degenerate=True)
    warp = tcost._plane_terms(sc, parity, n, d)
    for v in range(sc.num_views):
        want = tcost.warped_coords(sc, v, warp, offsets)
        got = _kernel_arithmetic(sc, v, warp, table)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g)[1], _bits(w)[1])
            assert torch.equal(_bits(g)[0], _bits(w)[0])
        O = len(offsets)
        assert not torch.isfinite(want[0][2 * O:, 5, 7]).all()


@pytest.mark.parametrize("alg", [MatchingAlgorithm.PM,
                                 MatchingAlgorithm.CENSUS])
def test_cpu_scene_never_takes_the_kernel(monkeypatch, alg):
    def no_kernel(*a, **k):
        raise AssertionError("a CPU scene launched the warp kernel")
    monkeypatch.setattr(tcost, "exact_warp_coords_cuda", no_kernel)
    sc, p = _scene(box=5, inc=2)
    p = p.replace(algorithm=alg)
    n, d = _planes(2, seed=4)
    kernels.reset_counts()
    got = tcost.per_view_costs_batch(sc, p, 0, n, d)
    assert got.shape == (2, 2, H, W // 2)
    assert bool(np.isfinite(got.numpy()).all())
    assert kernels.counts["exact_warp_coords"] == 0
    assert kernels.counts["bilinear_sample"] == 0
