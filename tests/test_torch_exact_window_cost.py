"""gipuma_tpu_torch exact PM cost's window-sum kernel (csrc/exact_cost.cu),
checked on the CPU without building it: its wrapper refuses a CPU, non-f32
or non-contiguous argument by name before any build; the reference planes
and offset table it reads address the same reference values as
PaddedEO.windows (full and row-band scenes, both parities); and a CPU
scene never takes the kernel.  The kernel against its plain version runs
on the card (tests/test_torch_kernels_gpu.py)."""
import numpy as np
import pytest
import torch

from gipuma_tpu_torch import kernels
from gipuma_tpu_torch.config import AlgorithmParams
from gipuma_tpu_torch.models import scene as tscene
from gipuma_tpu_torch.ops import checkerboard as cb
from gipuma_tpu_torch.ops import cost as tcost
from gipuma_tpu_torch.utils.synthetic import plane_scene

torch.set_num_threads(1)
H, W = 24, 32


def _scene(C=1, box=9, inc=1):
    images, rig, _, _ = plane_scene(num_cams=3, h=H, w=W, focal=40.0,
                                    plane_depth=5.0, slant=(0.2, -0.1),
                                    texture="noise")
    if C == 3:
        images = [np.stack([im, 0.8 * im + 20.0, 255.0 - im], -1)
                  .astype(np.float32) for im in images]
    p = AlgorithmParams(box_hsize=box, box_vsize=box, window_increment=inc)
    return tscene.build_scene(images, rig, [1, 2], p, 3.0, 8.0,
                              device="cpu"), p


def _args(O=4, C=1, kc=2, pr=2, pc=4):
    return dict(smp=torch.rand(kc * O, 3 * C, H, W // 2),
                ref=torch.rand(2, H + 2 * pr, W // 2 + pc, C),
                gx=torch.rand(2, H + 2 * pr, W // 2 + pc, C),
                gy=torch.rand(2, H + 2 * pr, W // 2 + pc, C),
                table=torch.zeros(O, 3, dtype=torch.int32),
                view_valid=torch.ones(3), v=1,
                out=torch.empty(kc, H, W // 2), parity=0, pr=pr, pc=pc,
                params=AlgorithmParams())


@pytest.mark.parametrize("name,fault", [
    ("smp", "cpu"), ("ref", "float64"), ("gy", "float16"),
    ("table", "int64"), ("view_valid", "float64"), ("smp", "strided"),
    ("gx", "strided"), ("out", "strided")])
def test_wrapper_rejects_before_build(monkeypatch, name, fault):
    def no_build(*a, **k):
        raise AssertionError("the wrapper reached the kernel build")
    monkeypatch.setattr(kernels, "library", no_build)
    monkeypatch.setattr(kernels, "_entries", {})
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
    with pytest.raises(err, match=f"exact_window_cost: {name} must be"):
        tcost.exact_window_cost_cuda(**args)


@pytest.mark.parametrize("row_band", [False, True])
@pytest.mark.parametrize("C,box,inc", [(1, 15, 2), (3, 9, 1)])
def test_kernel_reads_match_windows(C, box, inc, row_band):
    """The kernel's reads, done here with the kernel's index arithmetic:
    for table row (dx, dy, o), plane (pi + dx + pc) % 2 at row pr + i + dy
    and column (pi + dx + pc) // 2 + j, pi = (i + parity) % 2, is window
    o of PaddedEO.windows; the table holds each offset once, dx-even
    offsets first, each group in list order."""
    sc, p = _scene(C, box, inc)
    if row_band:
        # Band rows 8..15 of the image with real halo rows, as the tile
        # sharding builds them (row_offset 8).
        pr, pc = sc.ref_img.pr, sc.ref_img.pc
        rows = torch.arange(8 - pr, 16 + pr).clamp(0, H - 1)

        def band(eo):
            full = torch.stack([eo.E, eo.O], 2).reshape(
                eo.E.shape[0], -1, eo.E.shape[-1])
            full = full[pr:pr + H, eo.pc:eo.pc + W]
            return cb.PaddedEO.build_row_padded(full[rows], pr, pc)

        sc = sc._replace(ref_img=band(sc.ref_img), ref_gx=band(sc.ref_gx),
                         ref_gy=band(sc.ref_gy))
        assert sc.ref_img.h == 8
    offsets = tcost.window_offsets(p)
    ref, gx, gy, table = tcost.exact_window_inputs(sc, offsets,
                                                   torch.device("cpu"))
    assert tcost.exact_window_inputs(sc, offsets, torch.device("cpu"))[0] \
        is ref
    rows_t = table.tolist()
    assert sorted(o for _, _, o in rows_t) == list(range(len(offsets)))
    assert [(dx, dy) for dx, dy, _ in rows_t] == \
        [o for o in offsets if o[0] % 2 == 0] + \
        [o for o in offsets if o[0] % 2 == 1]
    eo = sc.ref_img
    h, w2 = eo.h, eo.w2
    i = torch.arange(h)[:, None].expand(h, w2)
    j = torch.arange(w2)[None].expand(h, w2)
    for parity in (0, 1):
        pi = (i + parity) % 2
        for planes, src in ((ref, sc.ref_img), (gx, sc.ref_gx),
                            (gy, sc.ref_gy)):
            win = src.windows(offsets, parity)
            for dx, dy, o in rows_t:
                s = pi + dx + eo.pc
                got = planes[s % 2, eo.pr + i + dy, s // 2 + j]
                assert torch.equal(got, win[o]), (parity, dx, dy)


def test_inputs_refuse_a_window_past_the_padding():
    sc, _ = _scene(box=5, inc=1)
    wide = AlgorithmParams(box_hsize=15, box_vsize=15, window_increment=2)
    with pytest.raises(ValueError, match="exceeds the reference padding"):
        tcost.exact_window_inputs(sc, tcost.window_offsets(wide),
                                  torch.device("cpu"))


def test_cpu_scene_takes_the_plain_version(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("a CPU scene launched the kernel")
    monkeypatch.setattr(tcost, "exact_window_cost_cuda", no_kernel)
    sc, p = _scene(box=7, inc=2)
    kernels.reset_counts()
    parity = 1
    d = torch.full((2, H, W // 2), -5.0)
    n = torch.zeros((2, H, W // 2, 3))
    n[..., 2] = -1.0
    got = tcost.per_view_costs_batch(sc, p, parity, n, d)
    assert got.shape == (2, 2, H, W // 2)
    assert kernels.counts["exact_window_cost"] == 0
    # The same sum, unit by unit, from the plain version.
    terms = tcost.pm_reference_terms(sc, p, tcost.window_offsets(p), parity)
    warp = tcost._plane_terms(sc, parity, n, d)
    for v in range(2):
        xw, yw = tcost.warped_coords(sc, v, warp, tcost.window_offsets(p))
        smp = tcost.bilinear_sample(sc.src[v], xw, yw)
        assert torch.equal(got[v], tcost.pm_window_cost_plain(
            smp, terms, p, sc.view_valid[v]))
