"""gipuma_tpu_torch command line, the scripts' path, on the CPU:

* ``main --device cpu`` over a folder of 4 views at 48x64 (blocksize 7, 1
  iteration; the setting of tests/test_cli.py) with --all_views --fuse and
  a per-view -gt template: every view's disp.dmb (finite, the right
  shape), its results.txt GT lines and error PNGs, and fused.ply;
* a second run with --skip_existing into the same output folder finds
  every view done and fuses from the .dmb files on disk;
* params_from_args equals the JAX CLI's over flag sets with each preset;
* --distributed raises where torchrun's variables name no rendezvous;
  without CUDA and without --device, main raises;
* utils.profiling's PhaseTimer and megapixel meter."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gipuma_tpu.cli import build_parser as j_parser
from gipuma_tpu.cli import params_from_args as j_params

from gipuma_tpu_torch import cli as tcli
from gipuma_tpu_torch.io.dmb import read_dmb, write_dmb
from gipuma_tpu_torch.io.ply import read_ply
from gipuma_tpu_torch.io.vis import save_png
from gipuma_tpu_torch.utils import profiling
from gipuma_tpu_torch.utils.synthetic import (intersect_plane, make_ring_P,
                                              plane_scene)

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)
H, W = 48, 64


def test_port_imports_no_jax():
    """The port never imports JAX or the JAX package (fresh interpreter)."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import gipuma_tpu_torch as g; print(g.foreign_modules())"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def _write_scene(root: Path, num_cams=4):
    """PNG views, per-view .P files and analytic GT depth maps (.dmb)."""
    images, _, _, (n_w, d_w) = plane_scene(num_cams=num_cams, h=H, w=W,
                                           focal=90.0, plane_depth=5.0)
    Ps = make_ring_P(num_cams, H, W, 90.0, target_depth=5.0)
    (root / "cams").mkdir()
    (root / "gt").mkdir()
    names = []
    for i, (im, P) in enumerate(zip(images, Ps)):
        name = f"cam{i:03d}.png"
        save_png(root / name, np.clip(im, 0, 255).astype(np.uint8))
        (root / "cams" / f"{name}.P").write_text(
            "\n".join(" ".join(f"{v:.10g}" for v in row) for row in P))
        write_dmb(root / "gt" / f"depth_{i:03d}.dmb",
                  intersect_plane(P, H, W, n_w, d_w)[1].astype(np.float32))
        names.append(name)
    return names


def _flags(root: Path, out: Path):
    return ["-images_folder", str(root), "-p_folder", str(root / "cams"),
            "-output_folder", str(out), "-blocksize", "7",
            "--iterations", "1", "--depth_min", "3.0", "--depth_max", "8.0",
            "--min_angle", "0.01", "--max_angle", "60.0", "--device", "cpu"]


FUSE = ["--all_views", "--fuse", "--num_consistent", "1",
        "--disp_thresh", "2.0", "--normal_thresh", "60"]


def test_cli_batch_gt_and_fuse(tmp_path, monkeypatch):
    names = _write_scene(tmp_path)
    out = tmp_path / "res"
    # One timestamp for both runs: the resume finds the first run's views.
    monkeypatch.setattr(tcli.time, "strftime", lambda fmt: "run")
    gt = str(tmp_path / "gt" / "depth_{idx:03d}.dmb")
    assert tcli.main(_flags(tmp_path, out) + names + FUSE + ["-gt", gt]) == 0
    run_dir = out / "run"
    n_fused = len(read_ply(run_dir / "fused.ply")[0])
    assert n_fused > 0.25 * H * W
    for i, n in enumerate(names):
        vdir = run_dir / Path(n).stem
        depth = read_dmb(vdir / "disp.dmb")
        assert depth.shape == (H, W) and np.isfinite(depth).all()
        gt_i = read_dmb(tmp_path / "gt" / f"depth_{i:03d}.dmb")
        inner = np.s_[8:-8, 8:-8]
        err = np.abs(depth[inner] - gt_i[inner]) / gt_i[inner]
        assert np.median(err) < 0.05, (n, np.median(err))
        text = (vdir / "results.txt").read_text()
        assert f"gt_file {tmp_path / 'gt' / f'depth_{i:03d}.dmb'}" in text
        for key in ("error_rate_tol1.0", "error_rate_tol2",
                    "error_rate_nocc", "mean_abs_error"):
            assert f"\n{key} " in text, key
        for png in ("gt_error.png", "gt_error_tol2.png",
                    "gt_error_masked.png"):
            assert (vdir / png).exists(), png
    # Resume: every view is done, so the batch runs nothing and fuses the
    # on-disk maps into the same cloud.
    (run_dir / "fused.ply").unlink()
    assert tcli.main(_flags(tmp_path, out) + names + FUSE
                     + ["--skip_existing"]) == 0
    assert len(read_ply(run_dir / "fused.ply")[0]) == n_fused


FLAG_SETS = [
    [],
    ["--preset", "middlebury"],
    ["--preset", "dtu_fast", "-blocksize", "9"],
    ["--preset", "dtu_accurate", "--iterations", "3", "--n_best", "4"],
    ["--preset", "highres", "--cost_path", "exact"],
    ["-a", "ct", "--census_epsilon", "3.0", "--cost_comb", "good",
     "--good_factor", "1.5"],
    ["--cost_comb", "all", "--no_view_selection", "--color_processing"],
    ["--tau_color", "9", "--tau_gradient", "3", "--alpha", "0.8",
     "--gamma", "12", "--seed", "5"],
    ["--cost_path", "rect", "--pyramid_levels", "3",
     "--pyramid_fine_iterations", "1", "--max_views", "5",
     "--cam_scale", "0.5", "--min_angle", "2", "--max_angle", "50"],
    ["--preset", "middlebury", "--depth_min", "3", "--depth_max", "8",
     "-a", "pm", "--cost_comb", "best_n"],
]


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_params_from_args_match_jax(flags):
    argv = flags + ["x.png"]
    got = tcli.params_from_args(tcli.build_parser().parse_args(argv))
    want = j_params(j_parser().parse_args(argv))

    def plain(p):
        return {k: (v.name if hasattr(v, "name") else v)
                for k, v in dataclasses.asdict(p).items()}
    assert plain(got) == plain(want)


def test_parsers_share_flags_and_defaults():
    """Every flag of the JAX CLI, with its default; the port adds one."""
    t = {a.dest: a.default for a in tcli.build_parser()._actions}
    j = {a.dest: a.default for a in j_parser()._actions}
    assert set(t) - set(j) == {"device"}
    assert {k: t[k] for k in j} == j
    assert t["device"] == "cuda"


def test_distributed_raises(tmp_path, monkeypatch):
    """--distributed runs (tests/test_torch_distributed.py); it raises,
    before waiting on any rendezvous, where torchrun's variables ask for
    two processes without saying where they meet."""
    for v in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="MASTER_ADDR, MASTER_PORT unset"):
        tcli.main(["--distributed", "--device", "cpu", "x.png"])


def test_main_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    names = _write_scene(tmp_path)
    flags = [f for f in _flags(tmp_path, tmp_path / "res")
             if f not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(flags + names)
    assert not (tmp_path / "res").exists()


def test_phase_timer_and_megapixels():
    t = profiling.PhaseTimer()
    x = torch.ones(4)
    with t.phase("a", sync_on=[x, {"k": (x,)}]):
        x = x * 2
    with t.phase("a"):
        pass
    assert set(t.phases) == {"a"} and t.phases["a"] >= 0.0
    assert "total" in t.report()
    assert profiling.megapixels_per_second(2_000_000, 4.0) == 0.5
