"""gipuma_tpu_torch.parallel.distributed / mesh and the CLI's
--distributed, on the CPU:

* owned_jobs equals the JAX package's for n_jobs in {1, 5, 8, 17} and
  P in {1, 2, 3, 8}: disjoint, complete, balanced blocks;
* mesh_shape equals the JAX package's make_mesh(...).shape for 1..8
  devices with every view_shards / tile_shards that divides them, and
  raises where make_mesh asserts;
* two simulated processes complete a scan into shared storage and any
  re-run finds it done (tests/test_distributed.py:40-59);
* init_distributed is a no-op for one process and raises, without
  waiting, when torchrun's variables are incomplete;
* launch.spawn, like every entry point, runs on the card unless asked
  for the CPU: with no card and no device it raises before any rank
  starts;
* in a 2-rank gloo world (spawned), cli.main([... '--distributed',
  '--device', 'cpu', '--all_views', '--fuse']) writes every view's
  disp.dmb bit-equal to the single-process run's and a fused.ply with the
  single-process --fuse run's point count, points within 1e-5 (the
  sharded fusion adds its partial sums in another order)."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gipuma_tpu.parallel.distributed import owned_jobs as j_owned_jobs
from gipuma_tpu.parallel.mesh import make_mesh as j_make_mesh
from tests.test_torch_cli import FUSE, _flags, _write_scene

from gipuma_tpu_torch import cli as tcli
from gipuma_tpu_torch.config import AlgorithmParams
from gipuma_tpu_torch.io.dmb import read_dmb
from gipuma_tpu_torch.io.ply import read_ply
from gipuma_tpu_torch.io.vis import save_png
from gipuma_tpu_torch.parallel import launch
from gipuma_tpu_torch.parallel.distributed import (init_distributed,
                                                   owned_jobs,
                                                   run_batch_distributed)
from gipuma_tpu_torch.parallel.mesh import mesh_shape
from gipuma_tpu_torch.utils.synthetic import make_ring_P, plane_scene

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def test_port_imports_no_jax():
    """The parallel layer imports neither JAX nor the JAX package (fresh
    interpreter)."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import gipuma_tpu_torch.parallel.distributed, "
         "gipuma_tpu_torch.parallel.mesh, gipuma_tpu_torch as g; "
         "print(g.foreign_modules())"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


@pytest.mark.parametrize("n_jobs", [1, 5, 8, 17])
def test_owned_jobs_match_jax(n_jobs):
    for P in (1, 2, 3, 8):
        blocks = [owned_jobs(n_jobs, p, P) for p in range(P)]
        assert blocks == [j_owned_jobs(n_jobs, p, P) for p in range(P)]
        assert [j for b in blocks for j in b] == list(range(n_jobs))
        sizes = [len(b) for b in blocks]
        assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax(n):
    divisors = [d for d in range(1, n + 1) if n % d == 0]
    cases = [dict(), dict(max_view_shards=2), dict(max_view_shards=8)]
    cases += [dict(view_shards=v) for v in range(1, n + 1)]
    cases += [dict(tile_shards=t) for t in divisors]
    cases += [dict(tile_shards=t, view_shards=v) for t in divisors
              for v in range(1, n // t + 1)]
    for kw in cases:
        try:
            want = j_make_mesh(n, **kw).shape
        except AssertionError:
            with pytest.raises(ValueError):
                mesh_shape(n, **kw)
            continue
        assert mesh_shape(n, **kw) == (want["job"], want["tile"],
                                       want["view"]), kw


def test_two_simulated_hosts_complete_a_scan(tmp_path):
    images, _, _, _ = plane_scene(num_cams=4, h=48, w=64, focal=90.0,
                                  plane_depth=5.0)
    Ps = make_ring_P(4, 48, 64, 90.0, target_depth=5.0)
    pdir = tmp_path / "cams"
    pdir.mkdir()
    paths = []
    for i, (im, P) in enumerate(zip(images, Ps)):
        name = f"cam{i:03d}.png"
        save_png(tmp_path / name, np.clip(im, 0, 255).astype(np.uint8))
        (pdir / f"{name}.P").write_text(
            "\n".join(" ".join(f"{v:.10g}" for v in row) for row in P))
        paths.append(str(tmp_path / name))
    params = AlgorithmParams(box_hsize=7, box_vsize=7, iterations=1,
                             depth_min=3.0, depth_max=8.0,
                             min_angle=0.01, max_angle=60.0)
    root = tmp_path / "results"
    for p in range(2):   # each "process" runs its block into shared storage
        run_batch_distributed(paths, params, root, p_folder=str(pdir),
                              ref_indices=[0, 1, 2], process_index=p,
                              process_count=2, device="cpu")
    for ref in range(3):
        assert (root / f"cam{ref:03d}" / "disp.dmb").exists()
    # Elastic restart: any process re-running finds everything done.
    again = run_batch_distributed(paths, params, root, p_folder=str(pdir),
                                  ref_indices=[0, 1, 2], process_index=0,
                                  process_count=1, device="cpu")
    assert again == []


def test_init_distributed_single_process(monkeypatch):
    for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    assert init_distributed(device="cpu") == (0, 1)
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        init_distributed(device="cpu")
    assert not dist.is_initialized()


def test_spawn_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.spawn(launch.run_tasks, 2, args=([],))


def test_cli_distributed_fuse_matches_single(tmp_path, monkeypatch):
    names = _write_scene(tmp_path)
    dist_out = tmp_path / "dist"
    argv = _flags(tmp_path, dist_out) + names + FUSE + ["--distributed"]
    recs = launch.spawn(launch.run_tasks, 2,
                        args=([dict(kind="cli", argv=argv)],), device="cpu",
                        timeout=300)
    assert [r[0]["result"]["rc"] for r in recs] == [0, 0]
    # No timestamp directory: the processes share the output folder.
    got_pts, got_nrm = read_ply(dist_out / "fused.ply")[:2]

    monkeypatch.setattr(tcli.time, "strftime", lambda fmt: "run")
    one_out = tmp_path / "one"
    assert tcli.main(_flags(tmp_path, one_out) + names + FUSE) == 0
    want_pts, want_nrm = read_ply(one_out / "run" / "fused.ply")[:2]
    assert len(got_pts) == len(want_pts) > 0.25 * 48 * 64
    np.testing.assert_allclose(got_pts, want_pts, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_nrm, want_nrm, rtol=1e-5, atol=1e-5)
    for n in names:
        stem = Path(n).stem
        np.testing.assert_array_equal(read_dmb(dist_out / stem / "disp.dmb"),
                                      read_dmb(one_out / "run" / stem
                                               / "disp.dmb"))
