"""The folder driver (``portbench/folder.py``) driven end to end on the CPU:
two gloo ranks scan a 3x3 cap of 96x72 views through the program's command
line (box 5, one iteration), then the check.  A sound run passes limits set
above its own numbers; each fault a scan can have, planted in every rank or
in one, turns ``correct`` false; a rank that dies or hangs ends the run
with every rank ended; the reference fusion agrees with the program's; the
control fails the cell's real limits; a mix without a driver still runs
``core.run_cell``; a reader added as a file hooks into every rank.  The
cell is read from BENCHMARK.json once its entries are there, and until
then from its pending entries (``portbench/pending/``) laid over it."""
import importlib.util
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import ROOT, load, load_cell
from portbench import core, folder, folder_check, reference, reference_fusion
from portbench import scene as sc

WORKLOAD = "dtu_fast.folder_4card"
FAULTS = str(ROOT / "portbench" / "tests" / "folder_faults.py")
PENDING = ROOT / "portbench" / "pending" / f"{WORKLOAD}.json"
ENTRIES = ("configs", "workloads", "per_layer")


def with_pending(bench: dict) -> dict:
    """BENCHMARK.json's entries with the cell's pending entries that it
    does not hold yet appended as they stand."""
    pend = load(PENDING)
    return dict(bench, **{k: bench[k] + [
        e for e in pend[k] if e["name"] not in {o["name"] for o in bench[k]}]
        for k in ENTRIES})


def load_folder_cell():
    """The cell as core.load_cell makes it: from BENCHMARK.json once its
    entries are there, until then with its pending entries appended."""
    bench = load(ROOT / "BENCHMARK.json")
    if WORKLOAD in {w["name"] for w in bench["workloads"]}:
        return core.load_cell(WORKLOAD)
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        (d / "BENCHMARK.json").write_text(json.dumps(with_pending(bench)))
        (d / "portbench").symlink_to(ROOT / "portbench")
        return core.load_cell(WORKLOAD, root=d)


def tiny_folder_cell(ranks=2):
    """The cell at a 3x3 cap of 96x72 views (focal length and texture cells
    scaled with the image), box 5 and one iteration, on `ranks` ranks."""
    cell = load_folder_cell()
    cfg = cell.config
    rig = cfg["rig"]
    s = 96 / rig["width"]
    rig.update(rows=3, cols=3, views=9, width=96, height=72)
    K = np.array(rig["K"])
    K[:2] *= s
    rig["K"] = K.tolist()
    cfg["scene"]["texture"]["octaves"] = [
        [c / s, w] for c, w in cfg["scene"]["texture"]["octaves"]]
    cfg["flags"] = cfg["flags"] + ["-blocksize", "5", "--iterations", "1"]
    cfg["method"].update(box=5, iterations=1)
    cfg["check"].update(trim=4, cloud_points=400)
    cell.workload = dict(cell.workload, chips=ranks)
    return cell


def run(cell, seed=7, trace=False, **kw):
    return folder.run_cell(cell, seed, 0.1, trace, "cpu", time.perf_counter(),
                           log=lambda *a: None, **kw)


@pytest.fixture(scope="module")
def cell():
    """A tiny cell with limits half again above a sound run's own numbers
    (zero stays 0)."""
    c = tiny_folder_cell()
    c.limits = {"checks": {}}
    res = run(c)
    c.limits = {"checks": {k: {"limit": 1.5 * r["value"]}
                           for k, r in res["checks"].items()}}
    return c


def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert (res["views"], res["attempted"], res["failed"]) == (9, 9, 0)
    assert res["device"]["count"] == 2
    assert {"mpix_per_s", "depth_rel_err_median",
            "setup_s"} <= set(res["metrics"])
    assert set(res["checks"]) == {"views_wrong", "depth_err", "fusion_gap",
                                  "cloud_err"}
    assert list(res)[-1] == "checks"
    assert not (folder.SCAN_DIR).exists()


def test_traced_run_reads_the_layers(cell):
    """On the CPU a traced run has the host-side layer readings (no device
    trace), those of the readers' hooks in the ranks among them."""
    res = run(cell, seed=8, trace=True)
    m = res["metrics"]
    assert {"fusion_s_per_scan", "write_s_per_view",
            "rank_wait_share"} <= set(m)
    assert m["fusion_s_per_scan"]["value"] > 0
    assert m["write_s_per_view"]["value"] > 0
    assert m["readback_s_per_scan"]["value"] > 0
    # 9 views on 2 ranks: 5 and 4, so about 0.1 of the slower rank's wall.
    assert 0.0 <= m["rank_wait_share"]["value"] < 0.5
    assert "breakdown" not in res


@pytest.mark.parametrize("fault", [
    "num_consistent_2", "dmb_deleted", "depths_bf16_before_fusion",
    "exchange_left_out", "state_unchanged", "depth_altered",
    "half_the_views", "state_unchanged_on_rank_1",
    "depth_altered_on_rank_1"])
def test_faults_make_the_run_incorrect(cell, fault):
    res = run(cell, hook=(FAULTS, fault))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault,limits", [
    ("rank_dies", (folder.SETUP_LIMIT_S, folder.SCAN_LIMIT_S)),
    ("rank_hangs", (folder.SETUP_LIMIT_S, 20.0))])
def test_a_failed_rank_ends_the_run(cell, fault, limits):
    """The run raises within its limit, with no rank left and the scan's
    folder removed."""
    t0 = time.monotonic()
    with pytest.raises(folder.RunFailed):
        run(cell, hook=(FAULTS, fault), limits=limits)
    assert time.monotonic() - t0 < 120
    assert multiprocessing.active_children() == []
    assert not folder.SCAN_DIR.exists()


def test_reference_fusion_agrees_with_the_program():
    """Ground-truth depths with a seeded relative noise (some pixels off by
    far more than the disparity threshold), fused by the program on the CPU
    and by the plain reference in float64: the same points."""
    from gipuma_tpu_torch.config import FusionParams
    from gipuma_tpu_torch.fusion.fuse import fuse_depthmaps
    cfg = tiny_folder_cell().config
    scene = folder_check.bare_scene(cfg)
    rng = np.random.default_rng(3)
    depths, normals = [], []
    for v in range(len(scene.cameras)):
        d, n = sc.ground_truth(scene, v, "cpu")
        d = torch.where(torch.isfinite(d), d, 0.0).numpy()
        noise = rng.normal(0.0, 2e-4, d.shape) * (rng.random(d.shape) < 0.9) \
            + rng.normal(0.0, 2e-2, d.shape) * (rng.random(d.shape) < 0.1)
        depths.append((d * (1 + noise)).astype(np.float32))
        normals.append(n.numpy().astype(np.float32))
    depths, normals = np.stack(depths), np.stack(normals)
    fp = cfg["fusion"]
    got, _, _ = fuse_depthmaps(depths, normals, scene.Ps, FusionParams(
        disp_thresh=fp["disp_thresh"], normal_thresh=fp["normal_thresh"],
        num_consistent=fp["num_consistent"]), device="cpu")
    want, _ = reference_fusion.fuse(depths, normals, scene.Ps, fp,
                                    cfg["rig"]["K"][0][0])
    assert 1000 < len(want) < depths.size
    assert abs(len(got) - len(want)) <= 1e-3 * len(want)
    gap = folder_check.cloud_gap(torch.as_tensor(got, dtype=torch.float64),
                                 want, cfg["check"],
                                 np.random.default_rng(0), 500.0)
    assert gap < 1e-3


def test_readings_take_a_whole_run_and_the_control_a_seed():
    from portbench import readings
    c = tiny_folder_cell()
    out = readings.readings(c, [9], None, "cpu", log=lambda *a: None)
    line, summary = out["lines"][0], out["summary"]
    assert set(line["program"]) == set(line["control"]) == set(summary)
    assert line["failed"] == 0
    for k in summary:
        assert summary[k]["lower"] == line["program"][k]
        assert summary[k]["upper"] == line["control"][k]
    # At this size only fusion is as exact as at the cell's own.
    assert summary["fusion_gap"]["upper"] > 3 * summary["fusion_gap"]["lower"]


def test_control_fails_the_cells_limits():
    """The references in the program's place, one precision step down, are
    refused by the cell's real limits."""
    real = load_folder_cell().limits["checks"]
    if any(v.get("limit") is None for v in real.values()):
        pytest.skip("limits not set yet")
    from portbench import check
    nums = folder_check.control_numbers(tiny_folder_cell().config, 5, "cpu")
    ok, rows = check.verdict(nums, real)
    assert not ok, rows


def test_surface_distance_and_cloud_gap():
    cfg = load_folder_cell().config
    X = torch.tensor([[0.0, 0.0, 70.0], [0.0, 0.0, 75.0], [300.0, 0.0, -79.0]],
                     dtype=torch.float64)
    d = folder_check.surface_distance(X, cfg["scene"])
    assert torch.allclose(d, torch.tensor([0.0, 5.0, 1.0],
                                          dtype=torch.float64))
    chk = {"cloud_points": 3, "cloud_quantile": 1.0}
    rng = np.random.default_rng(0)
    assert folder_check.cloud_gap(X, X, chk, rng, 500.0) == 0.0
    gap = folder_check.cloud_gap(X[:2], X, chk, rng, 500.0)
    assert gap == pytest.approx(max(1 / 3, math.dist(X[2], X[0]) / 500.0))


def test_every_reference_of_the_scan_selects_nine():
    """Every reference of the 5x5 cap keeps the preset's 9 source views,
    and no view's angle lies within 0.1 degree of the 10-30 degree window."""
    cfg = load_folder_cell().config
    cams = sc.camera_layout(cfg["rig"])
    w, h, p = cfg["rig"]["width"], cfg["rig"]["height"], cfg["method"]
    for r in range(len(cams)):
        subset, _, _ = reference.select_views(cams, r, w, h, p)
        assert len(subset) == 9
        ang = reference.selection_angles(cams, r, w, h)
        assert min(min(abs(a - 10.0), abs(a - 30.0)) for a in ang) > 0.1


def test_flags_are_held_to_the_configuration():
    c = tiny_folder_cell()
    assert folder.cli_flags(c.config, c.mix)[-1] == "--distributed"
    with pytest.raises(core.ConfigError):
        folder.cli_flags(c.config, dict(c.mix, flags=[]))
    c.config["fusion"]["num_consistent"] = 2
    with pytest.raises(core.ConfigError):
        folder.cli_flags(c.config, c.mix)
    c = tiny_folder_cell()
    with pytest.raises(core.ConfigError):
        folder.cli_flags(c.config, dict(c.mix, params={"iterations": 2}))


def test_spans_flatten_to_the_innermost():
    spans = [(0, 100, "cli"), (10, 60, "run_batch"), (20, 30, "write_outputs"),
             (40, 50, "write_outputs"), (70, 90, "fusion")]
    assert folder.flatten(spans) == [
        (0, 10, "cli"), (10, 20, "run_batch"), (20, 30, "write_outputs"),
        (30, 40, "run_batch"), (40, 50, "write_outputs"),
        (50, 60, "run_batch"),
        (60, 70, "cli"), (70, 90, "fusion"), (90, 100, "cli")]


def test_runner_dispatches_on_the_mix():
    """A mix without a driver runs core.run_cell, as before the folder
    driver; a mix naming one runs its module; an unknown name is refused."""
    spec = importlib.util.spec_from_file_location(
        "portbench_run_under_test", ROOT / "portbench" / "run.py")
    run_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_mod)
    assert run_mod.driver(load_cell("dtu_fast.exact")) is core
    assert run_mod.driver(load_cell("dino.exact")) is core
    assert run_mod.driver(load_folder_cell()) is folder
    c = load_folder_cell()
    for bad in ("nothing", "../run", 3):
        c.mix = dict(c.mix, driver=bad)
        with pytest.raises(core.ConfigError):
            run_mod.driver(c)


def test_pending_entries_keep_to_the_contract():
    """The pending entries name one 4-card cell, its configuration and its
    per-layer metrics, each new to BENCHMARK.json or the same there byte
    for byte, with readers, and metrics that move an end-to-end metric the
    cell reports."""
    import re
    bench = load(ROOT / "BENCHMARK.json")
    pend = load(PENDING)
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for k in ENTRIES:
        old = {e["name"]: json.dumps(e) for e in bench[k]}
        for e in pend[k]:
            assert name.match(e["name"]), e
            assert old.get(e["name"], json.dumps(e)) == json.dumps(e), e
    assert [w["name"] for w in pend["workloads"]] == [WORKLOAD]
    assert pend["workloads"][0]["chips"] == 4
    cell = load_folder_cell()
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e and m["workloads"] == [WORKLOAD]
        assert hasattr(core.metric_module(m["name"]), "read")
    assert len(json.dumps(with_pending(bench))) < 64 * 1024


# A reader that counts the calls of the program's read_dmb in each rank of
# each scan, and reads the count only where every rank saw the same.
COUNT_READER = '''
def install(rctx):
    from gipuma_tpu_torch.io import dmb
    return rctx.time_calls(dmb, "read_dmb", "calls")


def read(ctx):
    counts = {sum(lo <= a and b <= hi for a, b in r["store"]["calls"])
              for r in ctx.ranks for lo, hi in r["scans"]}
    if len(ctx.ranks) != 2 or len(counts) != 1:
        raise ValueError(f"read_dmb calls by rank and scan: {counts}")
    return counts.pop()
'''

# A reader whose hook raises in rank 1.
RAISING_READER = '''
def install(rctx):
    if rctx.rank == 1:
        raise RuntimeError("a reader's hook failed in rank 1")


def read(ctx):
    return 1.0
'''

# Run in a copy of the benchmark: the tiny cell, traced, on two ranks; the
# result line, or the failure with the children left.
RUN_IN_COPY = '''
import json, multiprocessing, sys
sys.path.insert(0, "portbench/tests")
import test_portbench_folder as t
from portbench import folder
try:
    res = t.run(t.tiny_folder_cell(), seed=11, trace=True)
except folder.RunFailed as e:
    res = {"failed_with": str(e),
           "children": len(multiprocessing.active_children()),
           "scan_dir": folder.SCAN_DIR.exists()}
print(json.dumps(res, default=str))
'''


def copy_with_cell(d: Path, readers: dict | None = None) -> Path:
    """A copy of the benchmark as the change that adds the cell leaves it:
    the pending entries appended to BENCHMARK.json as they stand, and for
    each of `readers` (name -> source) one reader file and its per-layer
    entry; the program linked in."""
    shutil.copytree(ROOT / "portbench", d / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = with_pending(load(ROOT / "BENCHMARK.json"))
    for name, src in (readers or {}).items():
        (d / "portbench" / "metrics" / f"{name}.py").write_text(src)
        bench["per_layer"].append({
            "name": name, "unit": "calls", "better": "lower",
            "source": "program_counter", "layer": "io",
            "moves": "mpix_per_s", "workloads": [WORKLOAD]})
    (d / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    (d / "gipuma_tpu_torch").symlink_to(ROOT / "gipuma_tpu_torch")
    return d


def run_in_copy(d: Path, timeout: float = 600) -> dict:
    r = subprocess.run([sys.executable, "-c", RUN_IN_COPY], cwd=d,
                       capture_output=True, text=True, timeout=timeout,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_a_reader_added_as_a_file_hooks_into_every_rank(tmp_path):
    """One new reader file and its entry, nothing edited: its hook counts
    the program's read_dmb in both ranks, 2 x 9 calls a scan (each rank
    reads every view's disp.dmb and normals.dmb back before fusion)."""
    res = run_in_copy(copy_with_cell(tmp_path, {"read_dmb_calls":
                                                COUNT_READER}))
    assert (res["views"], res["failed"]) == (9, 0)
    assert res["metrics"]["read_dmb_calls"]["value"] == 18
    assert res["metrics"]["readback_s_per_scan"]["value"] > 0


def test_a_hook_that_raises_ends_the_run(tmp_path):
    """A reader's hook that raises in rank 1 ends the run as a failed rank
    does: no result, no rank left, the scan's folder removed."""
    res = run_in_copy(copy_with_cell(tmp_path,
                                     {"hook_raises": RAISING_READER}))
    assert "a reader's hook failed in rank 1" in res["failed_with"]
    assert res["children"] == 0 and not res["scan_dir"]


def test_the_tests_pass_with_the_pending_entries_appended(tmp_path):
    """The tests that read BENCHMARK.json's lists (this file, this test
    left out, and the files' tests) in a copy whose BENCHMARK.json holds
    the pending entries appended as they stand.  The check's and the
    arithmetic's tests name the exact cells and read nothing the append
    changes."""
    d = copy_with_cell(tmp_path)
    bench = load(d / "BENCHMARK.json")
    assert WORKLOAD in {w["name"] for w in bench["workloads"]}
    assert with_pending(bench) == bench
    here = "portbench/tests/test_portbench_folder.py"
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider", "-q",
         here, "portbench/tests/test_portbench_files.py", "--deselect",
         f"{here}::test_the_tests_pass_with_the_pending_entries_appended"],
        cwd=d, capture_output=True, text=True, timeout=1200,
        env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    assert " passed" in r.stdout.splitlines()[-1]
