"""The check that decides ``correct``, driven through a whole run on the
CPU at a small size (the harness's look for a card skipped): a sound run
passes limits set above its own numbers; each fault the cells can have,
planted in the program underneath, turns ``correct`` false; the control
fails the cell's real limits."""
import time

import pytest
import torch

from conftest import load_cell, tiny_cell
from portbench import check, core, readings

# Each cell at a size the CPU runs in tens of seconds (DTU's box 15 and
# nine source views need the smaller image).
CELLS = {"dino.exact": 8, "dtu_fast.exact": 16}


def run(cell, seed=7, seconds=0.1):
    return core.run_cell(cell, seed, seconds, False, "cpu",
                         time.perf_counter(), log=lambda *a: None)


@pytest.fixture(scope="module", params=sorted(CELLS))
def cell(request):
    """A cell with limits half again above a sound run's own numbers (zero
    stays 0)."""
    torch.set_num_threads(2)
    c = tiny_cell(request.param, scale=CELLS[request.param], views=2)
    c.limits = {"checks": {}}
    res = run(c)
    c.limits = {"checks": {k: {"limit": 1.5 * r["value"]}
                           for k, r in res["checks"].items()}}
    return c


def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert {"mpix_per_s", "depth_rel_err_median", "setup_s"} <= set(res["metrics"])
    assert "peak_device_gb" not in res["metrics"]
    assert list(res)[-1] == "checks"


def _state_unchanged(mp):
    from gipuma_tpu_torch.models import patchmatch
    mp.setattr(patchmatch, "iteration", lambda state, *a, **k: state)


def _half_the_views(mp):
    from gipuma_tpu_torch import pipeline
    orig = pipeline.select_views

    def half(*a, **k):
        subset, lo, hi = orig(*a, **k)
        return subset[:max(1, len(subset) // 2)], lo, hi
    mp.setattr(pipeline, "select_views", half)


def _depth_altered(mp):
    from gipuma_tpu_torch import pipeline
    orig = pipeline.run_prepared_job

    def altered(job):
        res = orig(job)
        res.depth = res.depth * 1.1
        return res
    mp.setattr(pipeline, "run_prepared_job", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_views,
                                   _depth_altered])
def test_faults_make_the_run_incorrect(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_fails_the_cells_limits(workload):
    """The reference in the program's place, one precision step down, is
    refused by the cell's real limits."""
    c = tiny_cell(workload, scale=CELLS[workload], views=2)
    real = load_cell(workload).limits["checks"]
    if any(v.get("limit") is None for v in real.values()):
        pytest.skip("limits not set yet")
    from portbench import scene as sc
    scene = sc.make_scene(c.config, 5, "cpu")
    outs, cost_of = check.control_outputs(scene, [0, 1], c.config, "cpu")
    nums = check.judge(scene, outs, c.config, 5, "cpu", cost_of=cost_of)
    ok, rows = check.verdict(nums, real)
    assert not ok, rows


def test_readings_summary_takes_the_extremes():
    c = tiny_cell("dino.exact", views=1)
    out = readings.readings(c, [3, 4], 1, "cpu", log=lambda *a: None)
    s = out["summary"]
    assert s["cost_gap"]["lower"] == max(x["program"]["cost_gap"] for x in out["lines"])
    assert s["cost_gap"]["upper"] == min(x["control"]["cost_gap"] for x in out["lines"])
    assert s["cost_gap"]["upper"] > 3 * s["cost_gap"]["lower"]
