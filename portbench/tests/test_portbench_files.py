"""The benchmark's files: every cell resolves by name, names and units keep
to the allowed characters, a mix added as a file is found, the forbidden
module check, the reference's independence, and the runner's refusal
without a card."""
import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return load(ROOT / "BENCHMARK.json")


def test_every_cell_resolves_by_name():
    from portbench import core
    b = bench()
    for w in b["workloads"]:
        cell = core.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.mix["name"] == w["traffic"]
        assert "views_wrong" in cell.limits["checks"]
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(core.metric_module(m["name"]), "read")
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
        core.program_params(cell.config, cell.mix)


def test_names_units_and_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    metrics = b["end_to_end"] + b["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["traffic"] for w in b["workloads"]]
    for n in names:
        assert NAME.match(n), n
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert "\n" not in m["layer"] and 0 < len(m["layer"]) <= 200
    for e in b["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for c in b["configs"]:
        assert c["file"].startswith("portbench/")
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert len(json.dumps(b)) < 64 * 1024


def test_a_mix_added_as_a_file_is_found(tmp_path):
    """A new mix and cell need only new files and entries: a copy of the
    benchmark with a mix file added resolves the new cell unedited."""
    from portbench import core
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    b["workloads"].append({"name": "dino.exact_again",
                           "config": "middlebury_dino_sparse_ring",
                           "traffic": "exact_again", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    mix = load(ROOT / "portbench/mixes/exact.json")
    mix["name"] = "exact_again"
    (tmp_path / "portbench/mixes/exact_again.json").write_text(json.dumps(mix))
    shutil.copy(ROOT / "portbench/limits/dino.exact.json",
                tmp_path / "portbench/limits/dino.exact_again.json")
    cell = core.load_cell("dino.exact_again", root=tmp_path)
    assert cell.mix["name"] == "exact_again"
    with pytest.raises(core.ConfigError):
        core.load_cell("dino.nothing", root=tmp_path)


def test_forbidden_modules():
    from portbench import core
    assert core.forbidden_modules(["gipuma_tpu.x", "jax", "numpy"]) == \
        ["gipuma_tpu.x", "jax"]
    assert core.forbidden_modules(["gipuma_tpu_torch.ops", "jaxtyping",
                                   "flaxen"]) == []
    assert core.forbidden_modules(["jaxlib.xla", "flax.linen"]) == \
        ["flax.linen", "jaxlib.xla"]


def _imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    for f in ("reference.py", "scene.py", "check.py"):
        assert not (_imports(ROOT / "portbench" / f)
                    & {"gipuma_tpu_torch", "gipuma_tpu", "jax", "jaxlib"}), f
    code = ("import sys; sys.path.insert(0, %r); import portbench.check; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('gipuma_tpu_torch', 'gipuma_tpu', 'jax', 'jaxlib')]; "
            "print(bad); sys.exit(1 if bad else 0)" % str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_runner_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "dino.exact", "--seed", "3", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA card" in r.stderr


def test_runner_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files gives
    no result."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "dino.exact", "--seed", "3", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
