"""gipuma_tpu_torch.eval.parity on the CPU against the JAX package's
gates and formatters:

* a preset row (run_preset_parity, middlebury on the sos texture at the
  JAX test's 64x96 / 3 iterations) meets tests/test_parity_presets.py's
  thresholds;
* a hard-scene row (run_cull_hard_scene, the occluding two-plane scene)
  meets tests/test_cull_hard_scenes.py's;
* the same row dicts render to the same markdown through both packages'
  format_markdown and format_hard_scene_markdown.
The other three preset cases and hard-scene kinds run on the card in
chip_smoke.py's parity phase (each takes ~10-40 s on one CPU thread)."""
import numpy as np
import pytest
import torch

from gipuma_tpu.eval import parity as jparity

from gipuma_tpu_torch.eval import parity as tparity

# The suite runs under pytest-xdist beside JAX's thread pools; at these
# sizes torch's intra-op threads only oversubscribe the cores.
torch.set_num_threads(1)


def _preset_gate(r):
    """tests/test_parity_presets.py's assertions."""
    assert r["exact"]["median"] < 8e-3, r["exact"]
    assert r["rect"]["median"] < 8e-3, r["rect"]
    assert r["rect"]["median"] < 2.0 * max(r["exact"]["median"], 2e-3), r
    assert r["gap"]["median"] < 1.2e-2, r["gap"]
    assert r["rect"]["valid_frac"] > 0.95
    assert r["rect_normals"]["median_deg"] < 1.5 * max(
        r["exact_normals"]["median_deg"], 6.0), r["rect_normals"]


def _same_error_class(cull, plain, label, med_cap=5e-3, p99_factor=2.5):
    """tests/test_cull_hard_scenes.py's class check."""
    assert cull["median"] < max(2.0 * plain["median"], med_cap), \
        (label, cull, plain)
    assert cull["p99"] < max(p99_factor * plain["p99"], 10 * med_cap), \
        (label, cull, plain)


def test_preset_parity_row():
    r = tparity.run_preset_parity("middlebury", 64, 96, iterations=3,
                                  border=10, texture="sos", device="cpu")
    _preset_gate(r)
    assert r["preset"] == "middlebury" and r["box"] == (11, 11)


def test_cull_hard_scene_two_plane():
    r = tparity.run_cull_hard_scene("two_plane", device="cpu")
    _same_error_class(r["cull"], r["plain"], "two_plane overall")
    _same_error_class(r["cull_region"], r["plain_region"], "two_plane band",
                      p99_factor=3.0)


def _stats(rng, keys):
    return {k: float(rng.uniform(1e-4, 1e-1)) for k in keys}


def test_formatters_match_jax():
    rng = np.random.default_rng(5)
    rows = []
    for preset, tex in (("middlebury", "sos"), ("dtu_fast+cull", "noise")):
        rows.append({
            "preset": preset, "shape": (64, 96), "texture": tex,
            "iterations": 3, "box": (11, 11),
            "exact": _stats(rng, ("median", "p99", "max", "valid_frac")),
            "rect": _stats(rng, ("median", "p99", "max", "valid_frac")),
            "gap": _stats(rng, ("median", "p99", "max")),
            "exact_normals": _stats(rng, ("median_deg", "p99_deg")),
            "rect_normals": _stats(rng, ("median_deg", "p99_deg"))})
    assert tparity.format_markdown(rows) == jparity.format_markdown(rows)
    hard = []
    for kind in ("two_plane", "textureless_patch"):
        row = {"kind": kind, "shape": (64, 96), "iterations": 4}
        for k in ("plain", "cull", "plain_region", "cull_region",
                  "plain_outside", "cull_outside"):
            row[k] = _stats(rng, ("median", "p99"))
        hard.append(row)
    hard[1]["cull_region"] = {"median": float("nan"), "p99": float("nan")}
    assert tparity.format_hard_scene_markdown(hard) == \
        jparity.format_hard_scene_markdown(hard)
