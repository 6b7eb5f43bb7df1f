"""gipuma_tpu_torch kernel build table (kernels.py), checked on the CPU
without running nvcc: every source under csrc/ has a complete nvcc command
for sm_90a with its own flags, and the flags take part in the library's
name, so a change of flags rebuilds it."""
from pathlib import Path

import pytest

from gipuma_tpu_torch import kernels

# Sources held bit-equal to their plain versions: no FMA contraction.
BIT_EQUAL = ("rowgather", "sampling", "rowgather_lerp", "rowgather_affine",
             "permute2d")


def test_every_source_has_flags():
    assert set(kernels.SOURCE_FLAGS) == set(kernels.SOURCES)
    on_disk = {p.name for p in kernels.CSRC.glob("*.cu")}
    assert set(kernels.SOURCES.values()) == on_disk


@pytest.mark.parametrize("name", sorted(kernels.SOURCES))
def test_nvcc_command_is_complete(name, tmp_path):
    out = tmp_path / f"lib{name}.so"
    cmd = kernels.nvcc_command(name, out, nvcc="toolkit/bin/nvcc")
    assert cmd[0] == "toolkit/bin/nvcc"
    i = cmd.index("-gencode")
    assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
    for flag in ("-std=c++17", "-O3", "-shared"):
        assert flag in cmd
    assert cmd[cmd.index("-Xcompiler") + 1] == "-fPIC"
    assert cmd[cmd.index("-o") + 1] == str(out)
    src = Path(cmd[-1])
    assert src == kernels.CSRC / kernels.SOURCES[name] and src.is_file()
    fmad = [f for f in cmd if f.startswith("-fmad=")]
    assert fmad == (["-fmad=false"] if name in BIT_EQUAL else ["-fmad=true"])
    assert cmd[1:-3] == kernels.flags(name)


def test_library_name_follows_flags(monkeypatch):
    before = kernels._target("sdg_fused")
    monkeypatch.setitem(kernels.SOURCE_FLAGS, "sdg_fused", ["-fmad=false"])
    assert kernels._target("sdg_fused") != before
    assert kernels._target("rowgather") != kernels._target("sdg_fused")


def test_every_kernel_has_a_count():
    kernels.reset_counts()
    assert set(kernels.counts) == {
        "row_gather_nearest", "sdg_fused_cost", "bilinear_sample",
        "row_gather_lerp", "row_gather_affine", "permute2d"}
    assert all(v == 0 for v in kernels.counts.values())
