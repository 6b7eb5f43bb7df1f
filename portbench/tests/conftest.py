"""Shared pieces of the benchmark's CPU tests: a cell of a configuration
cut to a size the CPU runs in seconds (the rig's image and focal length
scaled down together, the texture's cells scaled up with them)."""
import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where none is present")


def load_cell(workload: str):
    from portbench import core
    return core.load_cell(workload)


def tiny_cell(workload: str, scale: int = 8, views: int = 3):
    cell = copy.deepcopy(load_cell(workload))
    cfg = cell.config
    cfg["rig"]["width"] //= scale
    cfg["rig"]["height"] //= scale
    K = np.array(cfg["rig"]["K"])
    K[:2] /= scale
    cfg["rig"]["K"] = K.tolist()
    cfg["scene"]["texture"]["octaves"] = [
        [c * scale, w] for c, w in cfg["scene"]["texture"]["octaves"]]
    cfg["check"].update(trim=4, views=views, pixels=400)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell


@pytest.fixture
def root():
    return ROOT


def load(path):
    with open(path) as f:
        return json.load(f)
