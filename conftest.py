"""pytest's root configuration: loads the test suite's clock, the slow list
and the per-test time limit (tests/time_limit.py), for every run from the
repository's root."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

import time_limit  # noqa: E402


def pytest_configure(config):
    config.pluginmanager.register(time_limit)
