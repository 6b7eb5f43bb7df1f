"""The suite's clock (tests/time_limit.py).  The per-test time limit, in a
pytest run of its own with a 1 s limit: a test past the limit fails with the
limit's message, and the test after it still runs and passes.  Under xdist a
test stuck where the timer cannot reach it ends its worker after the margin,
and the run goes on in a new worker.  A test marked `slow` has no limit.
The slow list: `-m slow` selects exactly the listed JAX-package tests."""
import subprocess
import sys
from pathlib import Path

import pytest
from time_limit import SLOW

pytest_plugins = ["pytester"]

TESTS = Path(__file__).resolve().parent

CONFTEST = f"""
import sys
sys.path.insert(0, {str(TESTS)!r})
import time_limit
time_limit.LIMIT_S = 1
time_limit.MARGIN_S = 2


def pytest_configure(config):
    config.pluginmanager.register(time_limit)
"""

TEST_FILE = """
import signal
import time

import pytest


{decorator}
def test_past_the_limit():
    {body}


def test_after_it():
    pass
"""

CASES = {
    "sleeps": ("", "time.sleep(30)"),
    # The alarm stays pending while the main thread sleeps; only the
    # watchdog can end the test.
    "blocks_the_alarm": ("", "signal.pthread_sigmask(signal.SIG_BLOCK, "
                             "{signal.SIGALRM}); time.sleep(30)"),
    "slow": ("@pytest.mark.slow", "time.sleep(2)"),
}


@pytest.mark.parametrize("case, workers", [
    ("sleeps", 0), ("sleeps", 2), ("blocks_the_alarm", 2), ("slow", 0)])
def test_past_the_limit_fails_and_the_run_goes_on(pytester, case, workers):
    decorator, body = CASES[case]
    pytester.makeconftest(CONFTEST)
    pytester.makepyfile(test_limit=TEST_FILE.format(decorator=decorator,
                                                    body=body))
    args = ["-p", "xdist", "-n", str(workers)] if workers else []
    result = pytester.runpytest_subprocess(*args, "-p", "no:randomly",
                                           timeout=60)
    if case == "slow":
        result.assert_outcomes(passed=2)
        return
    result.assert_outcomes(passed=1, failed=1)
    if case == "sleeps":
        result.stdout.fnmatch_lines([
            "*test_limit.py::test_past_the_limit (call) ran past the "
            "per-test time limit of 1 s*"])
    else:
        result.stdout.fnmatch_lines([
            "*crashed while running*test_past_the_limit*"])


def test_slow_set_is_the_listed_jax_tests():
    """Every entry of SLOW names a test of the JAX reference package's own
    files, and `-m slow` collects those tests and no other."""
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "--collect-only", "-q",
         "-m", "slow", "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=TESTS.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    collected = {}
    for line in out.stdout.splitlines():
        if line.startswith("tests/") and "::" in line:
            path, name = line.split("::", 1)
            collected.setdefault(Path(path).name, set()).add(
                name.split("[")[0])
    assert collected == SLOW
    assert not any(f.startswith("test_torch_") for f in SLOW)
