"""The test suite's clock (pytest plugin): the slow list, and one time
limit for every other test.

`SLOW` lists the frozen JAX reference package's own multi-minute tests by
file and function (every parametrized case of a listed function).  They get
the `slow` marker at collection, so the tier-1 command (`-m 'not slow'`)
leaves them out and `pytest tests/ -m slow` runs them; their files are not
edited.  A test goes on the list when its call takes over 60 s under the
tier-1 command (`-n 6`) on a cold checkout, measured with the list as it
then stands; ROADMAP.md ("Tier-1 verify") has the rule in full.

Each phase of a test not marked `slow` (setup, call, teardown) gets LIMIT_S
seconds.  An interval timer raises a test failure that names the test and
the limit when the phase runs past it; the traceback shows where it was.
Code stuck below Python (a compile or a collective wait in C++) never lets
that failure through, so a faulthandler watchdog dumps every thread's stack
and ends the process MARGIN_S seconds later: under xdist the worker is
replaced and the run goes on.  Tests run in the main thread, also in
xdist's workers, so the timer's signal reaches them.

The limit is at least three times the longest phase of a test not marked
`slow` under the tier-1 command (`-n 6`, cold compile cache).  Tests
marked `slow` take up to half an hour each under `-m slow`, so they run
without a limit.  The repository's root `conftest.py` registers this
module.
"""
import contextlib
import faulthandler
import os
import signal
import sys
from pathlib import Path

import pytest

LIMIT_S = 600
MARGIN_S = 60

TESTS = Path(__file__).resolve().parent

# The JAX reference package's tests over 60 s, by file and function.
SLOW = {
    "test_cli.py": {"test_cli_census_end_to_end"},
    "test_cull_hard_scenes.py": {
        "test_cull_two_plane_discontinuity", "test_cull_textureless_patch",
        "test_cull_low_contrast"},
    "test_parity_presets.py": {"test_preset_parity"},
    "test_patchmatch.py": {"test_scan_runner_matches_host_loop_rect"},
    "test_pyramid.py": {"test_pyramid_fine_trims_quality"},
    "test_rect_engine.py": {
        "test_recovers_plane", "test_recovers_plane_onesided_edges",
        "test_census_cost_discriminates", "test_drop_unsupported_view",
        "test_two_plane_discontinuity", "test_permute_skip_is_exact",
        "test_pack_m_cost_error_is_small",
        "test_recovers_plane_two_stage_cull",
        "test_recovers_plane_cull_view_stride",
        "test_recovers_plane_cull_early_term"},
    "test_rect_sharding.py": {"test_rect_view_sharded_matches_single"},
    "test_sdg_fused.py": {
        "test_fused_sdg_matches_unfused",
        "test_fused_sdg_onesided_matches_unfused",
        "test_fused_roll_matches_aligned"},
    "test_shape_quantize.py": {"test_quantized_engine_quality"},
    "test_tiled.py": {
        "test_tiled_propagation_matches_single",
        "test_tiled_with_refinement_converges"},
    "test_tiled_rect.py": {
        "test_tiled_rect_depth_quality_and_seam",
        "test_tiled_rect_uneven_height_pads",
        "test_tiled_rect_portrait_aspect"},
}

_dump_fd = pytest.StashKey[int]()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: a JAX-package test over 60 s under the tier-1 "
        "command (tests/time_limit.py's SLOW); run them with -m slow")
    # During a test, fd 2 is pytest's capture file and is lost with the
    # process, so the watchdog writes to a copy of the session's stderr.
    try:
        fd = sys.stderr.fileno()
    except (AttributeError, ValueError, OSError):   # xdist's worker stream
        fd = sys.__stderr__.fileno()
    config.stash[_dump_fd] = os.dup(fd)


def pytest_unconfigure(config):
    os.close(config.stash[_dump_fd])


def pytest_itemcollected(item):
    if (item.path.parent == TESTS and getattr(item, "originalname", None)
            in SLOW.get(item.path.name, ())):
        item.add_marker(pytest.mark.slow)


@contextlib.contextmanager
def _limited(item, when):
    if item.get_closest_marker("slow") is not None:
        yield
        return

    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} ({when}) ran past the per-test time "
                    f"limit of {LIMIT_S} s (tests/time_limit.py)")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, LIMIT_S)
    faulthandler.dump_traceback_later(LIMIT_S + MARGIN_S, exit=True,
                                      file=item.config.stash[_dump_fd])
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _limited(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _limited(item, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _limited(item, "teardown"):
        return (yield)
