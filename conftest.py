"""Suite-wide pytest hooks: a time limit on each test's setup and call, the
JAX reference's tests that take minutes at any size kept off the tier-1 run
(`-m 'not slow'`), and an xdist scheduler that spreads the reference's heavy
test classes over the workers under `--dist loadfile`.

The full-size tests run with `python -m pytest tests/ -m slow -p xdist -n 4
--dist load`.
"""

import faulthandler
import os
import signal

import pytest

# Time limits in seconds on a test's setup and on its call, each about twice
# the slowest phase on a cold compile cache: LIMIT_S for tier-1, SLOW_LIMIT_S
# for the tests marked slow. Past its limit the running test fails and the
# session goes on. A test stuck in C code cannot take the alarm: STACK_DUMP_S
# later every thread's stack goes to the terminal's stderr all the same.
LIMIT_S = 600
SLOW_LIMIT_S = 1500
STACK_DUMP_S = 30

# The JAX reference's tests that take 230-780 s each on a cold compile cache,
# at their size and at smaller ones alike (the cost is compile and eager
# dispatch, not arithmetic): marked slow, so tier-1 leaves them out. In it
# they would add ~2,000 test-seconds and make their three classes units of
# 850-1,300 s, each one worker's serial load.
SLOW_TESTS = frozenset({
    "tests/test_layered.py::TestMixedPrecisionStack"
    "::test_mixed_gradient_finite_and_consistent",
    "tests/test_loc_cmt.py::TestLayeredFukuokaEndToEnd"
    "::test_source_location_recovery",
    "tests/test_parallel.py::TestLayeredSharded"
    "::test_station_sharded_value_and_grad",
    "tests/test_parallel.py::TestLayeredSharded"
    "::test_station_gradient_flows_to_stations",
})

# The JAX reference's test files whose classes are work units of their own;
# every other file is one unit, as under `--dist loadfile`.
SPLIT_BY_CLASS = frozenset({
    "tests/test_layered.py", "tests/test_loc_cmt.py",
    "tests/test_parallel.py", "tests/test_properties.py",
})

# Seconds each work unit of 45 s or more took in a cold tier-1 run (junit
# sums; 6 workers, 8 cores). The scheduler hands out the heaviest unit first;
# units not listed follow, most tests first, as `--dist loadfile` orders them.
UNIT_COST_S = {
    "tests/test_loc_cmt.py::TestLayeredFukuokaEndToEnd": 567,
    "tests/test_layered.py::TestMixedPrecisionStack": 460,
    "tests/test_properties.py::TestWasserInvariants": 440,
    "tests/test_layered.py::TestStructuredVJP": 302,
    "tests/test_torch_examples.py": 280,
    "tests/test_compat_l3.py": 232,
    "tests/test_torch_entry.py": 220,
    "tests/test_parallel.py": 180,
    "tests/test_torch_drivers.py": 175,
    "tests/test_properties.py::TestMarginalSlicedInvariants": 171,
    "tests/test_compat.py": 163,
    "tests/test_torch_layered.py": 135,
    "tests/test_torch_parallel.py": 132,
    "tests/test_ot_extras.py": 123,
    "tests/test_layered.py::TestCompiledCpuDDWarning": 115,
    "tests/test_torch_bench.py": 114,
    "tests/test_layered.py::TestLayeredInvariants": 107,
    "tests/test_torch_drivers_damping.py": 97,
    "tests/test_loc_cmt.py::TestObjective": 93,
    "tests/test_loc_cmt.py::TestJointLocCMT": 90,
    "tests/test_parallel.py::TestLayeredSharded": 85,
    "tests/test_fingerprint.py": 82,
    "tests/test_torch_inversion.py": 78,
    "tests/test_torch_ot.py": 75,
    "tests/test_properties.py::TestNativeEMDFuzz": 72,
    "tests/test_properties.py::TestDistanceFieldInvariants": 72,
    "tests/test_wasser.py": 63,
    "tests/test_layered.py::TestWholespaceParity": 62,
    "tests/test_pipeline.py": 57,
    "tests/test_torch_fingerprint.py": 54,
    "tests/test_torch_compat.py": 52,
    "tests/test_layered.py::TestLayeredGradients": 52,
    "tests/test_torch_loc_cmt.py": 49,
}

_STDERR_FD = pytest.StashKey[int]()


def unit_of(nodeid):
    """The work unit of a test: its class in SPLIT_BY_CLASS's files, else
    its file."""
    path = nodeid.split("::", 1)[0]
    if path in SPLIT_BY_CLASS:
        return nodeid.rsplit("::", 1)[0]
    return path


def next_unit(workqueue):
    """The unit to hand out next: the heaviest listed, then most tests."""
    return max(workqueue,
               key=lambda u: (UNIT_COST_S.get(u, 0), len(workqueue[u])))


@pytest.hookimpl(tryfirst=True, optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class CostScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return unit_of(nodeid)

        def _assign_work_unit(self, node):
            self.workqueue.move_to_end(next_unit(self.workqueue), last=False)
            super()._assign_work_unit(node)

    return CostScheduling(config, log)


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


def pytest_configure(config):
    # output capture is suspended while plugins configure: fd 2 is the
    # terminal's stderr here, not a test's captured one
    config.stash[_STDERR_FD] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR_FD])


def _time_limited(item, phase):
    limit = SLOW_LIMIT_S if item.get_closest_marker("slow") else LIMIT_S

    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} ran past its time limit of {limit} s "
                    f"in {phase}", pytrace=False)

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit + STACK_DUMP_S,
                                      file=item.config.stash[_STDERR_FD])
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    yield from _time_limited(item, "setup")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    yield from _time_limited(item, "call")
