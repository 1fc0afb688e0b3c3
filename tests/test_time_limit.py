"""The per-test time limits of the repository's root conftest.py: a test
whose call or setup runs past its limit fails with a message naming the
limit, the session goes on to the next test, a test marked slow gets the
slow limit, and a test that cannot take the alarm still leaves its stack."""

import importlib.util
import os
import signal
import subprocess
import sys
import textwrap

CONFTEST = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "conftest.py")

# loads this suite's conftest under another name as a plugin, with the
# limits cut to seconds, and runs pytest on the given file
_RUNNER = textwrap.dedent("""
    import importlib.util, sys
    import pytest
    spec = importlib.util.spec_from_file_location("root_conftest", {conftest!r})
    plugin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(plugin)
    plugin.LIMIT_S = 1
    plugin.SLOW_LIMIT_S = 5
    plugin.STACK_DUMP_S = 1
    sys.exit(pytest.main([{target!r}, "-q", "-p", "no:cacheprovider",
                          "-p", "no:randomly", "-p", "no:xdist",
                          "-o", "markers=slow"],
                         plugins=[plugin]))
""")


def _run_cases(tmp_path, cases):
    target = tmp_path / "test_cases.py"
    target.write_text(textwrap.dedent(cases))
    code = _RUNNER.format(conftest=CONFTEST, target=str(target))
    return subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)


def test_overrunning_test_fails_and_session_goes_on(tmp_path):
    proc = _run_cases(tmp_path, """
        import time

        def test_sleeps_past_limit():
            time.sleep(60)

        def test_runs_after():
            assert True
    """)
    out = proc.stdout
    assert proc.returncode == 1, out + proc.stderr
    assert "1 failed, 1 passed" in out, out
    assert "test_sleeps_past_limit ran past its time limit of 1 s" in out, out


def test_slow_test_gets_the_slow_limit(tmp_path):
    proc = _run_cases(tmp_path, """
        import time
        import pytest

        @pytest.mark.slow
        def test_slow_within_its_limit():
            time.sleep(2)

        @pytest.mark.slow
        def test_slow_past_its_limit():
            time.sleep(60)
    """)
    out = proc.stdout
    assert "1 failed, 1 passed" in out, out + proc.stderr
    assert "test_slow_past_its_limit ran past its time limit of 5 s" in out, out


def test_overrunning_setup_fails_and_session_goes_on(tmp_path):
    proc = _run_cases(tmp_path, """
        import time
        import pytest

        @pytest.fixture
        def sleeps():
            time.sleep(60)

        def test_setup_sleeps_past_limit(sleeps):
            pass

        def test_runs_after():
            assert True
    """)
    out = proc.stdout
    assert proc.returncode == 1, out + proc.stderr
    assert "1 passed, 1 error" in out, out
    assert ("test_setup_sleeps_past_limit ran past its time limit of 1 s "
            "in setup") in out, out


def test_stuck_test_dumps_its_stack(tmp_path):
    """SIGALRM blocked stands in for a wait in C code, which the Python
    alarm cannot interrupt: the stack still reaches stderr."""
    proc = _run_cases(tmp_path, """
        import signal, time

        def test_blocks_the_alarm():
            signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
            try:
                time.sleep(4)
            finally:
                signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGALRM})
    """)
    assert "Timeout (0:00:02)!" in proc.stderr, proc.stderr
    assert "in test_blocks_the_alarm" in proc.stderr, proc.stderr
    # the alarm, pending while blocked, fails the test once it unblocks
    assert "1 failed" in proc.stdout, proc.stdout


def test_limit_is_armed_while_a_test_runs():
    spec = importlib.util.spec_from_file_location("root_conftest", CONFTEST)
    limits = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(limits)
    remaining, _ = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < remaining <= limits.LIMIT_S
