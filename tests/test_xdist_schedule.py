"""The root conftest.py's xdist scheduler: the JAX reference's heavy test
files are split into one work unit per class, units go out heaviest first,
and under `--dist loadfile` two classes of one such file run on two
workers."""

import importlib.util
import os
import re
import subprocess
import sys
import textwrap

CONFTEST = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "conftest.py")


def _hooks():
    spec = importlib.util.spec_from_file_location("root_conftest", CONFTEST)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_heavy_reference_files_split_by_class():
    hooks = _hooks()
    assert (hooks.unit_of("tests/test_layered.py::TestStructuredVJP"
                          "::test_vmappable")
            == "tests/test_layered.py::TestStructuredVJP")
    assert (hooks.unit_of("tests/test_parallel.py::test_mesh_has_8_devices")
            == "tests/test_parallel.py")
    assert (hooks.unit_of("tests/test_torch_ot.py::TestSinkhorn::test_x[2]")
            == "tests/test_torch_ot.py")


def test_units_go_out_heaviest_first_then_most_tests():
    hooks = _hooks()
    heavy = max(hooks.UNIT_COST_S, key=hooks.UNIT_COST_S.get)
    queue = {"tests/test_unlisted_many.py": dict.fromkeys("abcdef", False),
             "tests/test_unlisted_few.py": dict.fromkeys("ab", False),
             heavy: dict.fromkeys("a", False)}
    assert hooks.next_unit(queue) == heavy
    del queue[heavy]
    assert hooks.next_unit(queue) == "tests/test_unlisted_many.py"


_RUNNER = textwrap.dedent("""
    import importlib.util, sys
    import pytest
    spec = importlib.util.spec_from_file_location("root_conftest", {conftest!r})
    plugin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(plugin)
    sys.exit(pytest.main(["tests", "-v", "-p", "no:cacheprovider",
                          "-p", "no:randomly", "-p", "xdist", "-n", "2",
                          "--dist", "loadfile", "-o", "markers=slow"],
                         plugins=[plugin]))
""")


def test_classes_of_a_split_file_run_on_two_workers(tmp_path):
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_layered.py").write_text(textwrap.dedent("""
        class TestFirst:
            def test_a(self):
                pass

            def test_b(self):
                pass

        class TestSecond:
            def test_a(self):
                pass

            def test_b(self):
                pass
    """))
    code = _RUNNER.format(conftest=CONFTEST)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    out = proc.stdout
    assert proc.returncode == 0, out + proc.stderr
    workers = {}
    for worker, klass in re.findall(
            r"\[(gw\d)\].*PASSED tests/test_layered.py::(\w+)::", out):
        workers.setdefault(klass, set()).add(worker)
    assert set(workers) == {"TestFirst", "TestSecond"}, out
    assert all(len(w) == 1 for w in workers.values()), workers
    assert workers["TestFirst"] != workers["TestSecond"], workers
