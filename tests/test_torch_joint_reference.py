"""The joint location + moment-tensor inversion of the ``fukuoka11cmt``
configuration against the benchmark's plain float64 reference, at a size
the CPU runs in a second: 3 stations, 21 samples, a 15x21 grid, nk 64.

The program is the benchmark's system (``otbench.system.System``): the
port's ``loc_cmt_value_and_grad`` of one model at a time, nine parameters
preconditioned by the configuration's ``mscal``, through
``make_layered_forward``, at models drawn by the cell's own traffic
(location within 5 km, each moment component within 30% of the true
one). Its value and gradient blocks are held to the cell's limits
(``otbench/limits/fukuoka11cmt.calls.json``) by ``otbench.compare.gaps``;
the bfloat16 control that sets the upper side of those limits has to fail
at least one of them here too. Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_joint_reference.py
"""

import pytest

from otbench import calibrate, compare, harness

CELL = "fukuoka11cmt.calls"
SEEDS = [7, 2 ** 31 + 101, 3 * 2 ** 40 + 5]


def _cell(dtype: str):
    cell = harness.load_cell(CELL)
    cell.config.update(dtype=dtype, stations=3, nu=15, ntg=21, nt=21, nk=64)
    cell.traffic["check"] = {"units": 3}
    return cell


def test_the_cell_is_the_joint_preconditioned_layout():
    cell = harness.load_cell(CELL)
    assert cell.config["invert"] == "loc_cmt" and len(cell.config["mscal"]) == 9
    assert cell.traffic["kind"] == "calls" and cell.traffic["mt_spread"] == 0.3
    assert set(cell.limits) == {"value_gap", "grad_gap", "grad_gap_mt"}


@pytest.mark.parametrize("seed", SEEDS)
def test_program_in_float64_is_within_the_cells_limits(seed):
    cell = _cell("float64")
    numbers = calibrate.readings(cell, seed, cell.traffic["check"]["units"], "cpu", False)
    assert set(numbers) == set(cell.limits)
    assert compare.judge(numbers, cell.limits), compare.lines(numbers, cell.limits)


def test_bfloat16_control_fails_the_cells_limits():
    cell = _cell("float32")
    numbers = calibrate.readings(cell, SEEDS[0], cell.traffic["check"]["units"], "cpu", True)
    assert set(numbers) == set(cell.limits)
    assert not compare.judge(numbers, cell.limits), compare.lines(numbers, cell.limits)
