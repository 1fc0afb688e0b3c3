"""Shared pieces of the benchmark's CPU tests: the repository root on the
path, cells cut to a size the CPU runs in a second, and the card fixture."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from otbench import harness  # noqa: E402


def tiny_cell(name: str):
    """The cell ``name`` with its configuration and traffic cut to CPU size:
    3 stations, 21 samples, a 15x21 grid, nk 64; a 3x3x2 scan, a 4-start
    study of 3 km spread to tol 1e-4 (float32 at this size stalls near
    3e-5), every compared point of two units. The limits are
    the cell's own."""
    cell = harness.load_cell(name)
    cell.config.update(stations=3, nu=15, ntg=21, nt=21)
    if cell.config["physics"] == "layered":
        cell.config["nk"] = 64
    t = cell.traffic
    t["trace_seconds"] = 0.5
    if t["kind"] == "scan":
        t.update(x_km=[-4.0, 4.0, 3], y_km=[-4.0, 4.0, 3], z_km=[8.0, 14.0, 2],
                 check={"units": 2, "points_per_unit": 18})
    elif t["kind"] == "study":
        t.update(starts=4, start_spread_km=3.0, tol=1e-4, max_iter=60,
                 check={"units": 1, "points_per_unit": 4})
    else:
        t["check"] = {"units": 4}
    return cell


@pytest.fixture
def card():
    """Skips the test unless torch sees a CUDA card (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
