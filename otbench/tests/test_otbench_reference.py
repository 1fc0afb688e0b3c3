"""The frozen reference against the port at tiny sizes on the CPU, the
control that has to fail, and runs of the harness with the timed path
broken underneath, each of which has to come out not correct."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from conftest import tiny_cell

from otbench import calibrate, harness
from otbench.reference import Reference
from otbench.reference import farfield as ref_far
from otbench.reference import layered as ref_lay
from otbench.reference import misfit as ref_mis
from otbench.system import System
from waveform_ot_torch.models import (
    MediumConfig, StationSet, layered_model_from_table, make_layered_forward,
    synthetic_seismograms,
)
from waveform_ot_torch.ops.fingerprint import distance_field_torch
from waveform_ot_torch.ops.wasser import wasserstein_1d

F64 = torch.float64
SEED = 2 ** 31 + 77


def _stations(n=4):
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return (torch.tensor(60 * np.cos(ang), dtype=F64), torch.tensor(60 * np.sin(ang), dtype=F64))


def _sources():
    return [torch.tensor(v, dtype=F64, requires_grad=True)
            for v in ([1.0, 3.0], [-2.0, 0.5], [9.0, 14.0])]


def _seis_and_grads(u):
    """The seismograms and the gradients of a fixed functional of them in
    the sources' x, y, z."""
    u, (x, y, z) = u
    w = torch.linspace(-1.0, 1.0, u.numel(), dtype=F64).reshape(u.shape)
    return u.detach(), torch.autograd.grad((w * u).sum(), (x, y, z))


def test_frozen_farfield_is_the_port():
    """The frozen far-field forward and its gradient against the port's, to
    rounding: a port that reorders its float64 arithmetic still passes."""
    sx, sy = _stations()
    m = ref_far.moment_tensor_from_sdr(30.0, 60.0, 45.0, m0=5e6, device="cpu")
    med = [torch.tensor(v, dtype=F64) for v in (6.0, 3.46, 2.7)]
    s = _sources()
    a, ga = _seis_and_grads((ref_far.synthetic_seismograms(
        *s, m, ref_far.StationSet(sx, sy), medium=ref_far.MediumConfig(*med))[1], s))
    s = _sources()
    b, gb = _seis_and_grads((synthetic_seismograms(*s, m, StationSet(sx, sy),
                                                   medium=MediumConfig(*med))[1], s))
    torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))
    for p, q in zip(ga, gb):
        torch.testing.assert_close(p, q, rtol=1e-10, atol=1e-10 * float(q.abs().max()))


def test_frozen_layered_is_the_port():
    """The frozen f-k forward, by plain autograd through the stack algebra,
    against the port's forward with its closed-form depth tangent: the
    values to rounding, the gradients to the rounding of two routes."""
    sx, sy = _stations(3)
    rows = harness.load_json(harness.HERE / "configs" / "fukuoka11.json")["layers"]
    m = ref_far.moment_tensor_from_sdr(30.0, 60.0, 45.0, m0=5e6, device="cpu")
    kw = dict(nt=21, dt=1.0, nk=48, kmax=2.5)
    s = _sources()
    a, ga = _seis_and_grads((ref_lay.make_layered_forward(
        ref_far.StationSet(sx, sy), model=ref_lay.layered_model_from_table(rows, device="cpu"),
        **kw)(*s, m), s))
    s = _sources()
    b, gb = _seis_and_grads((make_layered_forward(
        StationSet(sx, sy), model=layered_model_from_table(rows, device="cpu"), **kw)(*s, m), s))
    torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))
    for p, q in zip(ga, gb):
        torch.testing.assert_close(p, q, rtol=1e-9, atol=1e-9 * float(q.abs().max()))


def test_plain_distance_and_w2_are_the_ports():
    g = torch.Generator().manual_seed(3)
    verts = torch.stack([torch.linspace(0, 1, 21, dtype=F64).expand(5, 21),
                         torch.rand(5, 21, generator=g, dtype=F64)], -1)
    tg, ug = ref_mis.unit_grid(17, F64, "cpu"), ref_mis.unit_grid(13, F64, "cpu")
    d = ref_mis.nearest_distance(verts, tg, ug)
    d_port = distance_field_torch(verts, tg.expand(5, 17), ug.expand(5, 13)).d
    torch.testing.assert_close(d, d_port, rtol=1e-13, atol=1e-15)
    f = torch.rand(5, 17, generator=g, dtype=F64, requires_grad=True)
    h = torch.rand(5, 17, generator=g, dtype=F64) + 0.1
    w = ref_mis.w2(f, tg, h, tg)
    (gw,) = torch.autograd.grad(w.sum(), f)
    w_port = wasserstein_1d(f, tg.expand(5, 17), h, tg.expand(5, 17), 2)
    (gp,) = torch.autograd.grad(w_port.sum(), f)
    torch.testing.assert_close(w, w_port.detach(), rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(gw, gp, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["farfield.scan", "layered.calls"])
def test_reference_is_the_port_in_float64(name):
    """The whole chain, value and gradient, port vs reference, both float64."""
    cell = tiny_cell(name)
    cell.config["dtype"] = "float64"
    inputs = harness.make_inputs(cell.config, SEED, "cpu")
    system = System(cell.config, cell.traffic, inputs, "cpu")
    ms = torch.tensor([[2.5, -1.0, 11.0], [-1.0, 2.0, 13.5], [4.0, -4.0, 9.0]], dtype=F64)
    system.traffic = {"kind": "calls"}
    got = [system.run({"m": m.numpy()}) for m in ms]
    v = torch.cat([o["value"] for o in got])
    g = torch.cat([o["grad"] for o in got])
    v_ref, g_ref = Reference(cell.config, inputs).value_and_grad(ms)
    torch.testing.assert_close(v, v_ref, rtol=1e-9, atol=0)
    torch.testing.assert_close(g, g_ref, rtol=1e-7, atol=1e-9 * float(g_ref.abs().max()))


@pytest.mark.parametrize("name", ["farfield.scan", "layered.scan", "farfield.study",
                                  "layered.calls"])
def test_program_passes_and_control_fails(name):
    """At test size: the float32 program within the cell's limits, the
    bfloat16 control outside at least one."""
    cell = tiny_cell(name)
    for seed in (SEED, SEED + 1):
        prog = calibrate.readings(cell, seed, cell.traffic["check"]["units"], "cpu", False)
        assert harness.compare.judge(prog, cell.limits), prog
        ctl = calibrate.readings(cell, seed, cell.traffic["check"]["units"], "cpu", True)
        assert not harness.compare.judge(ctl, cell.limits), ctl


class _HalfTraces(System):
    """Half of the batch of traces left out (every other station), the sum
    taken as the rest's mean times the whole count."""

    def __init__(self, config, traffic, inputs, device):
        keep = slice(0, None, 2)
        half = inputs._replace(sx=inputs.sx[keep], sy=inputs.sy[keep], noise=inputs.noise[keep])
        super().__init__(config, traffic, half, device)
        self.scale = inputs.sx.shape[0] / half.sx.shape[0]

    def run(self, unit):
        out = super().run(unit)
        return {k: (v * self.scale if k in ("value", "grad") else v) for k, v in out.items()}


class _AlteredAnswer(System):
    """Every answer's x gradient negated where it is produced."""

    def run(self, unit):
        out = super().run(unit)
        if "grad" in out:
            out["grad"] = out["grad"] * torch.tensor([-1.0, 1.0, 1.0], dtype=out["grad"].dtype)
        else:
            out["x"] = out["x"] + 1.0
        return out


class _HalfLanesFrozen(System):
    """Half of a study's lanes left where they began and flagged not
    converged (as a lane mask set wrong would): their misfits are the true
    ones at the starts, and the converged lanes are sound."""

    def run(self, unit):
        out = super().run(unit)
        half = torch.arange(out["x"].shape[0]) % 2 == 1
        starts = self.tensor(unit["starts"])
        with torch.no_grad():
            out["x"] = torch.where(half[:, None], starts, out["x"])
            out["value"] = torch.where(half, self.objective(starts), out["value"])
        out["converged"] = torch.where(half, 0.0, out["converged"])
        return out


class _Unchanged(System):
    """The solver's step returns its state unchanged: the end points are the
    starts, with their misfits."""

    def run(self, unit):
        out = super().run(unit)
        starts = self.tensor(unit["starts"])
        with torch.no_grad():
            out["x"], out["value"] = starts, self.objective(starts)
        return out


FAULTS = [("farfield.scan", _HalfTraces), ("layered.calls", _HalfTraces),
          ("farfield.scan", _AlteredAnswer), ("layered.calls", _AlteredAnswer),
          ("farfield.study", _AlteredAnswer), ("farfield.study", _Unchanged),
          ("farfield.study", _HalfLanesFrozen)]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_broken_timed_path_is_not_correct(name, fault):
    sound, _ = harness.run(name, SEED, 0.3, False, device="cpu", cell=tiny_cell(name),
                           log=lambda s: None)
    assert sound["correct"], sound["checks"]
    broken, lines = harness.run(name, SEED, 0.3, False, device="cpu", cell=tiny_cell(name),
                                system_factory=fault, log=lambda s: None)
    assert broken["correct"] is False, broken["checks"]
    assert list(broken)[-1] == "checks" and len(lines) == len(tiny_cell(name).limits)


def test_trace_run_reports_per_layer_metrics_only():
    res, _ = harness.run("layered.calls", SEED, 5.0, True, device="cpu",
                         cell=tiny_cell("layered.calls"), log=lambda s: None)
    assert res["correct"] and set(res["metrics"]) <= {"device_idle.calls",
                                                      "launches_per_call.calls"}
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert dataclasses.is_dataclass(harness.Run)
