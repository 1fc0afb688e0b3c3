"""The system under test: the port's public API, driven by one unit of traffic.

:class:`System` builds one configuration's problem on the device from the
harness's inputs, in the configuration's dtype, exactly as a user of the
port would: the observed data are the port's forward at the true source
plus the seed's noise. :meth:`System.run` takes one unit's inputs (host
arrays from :mod:`otbench.generator`) and returns its outputs as tensors
on the device, without waiting for them. This is the only module of the
benchmark that imports the port.

The configuration's ``invert`` picks the parameters (:data:`otbench.generator.LAYOUTS`):
"loc_cmt" inverts the moment tensor with the location (``InvOptions(cmt=True)``).
Its ``mscal``, where given, preconditions the parameters (``precon``).
"""

from __future__ import annotations

import numpy as np
import torch

from otbench import generator
from waveform_ot_torch.inversion import (
    InvOptions, TraceConfig, build_loc_cmt_problem, layered_misfit_grid, loc_cmt_misfit,
    loc_cmt_value_and_grad, minimize_lbfgs_batched_host, minimize_multi_start,
)
from waveform_ot_torch.models import (
    MediumConfig, StationSet, layered_model_from_table, make_layered_forward,
    make_layered_stages, synthetic_seismograms,
)

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Counted:
    """A batched objective that counts its calls (batched evaluations)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, ms):
        self.calls += 1
        return self.fn(ms)


class System:
    """One configuration's problem on ``device``, and its units of work."""

    def __init__(self, config: dict, traffic: dict, inputs, device):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        dtype = self.dtype = DTYPES[config["dtype"]]
        arr = lambda v: torch.as_tensor(v, dtype=torch.float64, device=self.device).to(dtype)
        nt, dt = config["nt"], config["dt"]
        stations = StationSet(x=arr(inputs.sx), y=arr(inputs.sy))
        mxyz, loc = arr(inputs.mxyz), arr(inputs.loc)
        self.nm = generator.n_params(config)
        mscal = config.get("mscal")
        self.opts = InvOptions(loc=True, cmt=self.nm == 9, mistype="OT", zmin=config["zmin_km"],
                               precon=mscal is not None)
        self.forward = self.stages = None
        far = {}
        if config["physics"] == "farfield":
            far = dict(fc=config["fc"], medium=MediumConfig(
                *(arr(config["medium"][k]) for k in ("vp", "vs", "rho"))))
            _, s = synthetic_seismograms(loc[0], loc[1], loc[2], mxyz, stations, nt=nt, dt=dt,
                                         **far)
        else:
            model = layered_model_from_table(config["layers"], device=self.device)
            kw = dict(model=model, nt=nt, dt=dt, nk=config["nk"], kmax=config["kmax"])
            self.forward = make_layered_forward(stations, **kw)
            if traffic["kind"] == "scan":
                self.stages = make_layered_stages(**kw)
            with torch.no_grad():
                s = self.forward(loc[0], loc[1], loc[2], mxyz)
        obs = s + config["noise"] * s.abs().max() * arr(inputs.noise)
        self.cfg = TraceConfig(nu=config["nu"], ntg=config["ntg"], lambdav=config["lambda"],
                               q=None, p=2)
        t = dt * torch.arange(nt, dtype=dtype, device=self.device)
        self.prob = build_loc_cmt_problem(t, obs, stations, self.cfg, mxyz_fixed=mxyz,
                                          mscal=None if mscal is None else arr(mscal),
                                          pad=config["window_pad"], **far)
        self.objective = Counted(
            lambda ms: loc_cmt_misfit(ms, self.prob, self.opts, self.cfg, forward=self.forward))

    def tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device).to(self.dtype)

    def run(self, unit: dict) -> dict:
        """Outputs of one unit, on the device, not waited for."""
        kind = self.traffic["kind"]
        if kind == "scan":
            if self.stages is not None:
                xy = np.stack(np.meshgrid(unit["x"], unit["y"], indexing="ij"), -1).reshape(-1, 2)
                v, g = layered_misfit_grid(self.tensor(unit["z"]), self.tensor(xy), self.prob,
                                           self.opts, self.cfg, self.stages)
                return {"value": v.reshape(-1), "grad": g.reshape(-1, self.nm)}
            v, g = loc_cmt_value_and_grad(self.tensor(unit["nodes"]), self.prob, self.opts, self.cfg)
            return {"value": v, "grad": g}
        if kind == "calls":
            v, g = loc_cmt_value_and_grad(self.tensor(unit["m"]), self.prob, self.opts, self.cfg,
                                          forward=self.forward)
            return {"value": v.reshape(1), "grad": g.reshape(1, self.nm)}
        if kind == "study":
            return solve(self.traffic, self.objective, self.tensor(unit["starts"]))
        raise ValueError(f"unknown traffic kind {kind!r}")


def solve(traffic: dict, objective, starts: torch.Tensor) -> dict:
    """One multi-start study of ``objective`` from ``starts`` (k, nm) by the
    mix's solver, the on-device batched L-BFGS or the host one: end points,
    their misfits, and 1 where the solver reports the lane converged
    (gradient norm under tol, no failed line search), else 0."""
    if generator.solver(traffic) == "host":
        res = minimize_lbfgs_batched_host(objective, starts, max_iter=traffic["max_iter"],
                                          tol=traffic["tol"], ls_max=traffic["ls_max"])
    else:
        res = minimize_multi_start(objective, starts, max_iter=traffic["max_iter"],
                                   tol=traffic["tol"])
    x, fun, gn, failed = (torch.as_tensor(v, device=starts.device)
                          for v in (res.x, res.fun, res.grad_norm, res.ls_failed))
    converged = (~failed.bool()) & (gn < traffic["tol"])
    return {"x": x, "value": fun, "converged": converged.to(x.dtype)}
