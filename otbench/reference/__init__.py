"""The benchmark's plain reference: what decides a run's ``correct``.

``farfield`` and ``layered`` are frozen copies of the port's forward physics
(each names its file and commit); ``misfit`` is the W2 misfit chain written
plainly. :class:`Reference` puts them together for one configuration and
one seed's inputs, in the dtype asked for: float64 for the reference,
bfloat16 for the control. Nothing here imports the port or JAX.
"""

from __future__ import annotations

import torch

from otbench.reference import misfit as _misfit
from otbench.reference.farfield import (
    MediumConfig, StationSet, moment_tensor_from_sdr, synthetic_seismograms,
)
from otbench.reference.layered import layered_model_from_table, make_layered_forward

__all__ = ["Reference", "moment_tensor_from_sdr"]


def forward_for(config: dict, stations: StationSet, mxyz: torch.Tensor):
    """``forward(x, y, z) -> (k, nr, 3, nt)`` of the configuration's physics,
    in the stations' dtype, differentiable by plain autograd (the f-k stack
    algebra included)."""
    nt, dt = config["nt"], config["dt"]
    if config["physics"] == "farfield":
        like = stations.x
        medium = MediumConfig(*(torch.tensor(config["medium"][k], dtype=like.dtype,
                                             device=like.device) for k in ("vp", "vs", "rho")))
        return lambda x, y, z: synthetic_seismograms(x, y, z, mxyz, stations, nt=nt, dt=dt,
                                                     medium=medium, fc=config["fc"])[1]
    model = layered_model_from_table(config["layers"], device=stations.x.device)
    fwd = make_layered_forward(stations, model=model, nt=nt, dt=dt, nk=config["nk"],
                               kmax=config["kmax"])
    return lambda x, y, z: fwd(x, y, z, mxyz)


class Reference:
    """The misfit and its gradient for one seed's inputs in ``dtype``.

    The physics runs in float64 for the reference. For the control
    (``dtype`` bfloat16) the far-field physics runs in bfloat16 too; the f-k
    physics, whose complex stack algebra and FFT torch does not run in
    bfloat16, runs in float32 and its seismograms are rounded to bfloat16.
    The observed data are worked out again here from the harness's inputs.
    Plain autograd through the f-k stack algebra holds some 0.7 GB per
    source at nk 1024, so the layered physics runs in blocks of 8 models.
    """

    def __init__(self, config: dict, inputs, dtype=torch.float64):
        self.config, self.dtype = config, dtype
        self.block = 32 if config["physics"] == "farfield" else 8
        pdt = dtype if config["physics"] == "farfield" else (
            torch.float64 if dtype == torch.float64 else torch.float32)
        self.pdt = pdt
        stations = StationSet(inputs.sx.to(pdt), inputs.sy.to(pdt))
        fwd = forward_for(config, stations, inputs.mxyz.to(pdt))
        zmin = config["zmin_km"]
        # the depth floor: the value at max(z, zmin), the gradient passed straight through
        floor = lambda z: z - (z - torch.clamp_min(z, zmin)).detach()
        self.forward = lambda x, y, z: fwd(x.to(pdt), y.to(pdt), floor(z.to(pdt))).to(dtype)
        loc = inputs.loc.to(pdt)
        with torch.no_grad():
            s = self.forward(loc[:1], loc[1:2], loc[2:3])[0].to(dtype)
        obs = s + config["noise"] * s.abs().max() * inputs.noise.to(dtype)
        self.obs = _misfit.observe(obs, config, dtype)

    def value_and_grad(self, ms: torch.Tensor):
        """(misfits (k,), gradients (k, 3)) at locations ms (k, 3), in blocks."""
        return _misfit.value_and_grad(self.forward, self.obs, self.config,
                                      ms.to(self.pdt), self.block)

    def misfit(self, ms: torch.Tensor):
        """Misfits (k,) of ms (k, 3), differentiable, one batch."""
        ms = ms.to(self.pdt)
        return _misfit.misfit(self.forward(ms[:, 0], ms[:, 1], ms[:, 2]), self.obs, self.config)
