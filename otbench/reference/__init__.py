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

__all__ = ["Reference", "moment_tensor_from_sdr", "mxyz_from_upper"]

# the symmetric tensor's entries, row by row, as indices into the six upper
# components (Mxx, Mxy, Mxz, Myy, Myz, Mzz)
_UPPER_OF = (0, 1, 2, 1, 3, 4, 2, 4, 5)


def mxyz_from_upper(upper: torch.Tensor) -> torch.Tensor:
    """Symmetric moment tensors (..., 3, 3) from their six upper components
    (..., 6) in row-major order (Mxx, Mxy, Mxz, Myy, Myz, Mzz)."""
    return upper[..., list(_UPPER_OF)].reshape(*upper.shape[:-1], 3, 3)


def forward_for(config: dict, stations: StationSet):
    """``forward(x, y, z, mxyz) -> (k, nr, 3, nt)`` of the configuration's
    physics for sources (k,) and a moment tensor (3, 3) or one per source
    (k, 3, 3), in the stations' dtype, differentiable by plain autograd (the
    f-k stack algebra included)."""
    nt, dt = config["nt"], config["dt"]
    if config["physics"] == "farfield":
        like = stations.x
        medium = MediumConfig(*(torch.tensor(config["medium"][k], dtype=like.dtype,
                                             device=like.device) for k in ("vp", "vs", "rho")))
        return lambda x, y, z, mxyz: synthetic_seismograms(
            x, y, z, mxyz, stations, nt=nt, dt=dt, medium=medium, fc=config["fc"])[1]
    model = layered_model_from_table(config["layers"], device=stations.x.device)
    return make_layered_forward(stations, model=model, nt=nt, dt=dt, nk=config["nk"],
                                kmax=config["kmax"])


class Reference:
    """The misfit and its gradient for one seed's inputs in ``dtype``, over
    models (k, nm) of the configuration's ``invert``: the location (x, y, z),
    then for "loc_cmt" the six upper components of the moment tensor (the
    inputs' true one where the models hold none). Where the configuration
    gives ``mscal``, a model is multiplied by it before anything else.

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
        self.physics = forward_for(config, stations)
        self.mxyz = inputs.mxyz.to(pdt)
        mscal = config.get("mscal")
        self.mscal = None if mscal is None else torch.tensor(mscal, dtype=pdt,
                                                             device=inputs.loc.device)
        loc = inputs.loc.to(pdt)
        with torch.no_grad():
            s = self.physics(loc[:1], loc[1:2], self.floor(loc[2:3]), self.mxyz)[0].to(dtype)
        obs = s + config["noise"] * s.abs().max() * inputs.noise.to(dtype)
        self.obs = _misfit.observe(obs, config, dtype)

    def floor(self, z):
        """The depth floor: the value at max(z, zmin), the gradient passed
        straight through."""
        return z - (z - torch.clamp_min(z, self.config["zmin_km"])).detach()

    def forward(self, ms: torch.Tensor):
        """Seismograms (k, nr, 3, nt) in ``dtype`` of models ms (k, nm)."""
        ms = ms.to(self.pdt)
        if self.mscal is not None:
            ms = ms * self.mscal
        mxyz = self.mxyz if ms.shape[-1] == 3 else mxyz_from_upper(ms[:, 3:])
        return self.physics(ms[:, 0], ms[:, 1], self.floor(ms[:, 2]), mxyz).to(self.dtype)

    def value_and_grad(self, ms: torch.Tensor):
        """(misfits (k,), gradients (k, nm)) at models ms (k, nm), in blocks."""
        return _misfit.value_and_grad(self.forward, self.obs, self.config,
                                      ms.to(self.pdt), self.block)

    def misfit(self, ms: torch.Tensor):
        """Misfits (k,) of models ms (k, nm), differentiable, one batch."""
        return _misfit.misfit(self.forward(ms), self.obs, self.config)
