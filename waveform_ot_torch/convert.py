"""Carry problem objects of the JAX package over to the port's tensors.

The JAX package's ``LocCMTProblem`` and ``RickerProblem`` (with their
``Window``, ``Targets``/``Density1D``, ``StationSet`` and ``MediumConfig``)
are read by field name, array by array through numpy, so this module never
imports JAX. Each array becomes a tensor on ``device``; floating arrays
take ``dtype``.
"""

from __future__ import annotations

import numpy as np
import torch

from waveform_ot_torch.inversion.loc_cmt import LocCMTProblem
from waveform_ot_torch.inversion.objective import RickerProblem
from waveform_ot_torch.inversion.pipeline import Targets
from waveform_ot_torch.models.seismo import MediumConfig, StationSet
from waveform_ot_torch.ops.fingerprint import Window
from waveform_ot_torch.ops.otpdf import Density1D


def tensor(a, device=None, dtype=torch.float64) -> torch.Tensor:
    """One array as a tensor; floating arrays are cast to ``dtype``."""
    t = torch.tensor(np.asarray(a))
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _fields(cls, obj, device, dtype):
    """``cls`` built from the same-named fields of ``obj``."""
    return cls(*(tensor(getattr(obj, name), device, dtype) for name in cls._fields))


def _density(obj, device, dtype) -> Density1D:
    """A batch of densities; an unbatched (n,) one becomes a batch of 1."""
    d = _fields(Density1D, obj, device, dtype)
    return Density1D(*(x[None] for x in d)) if d.pdf.dim() == 1 else d


def targets(obj, device=None, dtype=torch.float64) -> Targets:
    """Observed marginals, batched over traces."""
    return Targets(t=_density(obj.t, device, dtype), u=_density(obj.u, device, dtype))


def window(obj, device=None, dtype=torch.float64) -> Window:
    return _fields(Window, obj, device, dtype)


def loc_cmt_problem(prob, device=None, dtype=torch.float64) -> LocCMTProblem:
    """The port's LocCMTProblem from the JAX package's."""
    arr = lambda name: tensor(getattr(prob, name), device, dtype)
    return LocCMTProblem(
        t=arr("t"), seis_obs=arr("seis_obs"),
        windows=window(prob.windows, device, dtype),
        targets=targets(prob.targets, device, dtype),
        stations=_fields(StationSet, prob.stations, device, dtype),
        medium=_fields(MediumConfig, prob.medium, device, dtype),
        mref=arr("mref"), mscal=arr("mscal"), mxyz_fixed=arr("mxyz_fixed"),
        fc=arr("fc"))


def ricker_problem(prob, device=None, dtype=torch.float64) -> RickerProblem:
    """The port's RickerProblem from the JAX package's."""
    return RickerProblem(targets=targets(prob.targets, device, dtype),
                         window=window(prob.window, device, dtype),
                         trange=tuple(float(v) for v in prob.trange),
                         alpha=float(prob.alpha))
