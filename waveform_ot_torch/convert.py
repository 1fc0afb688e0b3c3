"""Carry problem objects of the JAX package over to the port's tensors.

The JAX package's ``LocCMTProblem``, ``RickerProblem`` (with their
``Window``, ``Targets``/``Density1D``, ``StationSet`` and ``MediumConfig``),
``LayeredModel``, ``Density1D``/``Density2D`` and ``SlicedProjections``
are read by field name, array by array through numpy, so this module never
imports JAX. The compat drivers' dicts come over too: a ``prop8data``
(:func:`prop8data`) and the nested ``obs_grids`` lists (:func:`obs_grids`).
Each array becomes a tensor on ``device``; floating arrays take ``dtype``.
The device is the card unless the caller names another.
"""

from __future__ import annotations

import numpy as np
import torch

from waveform_ot_torch.inversion.loc_cmt import LocCMTProblem
from waveform_ot_torch.inversion.objective import RickerProblem
from waveform_ot_torch.inversion.pipeline import Targets
from waveform_ot_torch.models.layered import LayeredModel
from waveform_ot_torch.models.seismo import MediumConfig, StationSet
from waveform_ot_torch.ops.fingerprint import Window
from waveform_ot_torch.ops.otpdf import Density1D, Density2D
from waveform_ot_torch.ops.sliced import SlicedProjections


def tensor(a, device="cuda", dtype=torch.float64) -> torch.Tensor:
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


def targets(obj, device="cuda", dtype=torch.float64) -> Targets:
    """Observed marginals, batched over traces."""
    return Targets(t=_density(obj.t, device, dtype), u=_density(obj.u, device, dtype))


def window(obj, device="cuda", dtype=torch.float64) -> Window:
    return _fields(Window, obj, device, dtype)


def loc_cmt_problem(prob, device="cuda", dtype=torch.float64) -> LocCMTProblem:
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


def ricker_problem(prob, device="cuda", dtype=torch.float64) -> RickerProblem:
    """The port's RickerProblem from the JAX package's."""
    return RickerProblem(targets=targets(prob.targets, device, dtype),
                         window=window(prob.window, device, dtype),
                         trange=tuple(float(v) for v in prob.trange),
                         alpha=float(prob.alpha))


def layered_model(model, device="cuda", dtype=torch.float64) -> LayeredModel:
    """The port's LayeredModel from the JAX package's."""
    return _fields(LayeredModel, model, device, dtype)


def density_1d(obj, device="cuda", dtype=torch.float64) -> Density1D:
    """The port's Density1D from the JAX package's, unbatched as it is."""
    return _fields(Density1D, obj, device, dtype)


def density_2d(obj, device="cuda", dtype=torch.float64) -> Density2D:
    """The port's Density2D from the JAX package's."""
    return _fields(Density2D, obj, device, dtype)


def sliced_projections(obj, device="cuda", dtype=torch.float64) -> SlicedProjections:
    """The port's SlicedProjections from the JAX package's; the sort
    permutations become int64."""
    pr = _fields(SlicedProjections, obj, device, dtype)
    return pr._replace(psorted=pr.psorted.long())


def prop8data(d: dict, device="cuda", dtype=torch.float64) -> dict:
    """A copy of the loc/CMT driver's ``prop8data`` dict for the port: a
    LayeredModel of the JAX package under 'model' becomes the port's on
    ``device``; a layer table or None stays as it is; arrays ('recx',
    'recy', 'obs_seis') become NumPy arrays."""
    out = dict(d)
    model = d.get("model")
    if model is not None and all(hasattr(model, f) for f in LayeredModel._fields):
        out["model"] = layered_model(model, device, dtype)
    for key in ("recx", "recy", "obs_seis"):
        if key in d:
            out[key] = np.asarray(d[key])
    return out


def obs_grids(grids) -> list:
    """Nested lists of 6-tuples [t0, t1, u0, u1, Nu, Nt] (any nesting, such
    as the (nr, nc) ``obs_grids``) with Python numbers: floats for the
    limits, ints for the grid sizes."""
    if np.ndim(grids[0]) == 0:
        return [float(v) for v in grids[:4]] + [int(v) for v in grids[4:]]
    return [obs_grids(g) for g in grids]
