"""Host bridge for CPU-only forward physics (pyprop8); counterpart of
waveform_ot_tpu.models.pyprop8_bridge.

The reference computes seismograms with pyprop8 on the host
(loc_cmt_util.prop8seis, loc_cmt_util.py:28-58) and chains its analytic
Jacobians through drv_rpd2xyz (loc_cmt_util.py:360-383). Here a host
function that returns (value, Jacobian) becomes a ``torch.autograd.Function``
(:func:`host_forward_with_jacobian`): one host call per forward, its
Jacobian kept for the backward, so autograd of a whole objective on the
card crosses the host boundary. :func:`prop8seis` wires it to pyprop8 where
that optional package is installed.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from waveform_ot_torch.models.seismo import mxyz_from_upper

try:  # optional dependency, like the reference's guarded POT/skfmm imports
    import pyprop8 as _pp
    from pyprop8.utils import clp_filter as _clp_filter
    from pyprop8.utils import make_moment_tensor as _make_mt
    from pyprop8.utils import rtf2xyz as _rtf2xyz

    HAVE_PYPROP8 = True
except ImportError:  # pragma: no cover - environment without pyprop8
    _pp = None
    HAVE_PYPROP8 = False


class _HostForward(torch.autograd.Function):
    """value = host_fn(m)[0] on m's device; the backward contracts the
    cotangent with the host Jacobian host_fn(m)[1] of the same call."""

    @staticmethod
    def forward(ctx, m, host_fn, out_shape, out_dtype, jac_shape):
        val, jac = host_fn(m.detach().cpu().numpy())
        val, jac = np.asarray(val), np.asarray(jac, dtype=np.float64)
        if val.shape != tuple(out_shape) or jac.shape != tuple(jac_shape):
            raise ValueError(f"host function gave value {val.shape} and Jacobian "
                             f"{jac.shape}, not {tuple(out_shape)} and {tuple(jac_shape)}")
        ctx.save_for_backward(torch.as_tensor(jac, device=m.device))
        return torch.as_tensor(val, dtype=out_dtype, device=m.device)

    @staticmethod
    def backward(ctx, ct):
        (jac,) = ctx.saved_tensors
        nm = jac.shape[0]
        # float64 and an explicit sum: out of reach of the TF32 switch
        g = (jac.reshape(nm, -1) * ct.reshape(1, -1).double()).sum(dim=1)
        return g, None, None, None, None


def host_forward_with_jacobian(host_fn: Callable, m: torch.Tensor, out_shape,
                               out_dtype, jac_shape):
    """Differentiable wrapper of a host function with an analytic Jacobian.

    Args:
      host_fn: numpy function m -> (value, jac), value.shape == out_shape,
               jac.shape == jac_shape == (len(m),) + out_shape.
      m: (nm,) parameters, a tensor on any device.
      out_shape / out_dtype / jac_shape: the result's specification.

    Returns the value as a tensor of ``out_dtype`` on m's device. Autograd
    through it contracts the cotangent with the Jacobian of the same host
    call (one host call per evaluation, like the reference's single pyprop8
    call per objective, loc_cmt_util.py:226), in float64.
    """
    return _HostForward.apply(m, host_fn, tuple(out_shape), out_dtype, tuple(jac_shape))


# ---------------------------------------------------------------------------
# pyprop8 wiring (active only when the package is installed)
# ---------------------------------------------------------------------------

_DIAGORDER = [0, 3, 4, 1, 5, 2]  # pyprop8 'diag-first' -> upper-triangular
                                 # (loc_cmt_util.py:311,362)


def _drv_to_cartesian(drv, deriv, stations, geometry="cartesian"):
    """Reorder/rotate pyprop8 derivative seismograms (nr, nderiv, nc, nt) to
    (x, y, z[, 6 upper-triangular M]) rows, NumPy in and out: the reference
    drv_rpd2xyz (loc_cmt_util.py:360-383), with the z sign flip and the
    spherical -> cartesian receiver-angle chain."""
    if geometry == "spherical":
        dr = deriv[:, drv.i_r, :, :]
        dp = deriv[:, drv.i_phi, :, :]
        dd = deriv[:, drv.i_z, :, :]
        dx = ((dr.T) * (-np.cos(stations.pp))
              + (dp.T) * (np.sin(stations.pp) / stations.rr)).T
        dy = -((dr.T) * (np.sin(stations.pp))
               + (dp.T) * (np.cos(stations.pp) / stations.rr)).T
        dz = -dd
    else:
        dx = deriv[:, drv.i_x, :, :]
        dy = deriv[:, drv.i_y, :, :]
        dz = -deriv[:, drv.i_z, :, :]
    rows = [dx, dy, dz]
    if drv.moment_tensor:
        rows += [deriv[:, drv.i_mt + _DIAGORDER[k], :, :] for k in range(6)]
    return np.array(rows)


def prop8seis_host(x, y, z, prop8data, Mxyz=None, nt=61, timestep=1.0,
                   derivatives=True, geometry="cartesian"):
    """Host-side pyprop8 forward (+ Jacobian), mirroring prop8seis
    (loc_cmt_util.py:28-58). Returns (t, seis, jac_or_None)."""
    if not HAVE_PYPROP8:
        raise ImportError("pyprop8 is not installed")
    Nm2moment = 1.0e-13
    strike, dip, rake, Mo = prop8data["sdrm"]
    if Mxyz is None:
        Mxyz = _rtf2xyz(_make_mt(strike, dip, rake, Mo * Nm2moment, 0, 0))
    source = _pp.PointSource(x, y, z, Mxyz, np.zeros((3, 1)), 0.0)
    stations = _pp.ListOfReceivers(xx=prop8data["recx"].flatten(),
                                   yy=prop8data["recy"].flatten(), depth=0.0)
    stf = lambda om: _clp_filter(om, 2 * np.pi * 0.05, 2 * np.pi * 0.2)
    if not derivatives:
        t, s = _pp.compute_seismograms(
            prop8data["model"], source, stations, nt, timestep, 0.023,
            source_time_function=stf, derivatives=None, show_progress=False)
        return t, np.atleast_3d(s), None
    if geometry == "cartesian":
        drv = _pp.DerivativeSwitches(x=True, y=True, z=True, moment_tensor=True,
                                     structure=prop8data["model"])
    else:
        drv = _pp.DerivativeSwitches(r=True, phi=True, z=True, moment_tensor=True,
                                     structure=prop8data["model"])
    t, s, d = _pp.compute_seismograms(
        prop8data["model"], source, stations, nt, timestep, 0.023,
        source_time_function=stf, derivatives=drv, show_progress=False)
    jac = _drv_to_cartesian(drv, np.atleast_3d(d) if d.ndim < 4 else d,
                            stations, geometry=geometry)
    return t, np.atleast_3d(s), jac


def prop8seis(m, prop8data, nr: int, nt: int = 61, timestep: float = 1.0,
              cmt: bool = True, dtype=torch.float64):
    """Differentiable pyprop8 seismograms (nr, 3, nt) on m's device.

    Args:
      m: (3,) location or (9,) location + upper-triangular moment tensor.
      prop8data: host dict (model, recx, recy, sdrm) as in the reference.

    Autograd w.r.t. m uses pyprop8's Jacobians.
    """
    nm = 9 if cmt else 3

    def host_fn(mv):
        Mxyz = None
        if cmt:
            Mxyz = mxyz_from_upper(torch.as_tensor(mv[3:], dtype=torch.float64)).numpy()
        _, s, jac = prop8seis_host(mv[0], mv[1], max(mv[2], 1e-3), prop8data,
                                   Mxyz=Mxyz, nt=nt, timestep=timestep)
        return s, jac[:nm]

    return host_forward_with_jacobian(host_fn, m, (nr, 3, nt), dtype, (nm, nr, 3, nt))
