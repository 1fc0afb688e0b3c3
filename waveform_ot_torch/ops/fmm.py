"""Fast-marching distance field (native C++ solver, optional skfmm)
(counterpart of waveform_ot_tpu.ops.fmm).

Reference: the 'FMM' branch of waveformFP.calcpdf
(libs/FingerprintLib.py:139-152): build a signed indicator (+1 above the
waveform interpolated onto the grid time axis, -1 below), run
skfmm.distance, take |.|. The exact polyline field (the CUDA kernel on the
card) is the production method; this is the approximate host-side
alternative, and its field is host NumPy wherever the caller's tensors live.

The default backend is the package's own C++ fast-marching solver
(waveform_ot_torch/native/src/wotnative.cpp: the same first/second-order
upwind scheme and sub-cell interface initialization as skfmm); skfmm is
preferred when it is installed. :class:`errors.FMMLibraryError` is raised
only when the requested backend is unavailable (the reference guard at
FingerprintLib.py:139-141 for backend='skfmm').

The reference's own comments question its dx handling ("IS self.delgrid the
wrong way around here?", FingerprintLib.py:148); this module reproduces the
reference behaviour as-is, including passing (d_amplitude, d_time) cell sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from waveform_ot_torch.ops import errors

try:
    import skfmm as _skfmm

    HAVE_SKFMM = True
except ImportError:  # the wheel is optional
    _skfmm = None
    HAVE_SKFMM = False


def _host(a) -> np.ndarray:
    """An array or a tensor on any device as a NumPy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def signed_indicator(t, w, tgrid, ugrid) -> np.ndarray:
    """The FMM seed field phi: +1 above the grid-interpolated waveform, -1 on
    or below it (FingerprintLib.py:142-146). Pure NumPy (tensors are copied
    to the host), so viz.plot_phi draws it without any FMM backend."""
    tgrid, ugrid = _host(tgrid), _host(ugrid)
    phi = -np.ones((len(ugrid), len(tgrid)))
    wi = np.interp(tgrid, _host(t), _host(w))
    _, yn = np.meshgrid(tgrid, ugrid)
    phi[yn > wi] = 1.0
    return phi


def distance_field_fmm(t, w, tgrid, ugrid, backend: str = "auto",
                       order: int | None = None) -> np.ndarray:
    """|signed distance| to the waveform's grid-interpolated zero contour.

    Args (arrays or tensors; the field is computed on the host):
      t, w:    waveform samples.
      tgrid:   (ntg,) grid time axis; ugrid: (nu,) amplitude axis
               (physical or normalized, consistent with t, w).
      backend: 'skfmm'  the scikit-fmm wheel (raises FMMLibraryError when
                        absent, the reference behaviour);
               'native' the package's C++ fast-marching solver;
               'auto'   skfmm when installed, else native.
      order:   upwind difference order (1 or 2). Default: 2 for skfmm (its
               own default) but 1 for the native backend: the pipeline seeds
               FMM with a +/-1 indicator whose interface band is only
               half-cell accurate, and second-order extrapolation through
               that band amplifies its quantization error.

    Returns (nu, ntg) distances, NumPy float64.
    """
    tgrid, ugrid = _host(tgrid), _host(ugrid)
    nu, ntg = len(ugrid), len(tgrid)
    if backend == "auto":
        backend = "skfmm" if HAVE_SKFMM else "native"
    if order is None:
        order = 2 if backend == "skfmm" else 1
    phi = signed_indicator(t, w, tgrid, ugrid)
    # reference cell sizes, reproduced as-is (FingerprintLib.py:147-151)
    du = (ugrid[-1] - ugrid[0]) / nu
    dt = (tgrid[-1] - tgrid[0]) / ntg
    if backend == "skfmm":
        if not HAVE_SKFMM:
            raise errors.FMMLibraryError()
        d = _skfmm.distance(phi, dx=np.array([du, dt]), order=order)
    elif backend == "native":
        from waveform_ot_torch import native

        d = native.fmm_distance(phi, (du, dt), order=order)
    else:
        raise ValueError(f"unknown FMM backend {backend!r}")
    return np.abs(d)


def fmm_ray_endpoints(d, deltax):
    """Ray end points from an FMM distance field via its gradient.

    Reference: calcFMM_dist_deriv (FingerprintLib.py:853-865): normalize
    np.gradient of the distance field and step each normalized grid point
    back along it by its distance; zero-gradient points map to (0, 0) as in
    the reference. Returns (Xw, Yw) in normalized [0, 1] coordinates, NumPy.
    """
    d = _host(d)
    dy, dx = np.gradient(d, deltax[0], deltax[1])
    nu, ntg = d.shape
    xn, yn = np.meshgrid(np.linspace(0, 1, ntg), np.linspace(0, 1, nu))
    a = np.sqrt(dx * dx + dy * dy)
    dy = np.divide(dy, a, out=np.zeros_like(dy), where=a != 0)
    dx = np.divide(dx, a, out=np.zeros_like(dx), where=a != 0)
    xw = xn - d * dx
    yw = yn - d * dy
    xw[a == 0] = 0.0
    yw[a == 0] = 0.0
    return xw, yw
