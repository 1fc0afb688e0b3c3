"""Wasserstein barycenter paths, displacement interpolation (counterpart of
waveform_ot_tpu.ops.barycenter; the reference's barypath_pointmass and
barypath). Every weight is one row of a batch.
"""

from __future__ import annotations

import numpy as np
import torch

from waveform_ot_torch.ops.fingerprint import linspace
from waveform_ot_torch.ops.otpdf import Density1D
from waveform_ot_torch.ops.wasser import _merge


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """jnp.interp(x, xp, fp) for a non-decreasing 1-D ``xp``, in its
    arithmetic: i = clip(searchsorted(xp, x, 'right'), 1, n-1),
    fp[i-1] + (x - xp[i-1]) / dx * df, fp[i-1] where dx is at most
    spacing(eps) (a repeated xp, a flat CDF run), and fp[0] / fp[-1]
    below / above the ends."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x, side="right"), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(torch.finfo(xp.dtype).dtype).eps))
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _gradient(y: torch.Tensor) -> torch.Tensor:
    """jnp.gradient along the last axis, unit spacing, first-order edges."""
    return torch.gradient(y, spacing=1.0, dim=-1, edge_order=1)[0]


def barycenter_pointmass(source: Density1D, target: Density1D, weights,
                         include_endpoints: bool = False):
    """Displacement interpolation of point masses (reference
    barypath_pointmass). Returns (positions (k, m), masses (m,)): for each
    weight w the merged support moves to (1-w) x_f[indf] + w x_g[indg]
    carrying the merged masses dtk.

    With ``include_endpoints`` it returns the reference's lists (amplitudes,
    positions), whose first and last entries are the original (pdf, x) of
    the source and the target whatever the weights.
    """
    _, _, indf, indg, dtk = _merge(source.cdf, target.cdf)
    w = torch.as_tensor(np.asarray(weights), dtype=dtk.dtype, device=dtk.device)[:, None]
    xs = (1.0 - w) * source.x[indf][None, :] + w * target.x[indg][None, :]
    if not include_endpoints:
        return xs, dtk
    amps = [dtk] * xs.shape[0]
    xlist = [xs[i] for i in range(xs.shape[0])]
    amps[0], xlist[0] = source.pdf, source.x
    amps[-1], xlist[-1] = target.pdf, target.x
    return amps, xlist


def barycenter_continuous(source: Density1D, target: Density1D, weights,
                          npoints: int = 50000, return_taxis: bool = False):
    """Continuous displacement interpolation (reference barypath): both
    inverse CDFs on a regular quantile grid t of ``npoints``, blended per
    weight, the density recovered as dt/dx. Returns (k, 2, npoints):
    [:, 0] positions, [:, 1] density; with ``return_taxis`` also t."""
    cdf = source.cdf
    t = linspace(cdf.new_zeros(()), cdf.new_ones(()), npoints)
    finv = interp(t, source.cdf, source.x)
    ginv = interp(t, target.cdf, target.x)
    w = torch.as_tensor(np.asarray(weights), dtype=cdf.dtype, device=cdf.device)[:, None]
    x = w * ginv + (1.0 - w) * finv
    pdf = _gradient(t) / torch.clamp(_gradient(x), min=1e-30)
    out = torch.stack([x, pdf], dim=1)
    return (out, t) if return_taxis else out
