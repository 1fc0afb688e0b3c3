"""L2 waveform misfit utilities (counterpart of waveform_ot_tpu.inversion.l2).

Reference: ricker_util.datawindowunion / LSmisfit (ricker_util.py:91-103,
341-343): interpolate two waveforms onto the union of their time windows,
zero outside each one's support, and take the squared residual sum.
"""

from __future__ import annotations

import numpy as np
import torch

from waveform_ot_torch.ops.fingerprint import linspace


def interp_zero_fill(x, xp, fp):
    """Linear interpolation of (xp, fp) at ``x``, zero outside [xp[0], xp[-1]]:
    jnp.interp(x, xp, fp, left=0, right=0) with its arithmetic (xp
    ascending)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(torch.finfo(xp.dtype).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], 0.0, f)
    return torch.where(x > xp[-1], 0.0, f)


def window_union(tref, wref, t, w, nt: int | None = None):
    """Both waveforms resampled onto the union of their time windows with
    zero fill: (w on the grid, wref on the grid, grid). The grid runs from
    min(t0) to max(t1) in ``nt`` points, by default the reference's
    int((t1 - t0) / dt) at the spacing of ``t``."""
    t0 = torch.minimum(tref[0], t[0])
    t1 = torch.maximum(tref[-1], t[-1])
    if nt is None:
        nt = int((float(t1) - float(t0)) / float(t[1] - t[0]))
    tnew = linspace(t0, t1, nt)
    return interp_zero_fill(tnew, t, w), interp_zero_fill(tnew, tref, wref), tnew


def ls_misfit(tref, wref, tpred, wpred, nt: int | None = None):
    """Sum of squared residuals on the union grid (reference LSmisfit)."""
    w1, w2, _ = window_union(tref, wref, tpred, wpred, nt=nt)
    r = w1 - w2
    return (r * r).sum()
