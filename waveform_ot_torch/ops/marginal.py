"""Marginal Wasserstein distances of 2-D fields (counterpart of
waveform_ot_tpu.ops.marginal.marg_wasserstein_value), batched over traces.

The gradient assembly of the reference's MargWasserstein is autograd through
this function: ``wasserstein_1d`` normalizes internally and its amplitude
gradient already carries the projection term.
"""

from __future__ import annotations

from waveform_ot_torch.ops.fingerprint import _col
from waveform_ot_torch.ops.otpdf import Density1D
from waveform_ot_torch.ops.wasser import wasserstein_1d


def marg_wasserstein_value(u2d, tgrid, ugrid, target_t: Density1D,
                           target_u: Density1D, p: int = 2, tshift=0.0):
    """(W_t (B,), W_u (B,)) of unnormalized fields u2d (B, nu, ntg).

    tgrid (B, ntg) and ugrid (B, nu) are the marginal supports; the targets
    are batched observed marginals. ``tshift`` (scalar or (B,)) rigidly
    shifts the source time support; its gradient is the reference's
    window-origin derivative dwg.
    """
    f_t = u2d.sum(dim=-2)
    f_u = u2d.sum(dim=-1)
    wt = wasserstein_1d(f_t, tgrid + _col(tshift), target_t.pdf, target_t.x, p)
    wu = wasserstein_1d(f_u, ugrid, target_u.pdf, target_u.x, p)
    return wt, wu
