"""Marginal Wasserstein distances of 2-D fields (counterpart of
waveform_ot_tpu.ops.marginal): ``marg_wasserstein_value`` batched over
traces, and the reference's ``MargWasserstein`` as ``marg_wasserstein``.

The gradient assembly of the reference's MargWasserstein is autograd through
``marg_wasserstein_value``: ``wasserstein_1d`` normalizes internally and its
amplitude gradient already carries the projection term.
"""

from __future__ import annotations

import torch

from waveform_ot_torch.ops import errors
from waveform_ot_torch.ops.fingerprint import _col
from waveform_ot_torch.ops.otpdf import Density1D, Density2D, marginals
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


def marg_wasserstein(source: Density2D, target: Density2D, distfunc: str = "W2",
                     derivatives: bool = False, returnmargW: bool = False):
    """The reference MargWasserstein on two 2-D densities (pdf (nu, ntg)):

      returnmargW=False, derivatives=False: [ (wt+wu)/2 ]
      returnmargW=False, derivatives=True : [ (wt+wu)/2, (dwt+dwu)/2, dwg/2 ]
      returnmargW=True,  derivatives=False: [ [wt, wu] ]
      returnmargW=True,  derivatives=True : [ [wt, wu], [dwt, dwu], [dwg, 0] ]

    dwt, dwu are (nu, ntg) gradients w.r.t. the unnormalized source
    amplitudes; dwg is the derivative w.r.t. a rigid shift of the source
    time support. 'W12' raises MarginalWassersteinError.
    """
    if distfunc == "W12":
        raise errors.MarginalWassersteinError("W12")
    p = 1 if distfunc == "W1" else 2
    tgt_t, tgt_u = (Density1D(*(v[None] for v in d)) for d in marginals(target))
    tgrid = source.x[None, 0, :, 0]
    ugrid = source.x[None, :, 0, 1]
    u2d = (source.pdf * source.amp)[None].detach()
    if not derivatives:
        with torch.no_grad():
            wt, wu = marg_wasserstein_value(u2d, tgrid, ugrid, tgt_t, tgt_u, p)
        if returnmargW:
            return [[wt[0], wu[0]]]
        return [(wt[0] + wu[0]) / 2.0]
    u = u2d.requires_grad_()
    shift = u2d.new_zeros(()).requires_grad_()
    with torch.enable_grad():
        wt, wu = marg_wasserstein_value(u, tgrid, ugrid, tgt_t, tgt_u, p, tshift=shift)
        dwt, dwg = torch.autograd.grad(wt[0], (u, shift))
        (dwu,) = torch.autograd.grad(wu[0], u)
    wt, wu, dwt, dwu = wt[0].detach(), wu[0].detach(), dwt[0], dwu[0]
    if returnmargW:
        return [[wt, wu], [dwt, dwu], [dwg, torch.zeros_like(dwg)]]
    return [(wt + wu) / 2.0, (dwt + dwu) / 2.0, dwg / 2.0]
