"""Sliced Wasserstein distances of 2-D densities (counterpart of
waveform_ot_tpu.ops.sliced; the reference's OTpdf.setSliced and
SlicedWasserstein).

Each of ``nproj`` directions projects the n grid points to a line; the
projections are sorted (stable) and every slice is a 1-D problem. All slices
go through one batched call (B = nproj) of ``wasserstein_1d``, ``transport_plan_1d``,
``transport_plan_jacobian`` or ``wasserstein_1d_cost``. The gradient of
the gather f[psorted] is autograd's scatter, which is the reference's
psorted accumulation.

The projection is written elementwise, cos(theta) * a_t + sin(theta) * a_u,
where the JAX module multiplies matrices: the same rounding on the CPU and
on the card, so both sort the points alike.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from waveform_ot_torch.ops import errors
from waveform_ot_torch.ops.fingerprint import linspace
from waveform_ot_torch.ops.otpdf import Density2D
from waveform_ot_torch.ops.wasser import (
    transport_plan_1d, transport_plan_jacobian, wasserstein_1d, wasserstein_1d_cost,
)


def projection_angles(nproj: int, dtype=torch.float64, device="cuda") -> torch.Tensor:
    """(nproj,) regularly spaced slice angles in [0.1745, pi)."""
    if int(nproj) < 1:
        raise errors.SlicedWassersteinError(f"nproj must be a positive integer, got {nproj!r}")
    arr = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return linspace(arr(0.1745), arr(math.pi), int(nproj) + 1)[:-1]


class SlicedProjections(NamedTuple):
    """Per-angle sorted projections of a 2-D point-mass field.

    f_sorted: (nproj, n) amplitudes in projection-sorted order
    x_sorted: (nproj, n) sorted projected coordinates
    psorted:  (nproj, n) int64 sort permutations (the reference's psorted)
    angles:   (nproj,)
    """

    f_sorted: torch.Tensor
    x_sorted: torch.Tensor
    psorted: torch.Tensor
    angles: torch.Tensor


def _project(x2d, nproj: int, origin):
    """(angles, projections (nproj, n)) of the grid points x2d (nx, ny, 2)."""
    a = x2d.reshape(-1, 2) - torch.as_tensor(origin, dtype=x2d.dtype, device=x2d.device)
    theta = projection_angles(nproj, x2d.dtype, x2d.device)
    fxp = torch.cos(theta)[:, None] * a[:, 0] + torch.sin(theta)[:, None] * a[:, 1]
    return theta, fxp


def project_sliced(density: Density2D, nproj: int, origin) -> SlicedProjections:
    """The reference's OTpdf.setSliced as a function."""
    theta, fxp = _project(density.x, nproj, origin)
    x_sorted, psorted = torch.sort(fxp, dim=1, stable=True)
    return SlicedProjections(f_sorted=density.pdf.reshape(-1)[psorted], x_sorted=x_sorted,
                             psorted=psorted, angles=theta)


def sliced_wasserstein_value(u2d, x2d, target: SlicedProjections, nproj: int,
                             p: int = 2, origin=(0.5, 0.5)) -> torch.Tensor:
    """Mean W_p^p over the slices of the unnormalized source field u2d
    (nx, ny) on x2d (nx, ny, 2) against ``target`` (from project_sliced).
    Differentiable w.r.t. u2d (and x2d); the sort order is held fixed."""
    _, fxp = _project(x2d, nproj, origin)
    psorted = torch.sort(fxp.detach(), dim=1, stable=True).indices
    x_sorted = torch.gather(fxp, 1, psorted)
    f_sorted = u2d.reshape(-1)[psorted]
    return wasserstein_1d(f_sorted, x_sorted, target.f_sorted, target.x_sorted, p).mean()


def sliced_wasserstein(source: Density2D, target: Density2D, nproj: int,
                       distfunc: str = "W2", derivatives: bool = False,
                       returnplan: bool = False, origin=(0.5, 0.5)):
    """The reference SlicedWasserstein's return structure:

      [wsliced]                    derivatives=False, returnplan=False
      [wsliced, dwsliced]          derivatives=True,  returnplan=False
      [wsliced, H]                 derivatives=False, returnplan=True
      [wsliced, dwsliced, H]       derivatives=True,  returnplan=True

    dwsliced (nx, ny) is w.r.t. the unnormalized source amplitudes; H
    (n, n) is the mean of the slices' plans in the unsorted order (the
    JAX module's convention: a mean, where the reference sums).
    """
    p = 1 if distfunc == "W1" else 2
    tgt = project_sliced(target, nproj, origin)
    u2d = (source.pdf * source.amp).detach()
    if derivatives:
        u = u2d.requires_grad_()
        with torch.enable_grad():
            w = sliced_wasserstein_value(u, source.x, tgt, nproj, p, origin)
            (dw,) = torch.autograd.grad(w, u)
        out = [w.detach(), dw]
    else:
        with torch.no_grad():
            out = [sliced_wasserstein_value(u2d, source.x, tgt, nproj, p, origin)]
    if returnplan:
        src = project_sliced(source, nproj, origin)
        plans = transport_plan_1d(src.f_sorted, src.x_sorted, tgt.f_sorted, tgt.x_sorted)
        pf, pg = src.psorted, tgt.psorted
        n = pf.shape[1]
        h = plans.new_zeros(n, n).index_put_(
            (pf[:, :, None].expand_as(plans), pg[:, None, :].expand_as(plans)), plans,
            accumulate=True)
        out.append(h / nproj)
    return out


def sliced_plan_jacobian(source: Density2D, target: Density2D, nproj: int,
                         origin=(0.5, 0.5)) -> torch.Tensor:
    """d(mean plan)/d(unnormalized source amplitudes), (n, n, n).

    Each slice's plan Jacobian (one batched transport_plan_jacobian) is
    accumulated back through the sort permutations on all three axes
    (``index_put_`` with accumulate), then projected onto unnormalized
    amplitudes along axis 0 like the reference.
    """
    src = project_sliced(source, nproj, origin)
    tgt = project_sliced(target, nproj, origin)
    dh = transport_plan_jacobian(src.f_sorted, src.x_sorted, tgt.f_sorted, tgt.x_sorted)
    pf, pg = src.psorted, tgt.psorted
    n = source.n
    index = (pf[:, :, None, None].expand_as(dh), pf[:, None, :, None].expand_as(dh),
             pg[:, None, None, :].expand_as(dh))
    dhgp = dh.new_zeros(n, n, n).index_put_(index, dh, accumulate=True)
    proj = torch.einsum("kij,k->ij", dhgp, source.pdf.reshape(n))
    return (dhgp - proj[None]) / source.amp / nproj


def sliced_wasserstein_plan_cost(source: Density2D, target: Density2D, nproj: int,
                                 cost, origin=(0.5, 0.5)) -> torch.Tensor:
    """Mean over the slices of the 1-D solves against a precomputed 2-D
    cost (n_src, n_tgt), read through the slices' sort permutations (the
    reference's 'Wplan' path)."""
    src = project_sliced(source, nproj, origin)
    tgt = project_sliced(target, nproj, origin)
    return wasserstein_1d_cost(src.f_sorted, tgt.f_sorted, cost,
                               indexer=(src.psorted, tgt.psorted)).mean()
