"""The plain reference of the loc-only W2 misfit and its gradient.

A straightforward implementation of the chain the port runs, written from
its definition (Sambridge, Jackson & Valentine 2022, sections 2-4):

  seismograms (k, nr, 3, nt)
    -> arctan squash into (0, 1) by each observed trace's padded range
    -> polyline of (t, u) in the unit window, (nt, 2) per trace
    -> nearest distance d from every point of the (nu, ntg) unit grid to it
    -> density exp(-d / lambda), its time and amplitude marginals
    -> W2^2 of each marginal against the observed one, by the quantile
       integral over the merged CDFs
    -> misfit = sum over traces of (W_t + W_u) / 2.

The nearest segment is found without a graph (argmin over every segment)
and the distance is then recomputed on that segment with one, so autograd
gives the envelope derivative; W2 is differentiated by autograd through
the sort of the merged CDFs. Everything runs in the dtype the caller
picks: float64 for the reference, bfloat16 for the control. Imports
nothing of the port.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

# point-segment pairs per block of the argmin
_PAIRS_PER_BLOCK = 1 << 24


class Observed(NamedTuple):
    """The observed side, built once: per-trace squash limits (nr, 3) and
    the observed marginals (nr*3, ntg) and (nr*3, nu) with their grids."""

    t: torch.Tensor
    u0: torch.Tensor
    u1: torch.Tensor
    ft: torch.Tensor
    fu: torch.Tensor
    tgrid: torch.Tensor
    ugrid: torch.Tensor


def unit_grid(n: int, dtype, device) -> torch.Tensor:
    """n points from 0 to 1, start (1 - i/(n-1)) + stop i/(n-1), the last 1."""
    i = torch.arange(n, dtype=torch.float64, device=device)
    return (i / (n - 1)).to(dtype)


def squash(s, u0, u1):
    """0.5 + arctan(((s - u0) + (s - u1)) / (u1 - u0)) / pi, per trace."""
    u0, u1 = u0[..., None], u1[..., None]
    return 0.5 + torch.atan(((s - u0) + (s - u1)) / (u1 - u0)) / math.pi


def nearest_distance(verts, tgrid, ugrid):
    """d (B, nu, ntg) from each grid point to each polyline verts (B, nt, 2)."""
    bsz, nt, _ = verts.shape
    nu, ntg = ugrid.shape[0], tgrid.shape[0]
    px = tgrid[None, :].expand(nu, ntg).reshape(-1)
    py = ugrid[:, None].expand(nu, ntg).reshape(-1)
    x0 = verts[:, :-1]
    c = verts[:, 1:] - x0
    lsq = (c * c).sum(-1)

    def seg_terms(x0, c, lsq, px, py):
        bx, by = px - x0[..., 0], py - x0[..., 1]
        lam = torch.clamp((bx * c[..., 0] + by * c[..., 1]) / lsq, 0.0, 1.0)
        dx, dy = bx - lam * c[..., 0], by - lam * c[..., 1]
        return dx * dx + dy * dy

    with torch.no_grad():
        step = max(1, _PAIRS_PER_BLOCK // (px.shape[0] * (nt - 1)))
        idx = torch.cat([
            seg_terms(x0[b:b + step, None], c[b:b + step, None], lsq[b:b + step, None],
                      px[None, :, None], py[None, :, None]).argmin(-1)
            for b in range(0, bsz, step)])                       # (B, P)
    take = lambda v: torch.gather(v, 1, idx[..., None].expand(-1, -1, v.shape[-1]))
    dsq = seg_terms(take(x0), take(c), torch.gather(lsq, 1, idx), px, py)
    pos = dsq > 0
    d = torch.where(pos, torch.sqrt(torch.where(pos, dsq, torch.ones_like(dsq))),
                    torch.zeros_like(dsq))
    return d.reshape(bsz, nu, ntg)


def w2(f, xf, g, xg):
    """W2^2 (B,) between unnormalized densities f on xf and g on xg, rows
    of (B, n): the integral over q of |F^-1(q) - G^-1(q)|^2."""
    cf = torch.cumsum(f, -1)
    cf = cf / cf[..., -1:]
    cg = torch.cumsum(g, -1)
    cg = cg / cg[..., -1:]
    q, _ = torch.sort(torch.cat([cf[..., :-1], cg], -1), dim=-1, stable=True)
    i = torch.searchsorted(cf.detach().contiguous(), q.detach(), side="left")
    j = torch.searchsorted(cg.detach().contiguous(), q.detach(), side="left")
    dq = torch.diff(q, dim=-1, prepend=torch.zeros_like(q[..., :1]))
    dx = torch.gather(xf.expand_as(f), -1, i) - torch.gather(xg.expand_as(g), -1, j)
    return (dx * dx * dq).sum(-1)


def fingerprint_marginals(un, t_unit, tgrid, ugrid, lam):
    """Time and amplitude marginals of the fingerprints of squashed traces
    un (B, nt) on the unit time axis t_unit (nt,)."""
    verts = torch.stack([t_unit.expand_as(un), un], -1)
    dens = torch.exp(-nearest_distance(verts, tgrid, ugrid) / lam)
    return dens.sum(-2), dens.sum(-1)


def observe(seis_obs, cfg: dict, dtype) -> Observed:
    """The observed side of ``seis_obs`` (nr, 3, nt) in ``dtype``."""
    s = seis_obs.to(dtype)
    nt = s.shape[-1]
    lo, hi = s.amin(-1), s.amax(-1)
    pad = cfg["window_pad"] * (hi - lo)
    u0, u1 = lo - pad, hi + pad
    tgrid = unit_grid(cfg["ntg"], dtype, s.device)
    ugrid = unit_grid(cfg["nu"], dtype, s.device)
    t_unit = unit_grid(nt, dtype, s.device)
    with torch.no_grad():
        ft, fu = fingerprint_marginals(squash(s, u0, u1).reshape(-1, nt), t_unit, tgrid,
                                       ugrid, cfg["lambda"])
    return Observed(t_unit, u0, u1, ft, fu, tgrid, ugrid)


def misfit(s, obs: Observed, cfg: dict):
    """Misfits (k,) of predicted seismograms s (k, nr, 3, nt)."""
    k, nr, nc, nt = s.shape
    un = squash(s.to(obs.u0.dtype), obs.u0, obs.u1).reshape(k * nr * nc, nt)
    ft, fu = fingerprint_marginals(un, obs.t, obs.tgrid, obs.ugrid, cfg["lambda"])
    rep = lambda v: v.repeat(k, 1)
    wt = w2(ft, obs.tgrid, rep(obs.ft), obs.tgrid)
    wu = w2(fu, obs.ugrid, rep(obs.fu), obs.ugrid)
    return (0.5 * (wt + wu)).reshape(k, nr * nc).sum(-1)


def value_and_grad(forward: Callable, obs: Observed, cfg: dict, ms, block: int):
    """(misfits (k,), gradients (k, 3)) at source locations ms (k, 3) in
    blocks of ``block`` models; ``forward(x, y, z)`` gives (k, nr, 3, nt)."""
    vals, grads = [], []
    for b in range(0, ms.shape[0], block):
        m = ms[b:b + block].detach().clone().requires_grad_(True)
        with torch.enable_grad():
            v = misfit(forward(m[:, 0], m[:, 1], m[:, 2]), obs, cfg)
            (g,) = torch.autograd.grad(v.sum(), m)
        vals.append(v.detach())
        grads.append(g)
    return torch.cat(vals), torch.cat(grads)
