"""Exact 1-D Wasserstein distances with the closed-form O(m) backward.

Counterpart of waveform_ot_tpu.ops.wasser.wasserstein_1d, batched over a
leading dimension. The merged-CDF quantile integral is

    cf, cg      renormalized CDFs of source / target        (B, n_f), (B, n_g)
    a           cat(cf[:, :-1], cg)                          (B, m), m = n_f + n_g - 1
    tk, perm    stable sort of a
    indf, indg  searchsorted(cf | cg, tk, side='left')
    dtk         first differences of tk (with a prepended 0)
    W_p^p       sum(|xf[indf] - xg[indg]|^p * dtk)

This is the sort path (``_merge``) of the JAX module; the TPU-only O(m^2)
rank counting and one-hot matmuls are not carried over, since sort,
searchsorted, gather and scatter are native on the GPU and the CPU.

Invariants kept from the JAX module: the value is W_p^p; amplitude
gradients are with respect to the *unnormalized* amplitudes; each CDF is
computed once and that one tensor feeds both the sort and the
searchsorted, so the merge sees one consistent total order.
"""

from __future__ import annotations

import torch

from waveform_ot_torch.ops import errors


def _cdf(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """amp and renormalized CDF of unnormalized amplitudes (B, n)."""
    amp = f.sum(dim=-1)
    cdf = torch.cumsum(f, dim=-1) / amp[:, None]
    cdf = cdf / cdf[:, -1:]
    return amp, cdf


def _dist(dx: torch.Tensor, p: int) -> torch.Tensor:
    if p == 1:
        return dx.abs()
    if p == 2:
        return dx * dx
    raise errors.UnknownOTDistanceTypeError(p)


def _dist_ddx(dx: torch.Tensor, p: int) -> torch.Tensor:
    """d(dist)/d(dx): sign for W1, 2*dx for W2."""
    if p == 1:
        return torch.sign(dx)
    return 2.0 * dx


def _amp_grad(s: torch.Tensor, cdf: torch.Tensor, amp: torch.Tensor,
              last: bool) -> torch.Tensor:
    """Closed-form gradient w.r.t. unnormalized amplitudes (B, n).

    ``s`` are the merged-slot sensitivities of this density's CDF entries:
    cf[:, :-1] (source, ``last`` False) or all of cg (target, ``last`` True).
    """
    rev = torch.flip(torch.cumsum(torch.flip(s, (-1,)), dim=-1), (-1,))
    if last:
        c0 = (cdf * s).sum(dim=-1)
    else:
        rev = torch.cat([rev, rev.new_zeros(rev.shape[0], 1)], dim=-1)
        c0 = (cdf[:, :-1] * s).sum(dim=-1)
    return (rev - c0[:, None]) / amp[:, None]


class _Wasserstein1D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, xf, g, xg, p: int):
        ampf, cf = _cdf(f)
        ampg, cg = _cdf(g)
        a = torch.cat([cf[:, :-1], cg], dim=-1)
        tk, perm = torch.sort(a, dim=-1, stable=True)
        indf = torch.searchsorted(cf, tk, side="left")
        indg = torch.searchsorted(cg, tk, side="left")
        dtk = torch.diff(tk, dim=-1, prepend=tk.new_zeros(tk.shape[0], 1))
        dx = torch.gather(xf, -1, indf) - torch.gather(xg, -1, indg)
        w = (_dist(dx, p) * dtk).sum(dim=-1)
        ctx.p = p
        ctx.save_for_backward(ampf, cf, ampg, cg, perm, indf, indg, dtk, dx)
        return w

    @staticmethod
    def backward(ctx, wbar):
        ampf, cf, ampg, cg, perm, indf, indg, dtk, dx = ctx.saved_tensors
        p = ctx.p
        nf = cf.shape[-1]
        dist = _dist(dx, p)
        wb = wbar[:, None]
        # positions: segment-sum of the translation integrand per support point
        ddx = _dist_ddx(dx, p) * dtk * wb
        gxf = torch.zeros_like(cf).scatter_add_(-1, indf, ddx)
        gxg = torch.zeros_like(cg).scatter_add_(-1, indg, -ddx)
        # amplitudes: closed-form adjoint of the merged quantile integral;
        # s[perm[l]] = e[l] moves the sorted sensitivities back to slots
        e = (dist - torch.cat([dist[:, 1:], dist.new_zeros(dist.shape[0], 1)],
                              dim=-1)) * wb
        s = torch.empty_like(e).scatter_(-1, perm, e)
        gf = _amp_grad(s[:, :nf - 1], cf, ampf, last=False)
        gg = _amp_grad(s[:, nf - 1:], cg, ampg, last=True)
        return gf, gxf, gg, gxg, None


def wasserstein_1d(f, xf, g, xg, p: int = 2) -> torch.Tensor:
    """W_p^p between batches of 1-D discrete densities.

    Args:
      f:  (B, n_f) unnormalized non-negative source amplitudes.
      xf: (B, n_f) source support locations, sorted ascending per row.
      g:  (B, n_g) unnormalized non-negative target amplitudes.
      xg: (B, n_g) target support locations, sorted ascending per row.
      p:  1 or 2.

    Returns (B,) values W_p^p. Differentiable w.r.t. all four tensors by
    the closed-form rule of waveform_ot_tpu.ops.wasser._wasser_bwd.
    Supports shared by every row are passed expanded, e.g.
    ``x.expand(B, n)``; autograd sums their gradients.
    """
    if p not in (1, 2):
        raise errors.UnknownOTDistanceTypeError(p)
    for name, v in (("f", f), ("xf", xf), ("g", g), ("xg", xg)):
        if v.dim() != 2:
            raise ValueError(f"{name} must be (B, n), got {tuple(v.shape)}")
    if f.shape != xf.shape or g.shape != xg.shape or f.shape[0] != g.shape[0]:
        raise ValueError(f"shape mismatch: f{tuple(f.shape)} xf{tuple(xf.shape)} "
                         f"g{tuple(g.shape)} xg{tuple(xg.shape)}")
    return _Wasserstein1D.apply(f, xf, g, xg, p)
