"""Exact 1-D Wasserstein distances with the closed-form O(m) backward,
the reference-style ``wasser``, optimal plans and their Jacobians.

Counterpart of waveform_ot_tpu.ops.wasser, batched over leading
dimensions. The merged-CDF quantile integral is

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
from waveform_ot_torch.ops.otpdf import Density1D


def _cdf(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """amp and renormalized CDF of unnormalized amplitudes (..., n): the
    JAX module's operations in its order (cumsum, divide by the sum,
    divide by the last entry)."""
    amp = f.sum(dim=-1)
    cdf = torch.cumsum(f, dim=-1) / amp[..., None]
    cdf = cdf / cdf[..., -1:]
    return amp, cdf


def _merge(cf: torch.Tensor, cg: torch.Tensor):
    """Merged-support quantities of CDFs (..., n_f) and (..., n_g):
    (tk, perm, indf, indg, dtk), each (..., m) with m = n_f + n_g - 1."""
    a = torch.cat([cf[..., :-1], cg], dim=-1)
    tk, perm = torch.sort(a, dim=-1, stable=True)
    indf = torch.searchsorted(cf.contiguous(), tk, side="left")
    indg = torch.searchsorted(cg.contiguous(), tk, side="left")
    dtk = torch.diff(tk, dim=-1, prepend=torch.zeros_like(tk[..., :1]))
    return tk, perm, indf, indg, dtk


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
        _, perm, indf, indg, dtk = _merge(cf, cg)
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


def wasserstein_1d_autodiff(f, xf, g, xg, p: int = 2) -> torch.Tensor:
    """W_p^p of (..., n) densities by plain autograd through the sort and
    the CDFs (no custom backward): the differential-testing oracle of
    :func:`wasserstein_1d`."""
    _, cf = _cdf(f)
    _, cg = _cdf(g)
    _, _, indf, indg, dtk = _merge(cf, cg)
    dx = torch.gather(xf, -1, indf) - torch.gather(xg, -1, indg)
    return (_dist(dx, p) * dtk).sum(dim=-1)


def wasserstein_1d_cost(f, g, cost, indexer=None) -> torch.Tensor:
    """W with a precomputed cost array (the reference's user-cost path).

    f (..., n_f), g (..., n_g); ``cost`` is an (N_f, N_g) tensor read at
    the merged support, cost[indf, indg]. ``indexer`` = (pf (..., n_f),
    pg (..., n_g)) first maps the merged indices through per-row
    permutations (the sliced form, which reads an unprojected 2-D cost).
    Differentiable w.r.t. the amplitudes only, as in the reference.
    """
    _, cf = _cdf(f)
    _, cg = _cdf(g)
    _, _, indf, indg, dtk = _merge(cf, cg)
    if indexer is not None:
        indf = torch.gather(indexer[0], -1, indf)
        indg = torch.gather(indexer[1], -1, indg)
    return (cost[indf, indg] * dtk).sum(dim=-1)


def _value_and_grads(fn, args, wrt):
    """fn(*args) and its gradients w.r.t. the arguments at ``wrt``."""
    args = [a.detach().requires_grad_(i in wrt) for i, a in enumerate(args)]
    with torch.enable_grad():
        w = fn(*args)
        grads = torch.autograd.grad(w, [args[i] for i in wrt])
    return w.detach(), grads


def wasser(source: Density1D, target: Density1D, distfunc="W12",
           derivatives: bool = False):
    """The reference ``wasser`` on two 1-D densities (pdf (n,)).

    ``distfunc`` is 'W1', 'W2' or 'W12' (closed form), or a user cost: an
    (n_f, n_g) array or tensor, a callable cost(i, j) (evaluated once into
    the array), or a tuple whose last element is the array. Returns
    [W1(, dW1/df, dW1/dt)][, W2(, dW2/df, dW2/dt)] for the closed forms and
    [Wf(, dWf/df, 0.0)] for a user cost, with W the p-th power, dW/df
    w.r.t. the unnormalized source amplitudes and dW/dt the rigid
    translation derivative of the source support.
    """
    f = source.pdf * source.amp
    g = target.pdf * target.amp
    if not isinstance(distfunc, str):
        if isinstance(distfunc, tuple):
            distfunc = distfunc[-1]
        if callable(distfunc):
            fn = distfunc
            distfunc = [[fn(i, j) for j in range(g.shape[-1])] for i in range(f.shape[-1])]
        cost = torch.as_tensor(distfunc, dtype=f.dtype, device=f.device)
        if tuple(cost.shape) != (f.shape[-1], g.shape[-1]):
            raise errors.DistfuncShapeError(
                f"cost shape {tuple(cost.shape)} != ({f.shape[-1]}, {g.shape[-1]})")
        value = lambda ff, gg: wasserstein_1d_cost(ff, gg, cost)
        if derivatives:
            w, (dw,) = _value_and_grads(value, (f, g), wrt=(0,))
            return [w, dw, 0.0]
        with torch.no_grad():
            return [value(f, g)]
    ps = [p for p, names in ((1, ("W1", "W12")), (2, ("W2", "W12"))) if distfunc in names]
    if not ps:
        raise errors.UnknownOTDistanceTypeError(distfunc)
    args = (f[None], source.x[None], g[None], target.x[None])
    out = []
    for p in ps:
        value = lambda *a, p=p: wasserstein_1d(*a, p)[0]
        if derivatives:
            w, (dw, dx) = _value_and_grads(value, args, wrt=(0, 1))
            out += [w, dw[0], dx.sum()]
        else:
            with torch.no_grad():
                out.append(value(*args))
    return out


# ---------------------------------------------------------------------------
# transport plans
# ---------------------------------------------------------------------------


def transport_plan_1d(f, xf, g, xg) -> torch.Tensor:
    """Optimal plans H (..., n_f, n_g) of (..., n) densities: the merged
    masses dtk scattered to (indf, indg) (one ``scatter_add_``)."""
    _, cf = _cdf(f)
    _, cg = _cdf(g)
    _, _, indf, indg, dtk = _merge(cf, cg)
    nf, ng = f.shape[-1], g.shape[-1]
    flat = dtk.new_zeros(dtk.shape[:-1] + (nf * ng,))
    return flat.scatter_add_(-1, indf * ng + indg, dtk).reshape(dtk.shape[:-1] + (nf, ng))


def transport_plan_jacobian(f, xf, g, xg) -> torch.Tensor:
    """dH/df (..., n_f, n_f, n_g): Jacobian of the plan w.r.t. the
    unnormalized source amplitudes (the reference's dH), from the dense
    (n_f, m) derivatives of the merged masses and one ``index_add_`` over
    the plan's cells (all batch rows at once)."""
    ampf, cf = _cdf(f)
    _, cg = _cdf(g)
    _, perm, indf, indg, dtk = _merge(cf, cg)
    nf, ng = f.shape[-1], g.shape[-1]
    m = dtk.shape[-1]
    batch = dtk.shape[:-1]
    # D[i, k] = (1{k >= i} - cf[k]) / amp for merged slot k < nf-1, else 0
    k = torch.arange(nf - 1, device=f.device)
    i = torch.arange(nf, device=f.device)[:, None]
    upper = (k[None, :] >= i).to(f.dtype)
    d_f = (upper - cf[..., None, :-1]) / ampf[..., None, None]         # (..., nf, nf-1)
    d = torch.cat([d_f, d_f.new_zeros(batch + (nf, ng))], dim=-1)      # (..., nf, m)
    difftk = torch.gather(d, -1, perm[..., None, :].expand(batch + (nf, m)))
    diffdtk = torch.cat([difftk[..., :1], torch.diff(difftk, dim=-1)], dim=-1)
    nb = diffdtk[..., 0, 0].numel()
    cell = (indf * ng + indg).reshape(nb, m)
    cell = cell + torch.arange(nb, device=f.device)[:, None] * (nf * ng)
    flat = diffdtk.new_zeros(nb * nf * ng, nf).index_add_(
        0, cell.reshape(-1), diffdtk.reshape(nb, nf, m).transpose(1, 2).reshape(nb * m, nf))
    return flat.reshape(batch + (nf, ng, nf)).movedim(-1, -3)


# ---------------------------------------------------------------------------
# tie diagnostics
# ---------------------------------------------------------------------------


def common_cdf_mask(f, g) -> torch.Tensor:
    """True where an entry of the source CDF (but its final 1.0) equals an
    entry of the target CDF exactly: the amplitude derivatives are not
    defined at such ties."""
    _, cf = _cdf(f)
    _, cg = _cdf(g)
    return (cf[..., :-1, None] == cg[..., None, :-1]).any(dim=-1)


def check_common_cdf(f, g) -> None:
    """Raise TargetSourceCDFError if the CDFs of f and g share a value."""
    mask = common_cdf_mask(f, g)
    if bool(mask.any()):
        _, cf = _cdf(f)
        raise errors.TargetSourceCDFError(cf[..., :-1][mask].cpu().numpy())
