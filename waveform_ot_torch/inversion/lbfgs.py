"""Batched L-BFGS drivers and the scipy bridge
(counterpart of waveform_ot_tpu.inversion.lbfgs).

Where the port's signatures part from JAX's: every solver here takes a
BATCHED objective ``fun: (k, n) -> (k,)`` (the port's objectives, e.g.
:func:`waveform_ot_torch.inversion.loc_cmt_misfit`, evaluate k models in one
call) instead of a per-model function that JAX vmaps. The lanes must be
independent (lane j's value depends on row j alone): gradients come from one
autograd pass of the sum over lanes, d(sum_j f_j)/dx_j = df_j/dx_j, so one
value+grad evaluation of all k lanes is one objective call, and on the card
one distance-field launch.

  * :func:`minimize_lbfgs_batched` — masked early exit, value-only
    quadratic-interpolation backtracking, curvature-guarded memory; state
    tensors in the objective's dtype on its device. JAX's two
    ``lax.while_loop`` conditions are host checks here, each reading one
    flag from the device: one per outer iteration and one per line-search
    trial. Nothing else synchronizes.
  * :func:`minimize_lbfgs_batched_host` — the same algorithm with float64
    numpy state on the host; the only device work is one batched value+grad
    and one batched value per step.
  * :func:`minimize_multi_start` — the 64-start study's entry point.
  * :func:`minimize_scipy` — scipy L-BFGS-B over a (value, grad) function.

Not ported: ``minimize_lbfgs`` and ``minimize_multi_start(method="zoom")``
(optax's zoom line search) and ``minimize_multi_start_sharded``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class LBFGSResult(NamedTuple):
    """Per-lane result of a batched solve; every field has the leading k axis.

    ``ls_failed`` marks lanes frozen because the backtracking line search
    exhausted its trials without an acceptable step (e.g. the objective is
    non-finite around the iterate), or whose start or accepted point was
    non-finite: they did NOT converge to tol.
    """

    x: torch.Tensor
    fun: torch.Tensor
    grad_norm: torch.Tensor
    n_iter: torch.Tensor
    ls_failed: torch.Tensor


def _value(fun: Callable, x: torch.Tensor) -> torch.Tensor:
    """Batched values (k,) of ``fun`` at ``x`` (k, n), without a graph."""
    with torch.no_grad():
        return fun(x)


def _value_and_grad(fun: Callable, x: torch.Tensor):
    """Batched values (k,) and gradients (k, n): one call of ``fun`` and one
    autograd pass of the sum over lanes."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        f = fun(x)
        (g,) = torch.autograd.grad(f.sum(), x)
    return f.detach(), g


def _two_loop(g, S, Y, rho, gamma):
    """L-BFGS two-loop recursion vectorized over lanes: g (k, n), history
    S, Y (m, k, n) newest last, rho (m, k) with 0 marking an empty slot
    (a no-op), gamma (k,). Returns the direction -H g."""
    m = S.shape[0]
    q = g
    alphas = []
    for i in range(m - 1, -1, -1):
        a = rho[i] * (S[i] * q).sum(dim=-1)
        q = q - a[:, None] * Y[i]
        alphas.append(a)
    r = gamma[:, None] * q
    for i in range(m):
        b = rho[i] * (Y[i] * r).sum(dim=-1)
        r = r + (alphas[m - 1 - i] - b)[:, None] * S[i]
    return -r


def minimize_lbfgs_batched(fun: Callable, x0s, max_iter: int = 200,
                           tol: float = 1e-8, memory_size: int = 10,
                           ls_max: int = 20, c1: float = 1e-4) -> LBFGSResult:
    """Batched multi-start L-BFGS with masked early exit.

    ``fun`` maps (k, n) -> (k,) (lanes independent, see the module
    docstring); ``x0s`` is (k, n), and the state stays in its dtype on its
    device. Each outer iteration: the two-loop direction (steepest descent
    where it is not a descent direction); backtracking line-search trials,
    each ONE value-only call of all k lanes, the next step minimizing the
    quadratic through f(0), f'(0) and f(alpha) clipped to [0.1, 0.7] alpha;
    a lane that passes Armijo (``c1``) leaves the trial mask; then ONE
    value+grad call at the accepted points. A pair (s, y) enters a lane's
    memory only if s.y > 1e-12 |s| |y|. A lane converges when its gradient
    norm falls below ``tol``; it fails (``ls_failed``) when its start is
    non-finite, its ``ls_max`` trials all fail, or its accepted point has a
    non-finite gradient. The loop ends when no lane is active or after
    ``max_iter`` iterations. Host syncs: one flag per outer iteration and
    one per trial.
    """
    k, n = x0s.shape
    m = memory_size
    new = lambda *shape: x0s.new_zeros(shape)
    x = x0s
    f, g = _value_and_grad(fun, x)
    gn = torch.linalg.vector_norm(g, dim=-1)
    # a lane that is non-finite at its start can never accept a step: it is
    # failed at once (gn >= tol is False for NaN and would read converged)
    finite0 = torch.isfinite(f) & torch.isfinite(gn)
    S, Y, rho = new(m, k, n), new(m, k, n), new(m, k)
    gamma = 1.0 / torch.maximum(gn, torch.ones_like(gn))
    active = finite0 & (gn >= tol)
    failed = ~finite0
    n_iter = torch.zeros(k, dtype=torch.int32, device=x0s.device)

    it = 0
    while it < max_iter and bool(active.any()):
        d = _two_loop(g, S, Y, rho, gamma)
        gd = (g * d).sum(dim=-1)
        bad = gd >= 0.0
        d = torch.where(bad[:, None], -g, d)
        gd = torch.where(bad, -(g * g).sum(dim=-1), gd)

        alpha = x0s.new_ones(k)
        f_last, f_new = f, f
        accepted = ~active
        trials = 0
        while trials < ls_max and bool((active & ~accepted).any()):
            denom = f_last - f - gd * alpha
            a_interp = -0.5 * gd * alpha * alpha / torch.where(
                denom > 0, denom, torch.ones_like(denom))
            a_next = torch.where(
                denom > 0,
                torch.minimum(torch.maximum(a_interp, 0.1 * alpha), 0.7 * alpha),
                0.5 * alpha)
            a_try = alpha if trials == 0 else torch.where(accepted, alpha, a_next)
            f_try = _value(fun, x + a_try[:, None] * d)
            ok = f_try <= f + c1 * a_try * gd
            take = active & ~accepted & ok
            alpha = torch.where(accepted, alpha, a_try)
            f_last = torch.where(accepted, f_last, f_try)
            f_new = torch.where(take, f_try, f_new)
            accepted = accepted | take | ~active
            trials += 1
        moved = active & accepted & (f_new < f)

        x_new = torch.where(moved[:, None], x + alpha[:, None] * d, x)
        f_acc, g_new = _value_and_grad(fun, x_new)
        f_acc = torch.where(moved, f_acc, f)
        g_new = torch.where(moved[:, None], g_new, g)

        s = x_new - x
        y = g_new - g
        sy = (s * y).sum(dim=-1)
        yy = (y * y).sum(dim=-1)
        good = moved & (sy > 1e-12 * torch.sqrt((s * s).sum(dim=-1) * yy))
        rho_new = torch.where(good, 1.0 / torch.where(good, sy, torch.ones_like(sy)),
                              torch.zeros_like(sy))
        # lanes with a rejected pair keep their old memory entirely
        S = torch.where(good[None, :, None], torch.cat([S[1:], s[None]]), S)
        Y = torch.where(good[None, :, None], torch.cat([Y[1:], y[None]]), Y)
        rho = torch.where(good[None, :], torch.cat([rho[1:], rho_new[None]]), rho)
        gamma = torch.where(good, sy / torch.clamp_min(yy, 1e-30), gamma)

        gn = torch.linalg.vector_norm(g_new, dim=-1)
        finite = torch.isfinite(gn)
        converged = moved & finite & (gn < tol)
        still = active & moved & finite & (gn >= tol)
        # leaving the active set other than by convergence is a failure
        failed = failed | (active & ~still & ~converged)
        n_iter = n_iter + active.to(torch.int32)
        x, f, g, active = x_new, f_acc, g_new, still
        it += 1

    return LBFGSResult(x=x, fun=f, grad_norm=torch.linalg.vector_norm(g, dim=-1),
                       n_iter=n_iter, ls_failed=failed)


def minimize_lbfgs_batched_host(fun: Callable, x0s, max_iter: int = 200,
                                tol: float = 1e-8, memory_size: int = 10,
                                ls_max: int = 20, c1: float = 1e-4,
                                eval_chunk: int | None = None) -> LBFGSResult:
    """:func:`minimize_lbfgs_batched` with the control flow and the state in
    float64 numpy on the host: the only device work is one batched
    value+grad and one batched value call per step, in the dtype and on the
    device of ``x0s``. One difference, kept from JAX's host form: a lane
    whose new pair fails the curvature guard still shifts its memory, the
    pair's slot left empty.

    ``eval_chunk`` evaluates the k lanes in chunks of that size (k padded
    up with repeated lanes), one objective call per chunk, to bound the
    working set of a memory-heavy objective.
    """
    dtype, device = x0s.dtype, x0s.device
    k, n = x0s.shape
    m = memory_size

    def chunked(fn, x):
        xt = torch.as_tensor(x, dtype=dtype, device=device)
        if eval_chunk is None or eval_chunk >= k:
            outs = [fn(xt)]
        else:
            pad = (-k) % eval_chunk
            xp = torch.cat([xt, xt[:pad]]) if pad else xt
            outs = [fn(xp[i:i + eval_chunk]) for i in range(0, xp.shape[0], eval_chunk)]
        return [np.asarray(torch.cat(cs)[:k].detach().cpu(), np.float64)
                for cs in zip(*outs)]

    fbatch = lambda x: chunked(lambda xt: (_value(fun, xt),), x)[0]
    vgbatch = lambda x: chunked(lambda xt: _value_and_grad(fun, xt), x)

    x = np.asarray(x0s.detach().cpu(), np.float64)
    f, g = vgbatch(x)
    gn = np.linalg.norm(g, axis=-1)
    finite0 = np.isfinite(f) & np.isfinite(gn)
    S = np.zeros((m, k, n))
    Y = np.zeros((m, k, n))
    rho = np.zeros((m, k))
    gamma = 1.0 / np.maximum(gn, 1.0)
    active = finite0 & (gn >= tol)
    failed = ~finite0
    n_iter = np.zeros((k,), np.int64)

    for _ in range(max_iter):
        if not active.any():
            break
        q = g.copy()
        alphas = []
        for i in range(m - 1, -1, -1):
            a = rho[i] * np.sum(S[i] * q, axis=-1)
            q -= a[:, None] * Y[i]
            alphas.append(a)
        d = gamma[:, None] * q
        for i in range(m):
            b = rho[i] * np.sum(Y[i] * d, axis=-1)
            d += (alphas[m - 1 - i] - b)[:, None] * S[i]
        d = -d
        gd = np.sum(g * d, axis=-1)
        bad = gd >= 0.0
        d[bad] = -g[bad]
        gd[bad] = -np.sum(g[bad] * g[bad], axis=-1)

        alpha = np.ones((k,))
        f_last = f.copy()
        accepted = ~active
        f_new = f.copy()
        trials = 0
        while (active & ~accepted).any() and trials < ls_max:
            denom = f_last - f - gd * alpha
            with np.errstate(invalid="ignore", divide="ignore"):
                a_interp = -0.5 * gd * alpha * alpha / np.where(denom > 0, denom, 1.0)
            a_next = np.where(denom > 0, np.clip(a_interp, 0.1 * alpha, 0.7 * alpha),
                              0.5 * alpha)
            a_try = alpha if trials == 0 else np.where(accepted, alpha, a_next)
            f_try = fbatch(x + a_try[:, None] * d)
            ok = f_try <= f + c1 * a_try * gd
            take = active & ~accepted & ok
            alpha = np.where(accepted, alpha, a_try)
            f_last = np.where(accepted, f_last, f_try)
            f_new = np.where(take, f_try, f_new)
            accepted = accepted | take
            trials += 1
        moved = active & accepted & (f_new < f)

        x_new = np.where(moved[:, None], x + alpha[:, None] * d, x)
        f_acc, g_new = vgbatch(x_new)
        f_acc = np.where(moved, f_acc, f)
        g_new = np.where(moved[:, None], g_new, g)

        s = x_new - x
        y = g_new - g
        sy = np.sum(s * y, axis=-1)
        yy = np.sum(y * y, axis=-1)
        good = moved & (sy > 1e-12 * np.sqrt(np.sum(s * s, axis=-1) * yy))
        # as JAX's host form: every lane's memory shifts, and a rejected pair
        # takes its slot as an empty one (rho = 0)
        S = np.concatenate([S[1:], s[None]])
        Y = np.concatenate([Y[1:], y[None]])
        rho_new = np.where(good, 1.0 / np.where(good, sy, 1.0), 0.0)
        rho = np.concatenate([rho[1:], rho_new[None]])
        gamma = np.where(good, sy / np.maximum(yy, 1e-30), gamma)

        gn = np.linalg.norm(g_new, axis=-1)
        converged = moved & np.isfinite(gn) & (gn < tol)
        still = active & moved & np.isfinite(gn) & (gn >= tol)
        failed = failed | (active & ~still & ~converged)
        n_iter += active.astype(np.int64)
        x, f, g, active = x_new, f_acc, g_new, still

    out = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return LBFGSResult(x=out(x), fun=out(f), grad_norm=out(np.linalg.norm(g, axis=-1)),
                       n_iter=torch.as_tensor(n_iter, dtype=torch.int32, device=device),
                       ls_failed=torch.as_tensor(failed, device=device))


def minimize_multi_start(fun: Callable, x0s, max_iter: int = 200,
                         tol: float = 1e-8,
                         method: str = "batched") -> LBFGSResult:
    """Multi-start minimization of the batched objective ``fun`` (k, n) ->
    (k,) from the starts ``x0s`` (k, n), by :func:`minimize_lbfgs_batched`:
    the reference's serial 64-start study (Fig 12) as one batched solve.
    Every field of the result has the leading k axis. Only
    ``method="batched"`` is ported; JAX's ``"zoom"`` (optax) is not."""
    if method != "batched":
        raise ValueError(f"method={method!r}: only 'batched' is ported")
    return minimize_lbfgs_batched(fun, x0s, max_iter=max_iter, tol=tol)


def minimize_scipy(value_and_grad_fn: Callable, x0: torch.Tensor,
                   method: str = "L-BFGS-B", callback=None, **kwargs):
    """scipy.optimize.minimize over ``value_and_grad_fn``, a function of one
    model (n,) -> (value, gradient (n,)) — the reference's host-loop
    workflow. Every evaluation gets a tensor of ``x0``'s dtype on its
    device; scipy works in float64 numpy. Returns scipy's result."""
    from scipy.optimize import minimize

    def scipy_fun(m):
        v, g = value_and_grad_fn(torch.as_tensor(m, dtype=x0.dtype, device=x0.device))
        return float(v), np.asarray(g.detach().cpu(), np.float64)

    return minimize(scipy_fun, np.asarray(x0.detach().cpu(), np.float64), jac=True,
                    method=method, callback=callback, **kwargs)
