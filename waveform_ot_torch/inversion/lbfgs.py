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
  * :func:`minimize_lbfgs` and ``minimize_multi_start(method="zoom")`` —
    JAX's on-device L-BFGS (optax 0.2.6's ``lbfgs``: ``scale_by_lbfgs`` with
    the capped reciprocal gradient norm as the first step's scale, and
    ``scale_by_zoom_linesearch`` with its defaults, 20 steps and initial
    guess one), reproduced lane for lane by one masked, batched engine
    (:func:`_zoom_lbfgs`) where JAX vmaps one lane's solve. Each zoom trial
    is one value+grad call of all lanes; finished lanes are frozen.
  * :func:`minimize_multi_start` — the 64-start study's entry point.
  * :func:`minimize_multi_start_sharded` — the starts split over a mesh,
    :func:`minimize_lbfgs_batched` on each shard's starts.
  * :func:`minimize_scipy` — scipy L-BFGS-B over a (value, grad) function.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_map


class LBFGSResult(NamedTuple):
    """Per-lane result of a batched solve; every field has the leading k axis
    (:func:`minimize_lbfgs` gives one lane without it).

    ``ls_failed`` (batched solvers only) marks lanes frozen because the
    backtracking line search exhausted its trials without an acceptable step
    (e.g. the objective is non-finite around the iterate), or whose start or
    accepted point was non-finite: they did NOT converge to tol. The zoom
    solver never freezes a lane for that, and leaves it None, as JAX's does.
    """

    x: torch.Tensor
    fun: torch.Tensor
    grad_norm: torch.Tensor
    n_iter: torch.Tensor
    ls_failed: torch.Tensor | None = None


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


# optax 0.2.6 scale_by_zoom_linesearch defaults (linesearch.py:1331), as
# optax.lbfgs sets them (alias.py:2591): 20 steps, initial guess one
ZOOM_STEPS = 20
ZOOM_INCREASE = 2.0
ZOOM_SLOPE_RTOL = 1e-4
ZOOM_CURV_RTOL = 0.9
ZOOM_APPROX_DEC_RTOL = 1e-6
ZOOM_INTERVAL = 1e-5


def _vdot(a, b):
    return (a * b).sum(dim=-1)


def _where(mask, a, b):
    """torch.where with a lane mask (k,) over lane-major a, b: (k,) or (k, n)."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (optax's _cubicmin); NaN where there is none."""
    db, dc = b - a, c - a
    e1, e2 = fb - fa - fpa * db, fc - fa - fpa * dc
    p = db * dc
    denom = p * p * (db - dc)
    A = (dc * dc * e1 + -(db * db) * e2) / denom
    B = (-(dc * (dc * dc)) * e1 + db * (db * db) * e2) / denom
    return a + (-B + torch.sqrt(B * B - 3.0 * A * fpa)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (optax's _quadmin)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


def _decrease_error(step, value, slope, value_init, slope_init):
    """optax's sufficient-decrease error, with the approximate (Hager-Zhang)
    criterion; NaN reads as inf."""
    dec = value - value_init - ZOOM_SLOPE_RTOL * step * slope_init
    approx = torch.maximum(slope - (2 * ZOOM_SLOPE_RTOL - 1.0) * slope_init,
                           value - value_init - ZOOM_APPROX_DEC_RTOL * value_init.abs())
    dec = torch.clamp_min(torch.minimum(approx, dec), 0.0)
    return torch.where(torch.isnan(dec), torch.inf, dec)


def _curvature_error(slope, slope_init):
    curv = torch.clamp_min(slope.abs() - ZOOM_CURV_RTOL * slope_init.abs(), 0.0)
    return torch.where(torch.isnan(curv), torch.inf, curv)


def _zoom_linesearch(fun, x, d, value, grad, searching):
    """optax's zoom line search (Nocedal-Wright 3.5/3.6 with Hager-Zhang's
    approximate decrease) along ``d`` from ``x`` for every lane in
    ``searching`` at once: each trial is ONE value+grad call of all k lanes
    (lanes not searching are evaluated at ``x`` and left as they are), and
    the loop's condition is one flag read from the device per trial. A lane
    whose search fails takes its safe step (sufficient decrease) when it has
    one or when its last trial was non-finite, as optax's _try_safe_step.
    Returns (stepsize, value, grad) per lane."""
    zero = torch.zeros_like(value)
    slope = _vdot(d, grad)
    st = dict(step=zero, value=value, grad=grad, slope=slope, found=torch.zeros_like(searching),
              low=zero, v_low=value, s_low=slope, high=zero, v_high=value, s_high=slope,
              cref=zero, v_cref=value, safe=zero, v_safe=value, g_safe=grad)
    count = 0
    while bool(searching.any()):
        # the search phase's next trial, and the zoom phase's
        grow = torch.full_like(value, 1.0) if count == 0 else ZOOM_INCREASE * st["step"]
        low, high = st["low"], st["high"]
        delta = (high - low).abs()
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        mc = _cubicmin(low, st["v_low"], st["s_low"], high, st["v_high"], st["cref"],
                       st["v_cref"])
        use_cubic = (mc > left + 0.2 * delta) & (mc < right - 0.2 * delta)
        mq = _quadmin(low, st["v_low"], st["s_low"], high, st["v_high"])
        use_quad = ~use_cubic & (mq > left + 0.1 * delta) & (mq < right - 0.1 * delta)
        middle = torch.where(use_cubic, mc, st["cref"])
        middle = torch.where(use_quad, mq, middle)
        middle = torch.where(~use_cubic & ~use_quad, (low + high) / 2.0, middle)
        trial = torch.where(st["found"], middle, grow)

        v, g = _value_and_grad(fun, _where(searching, x + trial[:, None] * d, x))
        s = _vdot(g, d)
        dec = _decrease_error(trial, v, s, value, slope)
        err = torch.maximum(dec, _curvature_error(s, slope))
        done = err <= 0.0
        last = count + 1 >= ZOOM_STEPS

        # search phase (Algorithm 3.5)
        ok = dec <= 0.0
        safe_s = torch.where(ok, trial, st["safe"])
        v_safe_s = torch.where(ok, v, st["v_safe"])
        g_safe_s = _where(ok, g, st["g_safe"])
        hi_new = (dec > 0.0) | ((v >= st["value"]) & (count > 0))
        lo_new = (s >= 0.0) & ~hi_new
        low_s = torch.where(lo_new, trial, st["step"])
        v_low_s = torch.where(lo_new, v, st["value"])
        s_low_s = torch.where(lo_new, s, st["slope"])
        high_s = torch.where(lo_new, st["step"], trial)
        v_high_s = torch.where(lo_new, st["value"], v)
        s_high_s = torch.where(lo_new, st["slope"], s)
        found_s = hi_new | lo_new | done

        # zoom phase (Algorithm 3.6)
        better = ok & (v < st["v_safe"])
        safe_z = torch.where(better, trial, st["safe"])
        v_safe_z = torch.where(better, v, st["v_safe"])
        g_safe_z = _where(better, g, st["g_safe"])
        hi_mid = (dec > 0.0) | (v >= st["v_low"])
        hi_low = (s * (high - low) >= 0.0) & ~hi_mid
        high_z = torch.where(hi_low, low, torch.where(hi_mid, trial, high))
        v_high_z = torch.where(hi_low, st["v_low"], torch.where(hi_mid, v, st["v_high"]))
        s_high_z = torch.where(hi_low, st["s_low"], torch.where(hi_mid, s, st["s_high"]))
        low_z = torch.where(hi_mid, low, trial)
        v_low_z = torch.where(hi_mid, st["v_low"], v)
        s_low_z = torch.where(hi_mid, st["s_low"], s)
        moved_high = hi_mid | hi_low
        cref_z = torch.where(moved_high, high, low)
        v_cref_z = torch.where(moved_high, st["v_high"], st["v_low"])
        failed_z = (last | ((delta <= ZOOM_INTERVAL) & (safe_z > 0.0))) & ~done

        z = st["found"]
        pick = lambda a_z, a_s: _where(z, a_z, a_s)
        new = dict(step=trial, value=v, grad=g, slope=s, found=z | found_s,
                   low=pick(low_z, low_s), v_low=pick(v_low_z, v_low_s),
                   s_low=pick(s_low_z, s_low_s), high=pick(high_z, high_s),
                   v_high=pick(v_high_z, v_high_s), s_high=pick(s_high_z, s_high_s),
                   cref=pick(cref_z, low_s), v_cref=pick(v_cref_z, v_low_s),
                   safe=pick(safe_z, safe_s), v_safe=pick(v_safe_z, v_safe_s),
                   g_safe=pick(g_safe_z, g_safe_s))
        failed = torch.where(z, failed_z, last & ~done)
        # _try_safe_step
        use_safe = failed & ((new["safe"] > 0.0) | torch.isinf(dec))
        for key, src in (("step", "safe"), ("value", "v_safe"), ("grad", "g_safe")):
            new[key] = _where(use_safe, new[src], new[key])
        st = {key: _where(searching, val, st[key]) for key, val in new.items()}
        searching = searching & ~(done | failed)
        count += 1
    return st["step"], st["value"], st["grad"]


def _zoom_lbfgs(fun: Callable, x0s, max_iter: int, tol: float,
                memory_size: int) -> LBFGSResult:
    """JAX's ``jax.vmap(minimize_lbfgs)`` lane for lane, on the batched
    objective ``fun`` (k, n) -> (k,). A lane runs while its step count is 0
    or (below ``max_iter`` and its gradient norm at least ``tol``), JAX's
    ``cond``; the condition is one flag read from the device per iteration.
    Each iteration: the value and gradient of the last accepted trial (one
    value+grad call where one is not finite, as optax's
    value_and_grad_from_state); the L-BFGS memory update and two-loop
    direction of optax's scale_by_lbfgs, newest pair written at slot
    (count - 1) mod m; the zoom line search. ``fun`` of the result is the
    line search's value at x, which is fun(x)."""
    k, n = x0s.shape
    m = memory_size
    x = x0s
    prev_x, prev_g = torch.zeros_like(x), torch.zeros_like(x)
    S, Y, rho = x.new_zeros(m, k, n), x.new_zeros(m, k, n), x.new_zeros(m, k)
    f_ls, g_ls = torch.full_like(x[:, 0], torch.inf), torch.zeros_like(x)
    active = torch.ones(k, dtype=torch.bool, device=x.device)
    n_iter = torch.zeros(k, dtype=torch.int32, device=x.device)
    it = 0
    while True:
        if it > 0:
            active = active & (torch.linalg.vector_norm(g_ls, dim=-1) >= tol) & (it < max_iter)
        need = active & ~torch.isfinite(f_ls)
        any_active, any_need = torch.stack([active.any(), need.any()]).tolist()
        if not any_active:
            break
        value, grad = f_ls, g_ls
        if any_need:
            v, g = _value_and_grad(fun, x)
            value, grad = torch.where(need, v, value), _where(need, g, grad)

        # scale_by_lbfgs: memory update, then the two-loop product
        mi, prev = it % m, (it - 1) % m
        if it > 0:
            dx, dg = x - prev_x, grad - prev_g
            sy = _vdot(dg, dx)
            w = torch.where(sy == 0.0, 0.0, 1.0 / sy)
            dd = _vdot(dg, dg)
            scale = torch.where(dd > 0.0, sy / dd, 1.0)
        else:
            dx, dg, w = torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(value)
            scale = torch.clamp_max(1.0 / torch.linalg.vector_norm(grad, dim=-1), 1.0)
        S[prev] = _where(active, dx, S[prev])
        Y[prev] = _where(active, dg, Y[prev])
        rho[prev] = torch.where(active, w, rho[prev])
        order = [(mi + j) % m for j in range(m)]
        q, alphas = grad, {}
        for i in reversed(order):
            alphas[i] = rho[i] * _vdot(S[i], q)
            q = q + (-alphas[i])[:, None] * Y[i]
        r = scale[:, None] * q
        for i in order:
            r = r + (alphas[i] - rho[i] * _vdot(Y[i], r))[:, None] * S[i]
        d = -1.0 * r

        step, f_new, g_new = _zoom_linesearch(fun, x, d, value, grad, active)
        prev_x = _where(active, x, prev_x)
        prev_g = _where(active, grad, prev_g)
        x = _where(active, x + step[:, None] * d, x)
        f_ls = torch.where(active, f_new, f_ls)
        g_ls = _where(active, g_new, g_ls)
        n_iter = n_iter + active.to(torch.int32)
        it += 1
    return LBFGSResult(x=x, fun=f_ls, grad_norm=torch.linalg.vector_norm(g_ls, dim=-1),
                       n_iter=n_iter)


def minimize_lbfgs(fun: Callable, x0, max_iter: int = 200, tol: float = 1e-8,
                   memory_size: int = 10) -> LBFGSResult:
    """Minimize from one start ``x0`` (n,) by JAX's on-device L-BFGS (optax's
    lbfgs with the zoom line search); ``fun`` is the port's batched objective
    (k, n) -> (k,), called here with k = 1. Ends when the gradient norm
    falls below ``tol`` or after ``max_iter`` steps. The result's fields
    carry no lane axis."""
    res = _zoom_lbfgs(fun, x0[None], max_iter, tol, memory_size)
    return LBFGSResult(*(a[0] for a in res[:4]))


def minimize_multi_start(fun: Callable, x0s, max_iter: int = 200,
                         tol: float = 1e-8,
                         method: str = "batched") -> LBFGSResult:
    """Multi-start minimization of the batched objective ``fun`` (k, n) ->
    (k,) from the starts ``x0s`` (k, n): the reference's serial 64-start
    study (Fig 12) as one batched solve. Every field of the result has the
    leading k axis.

    method='batched' (default): :func:`minimize_lbfgs_batched`, masked early
    exit and value-only backtracking.
    method='zoom': :func:`minimize_lbfgs` on every start at once (optax's
    zoom line search, lane for lane JAX's vmap of it), the strong-Wolfe
    cross-check; ``ls_failed`` is None.
    """
    if method == "batched":
        return minimize_lbfgs_batched(fun, x0s, max_iter=max_iter, tol=tol)
    if method == "zoom":
        return _zoom_lbfgs(fun, x0s, max_iter, tol, memory_size=10)
    raise ValueError(f"unknown method {method!r}: 'batched' or 'zoom'")


def minimize_multi_start_sharded(fun: Callable, x0s, mesh, axis_name: str = "batch",
                                 max_iter: int = 200, tol: float = 1e-8):
    """Multi-start over a mesh: the starts ``x0s`` (k, n) split over the
    shards (the mesh size must divide k), and each shard runs
    :func:`minimize_lbfgs_batched` on its starts with its own early exit, so
    a shard whose lanes converge stops without waiting for the slowest lane
    of the study. No communication. Returns a
    :class:`waveform_ot_torch.parallel.Sharded` of per-shard
    :class:`LBFGSResult` (``.gather()`` gives one LBFGSResult of k lanes on
    the lead device).

    ``fun`` (batched, as everywhere here) must evaluate on its shard's
    device: an nn.Module such as
    :class:`waveform_ot_torch.inversion.LocCMTObjective` is copied to each
    distinct device; a function must follow the device of ``x``. The solver
    reads a flag from the device every iteration and every line-search
    trial, so each distinct device gets its own host thread, in which the
    shards on that device run one after another.
    """
    from waveform_ot_torch.parallel.mesh import Sharded, _split_leading, replicate

    mesh.require_1d(axis_name, "minimize_multi_start_sharded")
    xs = _split_leading(x0s, mesh, axis_name, "minimize_multi_start_sharded")
    funs = replicate(fun, mesh)
    solve = lambda i: minimize_lbfgs_batched(funs.parts[i], xs.parts[i], max_iter=max_iter,
                                             tol=tol)
    by_device = [[i for i in range(mesh.size) if mesh.devices[i] == d] for d in mesh.distinct]
    results = [None] * mesh.size
    with ThreadPoolExecutor(len(by_device)) as pool:
        runs = [(shards, pool.submit(lambda s: [solve(i) for i in s], shards))
                for shards in by_device]
        for shards, run in runs:
            for i, res in zip(shards, run.result()):
                results[i] = res
    axes = tree_map(lambda a: 0 if isinstance(a, torch.Tensor) else None, results[0])
    return Sharded(mesh, tuple(results), axes, axis_name)


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
