"""Independent validation solvers and derivative checkers (host-side).

The port's own copy of waveform_ot_tpu.ops.validate (the port imports
nothing of the JAX package): NumPy/SciPy oracles by nature (scipy's
``linprog`` and ``lsq_linear`` run on the host). Numerical inverse-CDF
integration (OTlib.py:854-874), linear programming (OTlib.py:465-506), the
Monge two-pointer sweep (OTlib.py:395-452), the plan recovery by least
squares (OTlib.py:876-904) and central-difference gradient checkers
(OTlib.py:219-393). Test oracles, not production paths.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# alternative W solvers (oracles)
# ---------------------------------------------------------------------------


def _cdf_np(f):
    amp = f.sum()
    c = np.cumsum(f / amp)
    return c / c[-1]


def wasserstein_numint(f, xf, g, xg, npoints: int = 10000):
    """Brute-force W1/W2^2 via inverse-CDF sampling (OTlib.py:854-874)."""
    cf, cg = _cdf_np(f), _cdf_np(g)
    t = np.linspace(0.0, 1.0, npoints)
    dfx = np.diff(xf)
    IF = xf[0] + dfx @ (t[None, :] >= cf[:-1, None])
    dgx = np.diff(xg)
    IG = xg[0] + dgx @ (t[None, :] >= cg[:-1, None])
    diff = IF - IG
    delt = 1.0 / (npoints - 1)
    return float(np.sum(delt * np.abs(diff))), float(delt * diff @ diff)


def cost_matrix(xf, xg, p: int = 2):
    """Dense pairwise |dx|^p costs (vectorized; cf. OTlib.py:187-217)."""
    xf = np.asarray(xf, float)
    xg = np.asarray(xg, float)
    if xf.ndim == 1:
        d = np.abs(xf[:, None] - xg[None, :])
        return d if p == 1 else d * d
    l = xf[:, None, :] - xg[None, :, :]
    if p == 1:
        return np.abs(l).sum(-1)
    return (l * l).sum(-1)


def build_linprog(f, xf, g, xg, p: int = 2):
    """Equality-constrained LP data for exact OT (OTlib.py:187-217,454-463).

    Returns (c, A_eq, b_eq) for min c.x s.t. row/col marginal constraints.
    The (2n, n*m) constraint matrix is built vectorized, not with the
    reference's O(n^2) Python double loop.
    """
    fn = np.asarray(f, float) / np.sum(f)
    gn = np.asarray(g, float) / np.sum(g)
    n, m = len(fn), len(gn)
    d = cost_matrix(xf, xg, p)
    A_eq = np.zeros((n + m, n * m))
    for j in range(n):
        A_eq[j, j * m:(j + 1) * m] = 1.0
    for i in range(m):
        A_eq[n + i, i::m] = 1.0
    return d.ravel(), A_eq, np.concatenate([fn, gn])


def wasserstein_linprog(f, xf, g, xg, p: int = 2, maxiter: int = 5000):
    """Exact W_p^p by scipy linprog (reference Wasser_LinProg, OTlib.py:465)."""
    from scipy.optimize import linprog

    c, A_eq, b_eq = build_linprog(f, xf, g, xg, p)
    n = len(f) + len(g)
    out = linprog(c, A_eq=A_eq[: n - 1], b_eq=b_eq[: n - 1],
                  options={"maxiter": maxiter}, method="highs")
    if not out.success:
        raise RuntimeError(f"linprog failed: {out.message}")
    return float(c @ out.x)


def linprog_plan(f, xf, g, xg, p: int = 2, maxiter: int = 5000):
    """Optimal plan from the LP (reference returns H at OTlib.py:498)."""
    from scipy.optimize import linprog

    c, A_eq, b_eq = build_linprog(f, xf, g, xg, p)
    n = len(f) + len(g)
    out = linprog(c, A_eq=A_eq[: n - 1], b_eq=b_eq[: n - 1],
                  options={"maxiter": maxiter}, method="highs")
    if not out.success:
        raise RuntimeError(f"linprog failed: {out.message}")
    return out.x.reshape(len(f), len(g))


def find_plan_from_w(f, xf, g, xg, w, p: int = 2):
    """Recover a plan consistent with a known W via bounded least squares
    (reference wasser_find_optplan, OTlib.py:876-904)."""
    from scipy.optimize import lsq_linear

    c, A_eq, b_eq = build_linprog(f, xf, g, xg, p)
    A = np.vstack([A_eq, c])
    b = np.concatenate([b_eq, [w]])
    out = lsq_linear(A, b, bounds=(0.0, np.inf), method="bvls")
    if not out.success:
        return False, None
    return True, out.x.reshape(len(f), len(g))


def monge_1d(source, target):
    """Mike Snow's greedy two-pointer 1-D OT on [0, 1] (OTlib.py:398-452).

    Returns (mapping, W_2^2) for equal-length densities on the implicit
    regular grid i/(n-1).
    """
    f = np.asarray(source, float)
    g = np.asarray(target, float)
    f = f / f.sum()
    g = g / g.sum()
    m, n = len(f), len(g)
    mapping = np.zeros((m, n))
    c = 0.0
    i = j = 0
    while i < m and j < n:
        if g[j] == 0:
            j += 1
        elif f[i] == 0:
            i += 1
        else:
            move = min(f[i], g[j])
            c += (i / (m - 1) - j / (n - 1)) ** 2 * move
            mapping[i, j] = move
            f[i] -= move
            g[j] -= move
            if f[i] == 0 and g[j] == 0:
                i += 1
                j += 1
            elif f[i] == 0:
                i += 1
            else:
                j += 1
    return mapping, c


# ---------------------------------------------------------------------------
# derivative checkers
# ---------------------------------------------------------------------------


def central_difference(fn, x, eps: float = 1e-6):
    """Central-difference gradient of a scalar function of a 1-D array.

    The rebuild's version of the reference FD harness (_checkderiv family,
    OTlib.py:219-393; check_FDderiv, FingerprintLib.py:516-610).
    """
    x = np.asarray(x, float)
    out = np.zeros_like(x)
    for i in range(x.size):
        xp = x.copy()
        xm = x.copy()
        xp.flat[i] += eps
        xm.flat[i] -= eps
        out.flat[i] = (float(fn(xp)) - float(fn(xm))) / (2 * eps)
    return out


def check_grad(fn, grad_fn, x, eps: float = 1e-6, atol: float = 1e-7,
               rtol: float = 1e-5):
    """Assert analytic gradient matches central differences; returns both."""
    fd = central_difference(fn, x, eps)
    an = np.asarray(grad_fn(x), float)
    scale = np.maximum(np.abs(fd), np.abs(an)).max() + 1e-30
    err = np.abs(fd - an).max()
    if err > atol + rtol * scale:
        raise AssertionError(
            f"gradient mismatch: max|fd-analytic|={err:.3e} "
            f"(atol={atol}, rtol={rtol}, scale={scale:.3e})")
    return an, fd
