"""Entropically regularized optimal transport: Sinkhorn iterations
(counterpart of waveform_ot_tpu.ops.sinkhorn; the reference's Sinkhorn /
SinkhornAB and Sinkhorn_MS).

  sinkhorn_gaussian  kernel applications are Gaussian blurs on the grid
                     (zero padding, as scipy.ndimage.gaussian_filter(
                     mode='constant', truncate=32)), written as one product
                     with a band matrix per axis, so a step costs the same
                     whatever sigma is; returns (distance, v, w)
  sinkhorn_dense     dense Gibbs kernel exp(-cost/gamma)/max, two
                     matrix-vector products per step; (W^p estimate, plan)
  sinkhorn_log       log-domain stabilized variant (log-sum-exp)

The iterations are Python loops of a fixed count, a few launches per step:
no early stop, so the result is the reference's for the same count.

Precision: the blur runs in float64 whatever the input dtype, and TF32
(``torch.backends.cuda.matmul.allow_tf32``, ``cudnn.allow_tf32``) applies
only to float32, so neither switch can touch it; the dense products are
float64 in every reference flow.
"""

from __future__ import annotations

import torch

_EPS = 1e-300


def _gaussian_kernel_1d(sigma, device, truncate: float = 32.0) -> torch.Tensor:
    """Normalized float64 taps exp(-x^2 / (2 sigma^2)), x = -r..r with
    r = int(truncate * sigma + 0.5) (a single tap 1.0 when r is 0)."""
    radius = int(truncate * float(sigma) + 0.5)
    x = torch.arange(-radius, radius + 1, dtype=torch.float64, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _band(n: int, k: torch.Tensor) -> torch.Tensor:
    """(n, n) matrix of the zero-padded correlation with taps ``k`` along an
    axis of length n: out[i] = sum_s img[s] k[s - i + r] over |s - i| <= r,
    which is jnp.correlate(pad(img, r), k, 'valid')."""
    r = (k.shape[0] - 1) // 2
    i = torch.arange(n, device=k.device)
    d = i[None, :] - i[:, None]
    return torch.where(d.abs() <= r, k[(d + r).clamp(0, 2 * r)], 0.0)


def _bands(shape, k: torch.Tensor) -> list[torch.Tensor]:
    return [_band(n, k) for n in shape]


def _blur(image: torch.Tensor, bands: list[torch.Tensor]) -> torch.Tensor:
    """Separable zero-padded correlation of ``image`` along every axis, one
    float64 matrix product per axis with its band matrix (``_bands``)."""
    out = image.to(torch.float64)
    for axis, m in enumerate(bands):
        out = (out.movedim(axis, -1) @ m.T).movedim(-1, axis)
    return out.to(image.dtype)


def gaussian_filter(image: torch.Tensor, sigma, truncate: float = 32.0) -> torch.Tensor:
    """Separable Gaussian blur matching scipy.ndimage.gaussian_filter with
    mode='constant' (zero padding); sigma in pixels."""
    return _blur(image, _bands(image.shape, _gaussian_kernel_1d(sigma, image.device, truncate)))


def sinkhorn_gaussian(mu0, mu1, gamma: float = 0.005, iters: int = 250):
    """Gaussian-kernel entropic W2 between two grid densities of one shape
    (reference Sinkhorn): ``iters`` steps of v = mu0 / blur(w),
    w = mu1 / blur(v). Returns (distance, v, w)."""
    k = _bands(mu0.shape, _gaussian_kernel_1d(gamma, mu0.device))
    v, w = torch.ones_like(mu0), torch.ones_like(mu1)
    for _ in range(iters):
        v = mu0 / torch.clamp(_blur(w, k), min=_EPS)
        w = mu1 / torch.clamp(_blur(v, k), min=_EPS)
    logv = torch.log(torch.clamp(v, min=_EPS))
    logw = torch.log(torch.clamp(w, min=_EPS))
    return (mu0 * logv + mu1 * logw).sum() * gamma, v, w


def _pairwise_sq(fx, gx):
    d = fx[:, None, :] - gx[None, :, :]
    return (d * d).sum(dim=-1)


def _points(density):
    """(n,) normalized amplitudes and (n, dim) locations of a 1-D or 2-D
    density (unbatched)."""
    f = density.pdf.reshape(-1)
    return f, density.x.reshape(f.shape[0], -1)


def sinkhorn_dense(source, target, gamma: float = 5e-4, iters: int = 5001):
    """Dense-kernel Sinkhorn (reference Sinkhorn_MS) between Density1D or
    Density2D inputs. Returns (W^p estimate, plan); the plan's rows are
    the target (plan = diag(nu) K^T diag(mu)), and (mu, nu) are taken as the
    last step leaves them, as in the reference."""
    f, fx = _points(source)
    g, gx = _points(target)
    cost = _pairwise_sq(fx, gx)
    m = torch.exp(-cost / gamma)
    amp = m.max()
    m = m / amp
    src = (f / f.sum())[:, None]
    tgt = (g / g.sum())[:, None]
    mu = torch.ones_like(src)
    nu = torch.ones_like(tgt)
    for _ in range(iters):
        mu = src / (m @ nu)
        nu = tgt / (m.T @ mu)
    # diag(nu) @ M^T @ diag(mu) has one nonzero term per entry: the same
    # products, written elementwise
    pi = nu * m.T * mu.T
    return amp * (pi.T * cost).sum(), pi


def sinkhorn_log(source, target, gamma: float = 5e-4, iters: int = 500):
    """Log-domain stabilized Sinkhorn (log-sum-exp form). Returns
    (W^p estimate, plan (n_src, n_tgt))."""
    f, fx = _points(source)
    g, gx = _points(target)
    f = f / f.sum()
    g = g / g.sum()
    cost = _pairwise_sq(fx, gx)
    logf = torch.log(torch.clamp(f, min=_EPS))
    logg = torch.log(torch.clamp(g, min=_EPS))
    mc = -cost / gamma
    alpha, beta = torch.zeros_like(logf), torch.zeros_like(logg)
    for _ in range(iters):
        alpha = logf - torch.logsumexp(mc + beta[None, :], dim=1)
        beta = logg - torch.logsumexp(mc + alpha[:, None], dim=0)
    pi = torch.exp(alpha[:, None] + mc + beta[None, :])
    return (pi * cost).sum(), pi
