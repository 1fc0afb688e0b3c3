"""Gaussian-process correlated noise (counterpart of
waveform_ot_tpu.models.gp_noise; the reference's myGP).

The covariance is one broadcast, and a draw is the Cholesky transform L z of
standard normals z from an explicit ``torch.Generator``. PyTorch's random
streams are not JAX's: for the same seed a curve drawn here differs from
the JAX package's (which keys ``jax.random``); given the same z, the two
agree (tests/test_torch_ot.py).
"""

from __future__ import annotations

import math

import torch

from waveform_ot_torch.ops.fingerprint import linspace


def sq_exp(x, xp, s1, rho):
    return (s1 ** 2) * torch.exp(-((x - xp) ** 2) / (2.0 * rho ** 2))


def matern0(x, xp, s1, rho):
    return (s1 ** 2) * torch.exp(-torch.abs(x - xp) / rho)


def matern1(x, xp, s1, rho):
    r = torch.abs(x - xp) / rho
    return (s1 ** 2) * (1.0 + math.sqrt(3.0) * r) * torch.exp(-math.sqrt(3.0) * r)


def matern2(x, xp, s1, rho):
    r = torch.abs(x - xp) / rho
    return (s1 ** 2) * (1.0 + math.sqrt(5.0) * r + 5.0 * r ** 2 / 3.0) \
        * torch.exp(-math.sqrt(5.0) * r)


def periodic(x, xp, s1, rho, period=1.0):
    return (s1 ** 2) * torch.exp(
        -2.0 * torch.sin(torch.abs(x - xp) * math.pi / period) ** 2 / rho ** 2)


KERNELS = {"sqExp": sq_exp, "matern0": matern0, "matern1": matern1,
           "matern2": matern2, "periodic": periodic}


def covariance(xx, kernel=sq_exp, s1: float = 0.2, rho: float = 0.2):
    """Dense covariance matrix K[i, j] = k(x_i, x_j)."""
    return kernel(xx[:, None], xx[None, :], s1, rho)


def _axis(lo, hi, n, dtype, device):
    arr = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return linspace(arr(lo), arr(hi), n)


def create_curve(generator: torch.Generator | None = None, nx: int = 250,
                 x0=(-3.0, 3.0), corr: float = 0.2, s1: float = 0.2,
                 kernel=sq_exp, jitter: float | None = None,
                 dtype=torch.float64, device="cuda"):
    """Draw one GP curve (reference Createcurve): (x, y) with
    x = linspace(x0) and y ~ N(0, K) on the internal (-1, 1) grid.

    ``generator`` (on ``device``) supplies the nx standard normals; None
    takes torch's default one. ``jitter`` on K's diagonal defaults per
    dtype (1e-10 float64, 1e-5 float32): the squared-exponential K is
    numerically rank-deficient, and the float32 Cholesky needs more.
    """
    xx = _axis(-1.0, 1.0, nx, dtype, device)
    k = covariance(xx, kernel=kernel, s1=s1, rho=corr)
    if jitter is None:
        jitter = 1e-10 if dtype == torch.float64 else 1e-5
    chol = torch.linalg.cholesky(k + jitter * torch.eye(nx, dtype=dtype, device=device))
    z = torch.randn(nx, generator=generator, dtype=dtype, device=device)
    return _axis(x0[0], x0[1], nx, dtype, device), chol @ z


def correlated_noise(generator: torch.Generator | None, n: int, sigma_amp: float,
                     corr: float, dtype=torch.float64, device="cuda"):
    """GP noise of n samples scaled to standard deviation sigma_amp
    (ricker_util.py:76-78; the population standard deviation)."""
    _, y = create_curve(generator, nx=n, corr=corr, dtype=dtype, device=device)
    return y * sigma_amp / y.std(correction=0)


# -- reference-name surface (myGP.py) ---------------------------------------

sqExp = sq_exp  # reference camelCase name (myGP.py:7)


def Createcurve(plotyn, nx: int = 250, x0=(-3.0, 3.0), corr: float = 0.2,
                device="cuda"):
    """Reference-signature GP curve draw (myGP.py:18-64), from a generator
    seeded with the reference's diagnostic seed 1726151. ``plotyn`` draws
    the reference's three diagnostic panels (needs matplotlib) and closes
    the figure, as the JAX package does."""
    gen = torch.Generator(device=device).manual_seed(1726151)
    x, y = create_curve(gen, nx=nx, x0=tuple(x0), corr=corr, device=device)
    if plotyn:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        xx = _axis(-1.0, 1.0, nx, torch.float64, "cpu")
        fig, axs = plt.subplots(1, 3, figsize=(15, 4))
        axs[0].plot(xx.numpy(), sq_exp(xx, 0.0, 0.2, corr).numpy())
        axs[0].set_title("covariance function")
        axs[1].imshow(covariance(xx, rho=corr).numpy(), cmap="cubehelix")
        axs[1].set_title("covariance matrix")
        axs[2].plot(x.cpu().numpy(), y.cpu().numpy())
        axs[2].set_title("A Gaussian Process")
        plt.close(fig)
    return x, y
