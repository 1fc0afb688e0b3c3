"""Double-Ricker wavelet (counterpart of waveform_ot_tpu.models.ricker).

Batched over a leading axis of models where the JAX package used
``jax.vmap``: scalar (tpert, amp, f) give waveforms (nt,), parameters of
shape (k,) give (k, nt).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from waveform_ot_torch.models.gp_noise import correlated_noise
from waveform_ot_torch.ops.fingerprint import linspace


def ricker(f, length: float = 0.128, dt: float = 0.001, deriv: bool = False):
    """Single Ricker wavelet of frequency ``f`` (a tensor, () or (k,)):
    (t, y) and with ``deriv`` also dy/df; y has shape f.shape + t.shape."""
    t = torch.as_tensor(np.arange(-length / 2, (length - dt) / 2, dt),
                        dtype=f.dtype, device=f.device)
    f = f[..., None]
    pift2 = (math.pi ** 2) * (t ** 2)
    a = 1.0 - 2.0 * pift2 * f ** 2
    b = torch.exp(-pift2 * f ** 2)
    y = a * b
    if deriv:
        dw = b * (-4.0 * pift2 * f) + a * (-2.0 * pift2 * f * b)
        return t, y, dw
    return t, y


def _time_axis(trange, n: int, like: torch.Tensor) -> torch.Tensor:
    """jnp.linspace(trange[0], trange[1], n) on the device of ``like``."""
    lo = torch.tensor(trange[0], dtype=like.dtype, device=like.device)
    hi = torch.tensor(trange[1], dtype=like.dtype, device=like.device)
    return linspace(lo, hi, n)


def ricker_wavelet(tpert, amp, f, trange=(-2.0, 2.0), length: float = 4.0,
                   dt: float = 4.0 / 128.0, noise=None):
    """Double Ricker wavelet (t, w), differentiable in the tensors
    (tpert, amp, f), each () or (k,): t = linspace(trange) + tpert. ``noise``
    (nt,) or (k, nt), e.g. from :mod:`waveform_ot_torch.models.gp_noise`, is
    added to the wavelet (the reference's sigma_amp/sigma_cor options applied
    by the caller)."""
    freq = f * 25.0 * 4.0 / 128.0
    _, w = ricker(freq, length=length, dt=dt)
    wp = amp[..., None] * torch.cat([w, w], dim=-1)
    tp = _time_axis(trange, wp.shape[-1], wp)
    if noise is not None:
        wp = wp + noise
    return tp + tpert[..., None], wp


def ricker_wavelet_noisy(generator: torch.Generator | None, tpert, amp, f,
                         trange=(-2.0, 2.0), sigma_amp: float = 0.0,
                         sigma_cor: float = 0.0, length: float = 4.0,
                         dt: float = 4.0 / 128.0):
    """Double Ricker with the reference's noise options
    (ricker_util.py:73-80), for scalar tensors (tpert, amp, f): white noise
    scaled by sigma_amp * max|w| when sigma_cor == 0, else GP-correlated
    noise of standard deviation sigma_amp (:func:`correlated_noise`). The
    normals come from ``generator`` (on the tensors' device; None takes
    torch's default one), so the draws are not the JAX package's."""
    t, w = ricker_wavelet(tpert, amp, f, trange=trange, length=length, dt=dt)
    if sigma_amp == 0.0:
        return t, w
    if sigma_cor == 0.0:
        noise = sigma_amp * w.abs().max() * torch.randn(
            w.shape, generator=generator, dtype=w.dtype, device=w.device)
    else:
        noise = correlated_noise(generator, w.shape[-1], sigma_amp, sigma_cor,
                                 dtype=w.dtype, device=w.device)
    return t, w + noise


def ricker_wavelet_with_jacobian(tpert, amp, f, trange=(-2.0, 2.0),
                                 length: float = 4.0, dt: float = 4.0 / 128.0):
    """(t, w, dw/dm (3, nt)) for scalar (tpert, amp, f) with the reference's
    analytic jacobian conventions (ricker_util.py:82-87): row 0 is
    -gradient(w)/dt (the time offset, by central differences and one-sided
    ones at the ends, as np.gradient), row 1 w/amp, row 2
    amp * d(ricker)/df * 25*4/128."""
    freq = f * 25.0 * 4.0 / 128.0
    _, w, dwf = ricker(freq, length=length, dt=dt, deriv=True)
    ww = torch.cat([w, w])
    wp = amp * ww
    tp = _time_axis(trange, wp.shape[0], wp)
    h = tp[1] - tp[0]
    grad = torch.cat([(wp[1:2] - wp[0:1]) / h,
                      (wp[2:] - wp[:-2]) * 0.5 / h,
                      (wp[-1:] - wp[-2:-1]) / h])
    dwpd = torch.stack([-grad, ww, amp * torch.cat([dwf, dwf]) * 25.0 * 4.0 / 128.0])
    return tp + tpert, wp, dwpd
