"""Double-Ricker wavelet (counterpart of waveform_ot_tpu.models.ricker)."""

from __future__ import annotations

import math

import numpy as np
import torch

from waveform_ot_torch.ops.fingerprint import linspace


def ricker(f, length: float = 0.128, dt: float = 0.001):
    """Single Ricker wavelet of frequency ``f`` (a tensor): (t, y)."""
    t = torch.as_tensor(np.arange(-length / 2, (length - dt) / 2, dt),
                        dtype=f.dtype, device=f.device)
    pift2 = (math.pi ** 2) * (t ** 2)
    a = 1.0 - 2.0 * pift2 * f ** 2
    b = torch.exp(-pift2 * f ** 2)
    return t, a * b


def ricker_wavelet(tpert, amp, f, trange=(-2.0, 2.0), length: float = 4.0,
                   dt: float = 4.0 / 128.0):
    """Double Ricker wavelet (t, w), differentiable in the tensors
    (tpert, amp, f): t = linspace(trange) + tpert."""
    freq = f * 25.0 * 4.0 / 128.0
    _, w = ricker(freq, length=length, dt=dt)
    wp = amp * torch.cat([w, w])
    lo = torch.tensor(trange[0], dtype=wp.dtype, device=wp.device)
    hi = torch.tensor(trange[1], dtype=wp.dtype, device=wp.device)
    return linspace(lo, hi, wp.shape[0]) + tpert, wp
