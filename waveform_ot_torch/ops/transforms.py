"""Amplitude transforms (counterpart of waveform_ot_tpu.ops.transforms)."""

from __future__ import annotations

import math

import torch


def arctan_transform(u, u0, u1, deriv: bool = False):
    """Squash amplitudes into (0, 1): un = 0.5 + arctan(((u-u0) + (u-u1)) / (u1-u0)) / pi.

    ``u0``/``u1`` broadcast against ``u`` (pass (nr, nc, 1) against
    (nr, nc, nt) for per-trace windows). With ``deriv=True`` also returns
    d(un)/du.
    """
    up = ((u - u0) + (u - u1)) / (u1 - u0)
    un = 0.5 + torch.atan(up) / math.pi
    if deriv:
        und = 2.0 / ((u1 - u0) * math.pi * (1.0 + up * up))
        return un, und
    return un
