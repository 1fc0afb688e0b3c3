"""Per-trace fingerprint windows (counterpart of waveform_ot_tpu.inversion.windows)."""

from __future__ import annotations

import torch

from waveform_ot_torch.ops.fingerprint import Window


def build_windows(t, wave, pad: float = 0.3) -> Window:
    """Amplitude windows of traces ``wave`` (..., nt) on the shared axis t.

    u0/u1 have the batch shape ``wave.shape[:-1]``: the trace's range padded
    by ``pad`` of it on both sides. t0/t1 are scalars and tantheta is 1.
    """
    wmin = wave.amin(dim=-1)
    wmax = wave.amax(dim=-1)
    du = wmax - wmin
    return Window(t0=t.min(), t1=t.max(), u0=wmin - pad * du, u1=wmax + pad * du,
                  tantheta=torch.ones((), dtype=wave.dtype, device=wave.device))


def unit_amplitude_windows(win: Window) -> Window:
    """(0, 1)-amplitude windows, for amplitudes after the arctan transform."""
    return Window(t0=win.t0, t1=win.t1, u0=torch.zeros_like(win.u0),
                  u1=torch.ones_like(win.u1), tantheta=win.tantheta)
