"""Per-trace fingerprint windows (counterpart of waveform_ot_tpu.inversion.windows)."""

from __future__ import annotations

import torch

from waveform_ot_torch.ops.fingerprint import Window


def build_windows(t, wave, pad: float = 0.3, u0=None, u1=None,
                  tantheta: float = 1.0) -> Window:
    """Amplitude windows of traces ``wave`` (..., nt) on the shared axis t.

    u0/u1 have the batch shape ``wave.shape[:-1]``: the trace's range padded
    by ``pad`` of it on both sides, or the fixed limits ``u0``/``u1``
    broadcast over the batch where given. t0/t1 are scalars and tantheta a
    scalar in the traces' dtype.
    """
    wmin = wave.amin(dim=-1)
    wmax = wave.amax(dim=-1)
    du = wmax - wmin
    fixed = lambda v, like: torch.broadcast_to(
        torch.as_tensor(v, dtype=like.dtype, device=like.device), like.shape)
    u0a = wmin - pad * du if u0 is None else fixed(u0, wmin)
    u1a = wmax + pad * du if u1 is None else fixed(u1, wmax)
    return Window(t0=t.min(), t1=t.max(), u0=u0a, u1=u1a,
                  tantheta=torch.as_tensor(tantheta, dtype=wave.dtype, device=wave.device))


def unit_amplitude_windows(win: Window) -> Window:
    """(0, 1)-amplitude windows, for amplitudes after the arctan transform."""
    return Window(t0=win.t0, t1=win.t1, u0=torch.zeros_like(win.u0),
                  u1=torch.ones_like(win.u1), tantheta=win.tantheta)


def default_grid_dims(nt: int, factor: float = 1.3) -> tuple[int, int]:
    """(nu, ntg) defaults: Nu = int(1.3*nt), Ntg = nt
    (loc_cmt_util.py:441-444; ricker_util.py:239-240)."""
    return int(factor * nt), nt
