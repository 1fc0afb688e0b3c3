"""Waveform -> fingerprint -> marginal-Wasserstein misfit pipelines.

Counterpart of waveform_ot_tpu.inversion.pipeline, batched over a leading
trace dimension: waveforms are (B, nt), windows hold () or (B,) tensors and
targets hold (B, n) marginals. Gradients are autograd through
:func:`trace_misfit`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from waveform_ot_torch.ops.fingerprint import (
    FingerprintSpec, Window, fingerprint_density, make_window,
)
from waveform_ot_torch.ops.marginal import marg_wasserstein_value
from waveform_ot_torch.ops.otpdf import Density1D, make_density_1d, marginals_raw
from waveform_ot_torch.ops.transforms import arctan_transform


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Static pipeline configuration (see waveform_ot_tpu.inversion.TraceConfig).

    nu, ntg:   fingerprint grid dims
    lambdav:   density length scale
    q:         density exponent (None -> exp(-|d|/lam), 2 -> exp(-d^2/lam))
    p:         Wasserstein order (1 or 2)
    transform: arctan amplitude squash before fingerprinting
    """

    nu: int
    ntg: int
    lambdav: float = 0.04
    q: int | None = None
    p: int = 2
    transform: bool = False

    @property
    def spec(self) -> FingerprintSpec:
        return FingerprintSpec(nu=self.nu, ntg=self.ntg)


class Targets(NamedTuple):
    """Observed-side marginals, (B, n) each, built once per inversion."""

    t: Density1D
    u: Density1D


def apply_transform(w, win: Window, cfg: TraceConfig):
    """Optionally arctan-squash amplitudes; the window becomes (0, 1)."""
    if not cfg.transform:
        return w, win
    wn = arctan_transform(w, win.u0[..., None], win.u1[..., None])
    win01 = Window(win.t0, win.t1, torch.zeros_like(win.u0),
                   torch.ones_like(win.u1), win.tantheta)
    return wn, win01


def build_fingerprint(t, w, win: Window, cfg: TraceConfig):
    """Waveforms (B, nt) -> (pdf2d (B, nu, ntg), (tgrid, ugrid))."""
    wn, win_used = apply_transform(w, win, cfg)
    return fingerprint_density(t, wn, win_used, cfg.spec, lambdav=cfg.lambdav,
                               q=cfg.q)


def build_target(t, w, win: Window, cfg: TraceConfig) -> Targets:
    """Observed-side marginals of waveforms (B, nt), computed once."""
    pdf, (tg, ug) = build_fingerprint(t, w, win, cfg)
    ft, fu = marginals_raw(pdf)
    return Targets(t=make_density_1d(ft, tg), u=make_density_1d(fu, ug))


def trace_misfit(t, w, win: Window, targets: Targets, cfg: TraceConfig):
    """(W_t (B,), W_u (B,)) between the fingerprint marginals of waveforms
    ``w`` (B, nt) and the precomputed targets. Differentiable w.r.t. ``w``,
    ``t`` and the window."""
    pdf, (tg, ug) = build_fingerprint(t, w, win, cfg)
    return marg_wasserstein_value(pdf, tg, ug, targets.t, targets.u, p=cfg.p)


def grid6_to_window(grid6, dtype=torch.float64, device="cuda"):
    """Reference 6-tuple (t0, t1, u0, u1, Nu, Nt) -> (45-degree Window on
    ``device``, FingerprintSpec)."""
    t0, t1, u0, u1, nu, ntg = grid6
    win = make_window(t0, t1, u0, u1, theta=45.0, dtype=dtype, device=device)
    return win, FingerprintSpec(nu=int(nu), ntg=int(ntg))
