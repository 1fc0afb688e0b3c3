"""Waveform -> fingerprint -> marginal-Wasserstein misfit pipelines.

Counterpart of waveform_ot_tpu.inversion.pipeline, batched over a leading
trace dimension: waveforms are (B, nt), windows hold () or (B,) tensors and
targets hold (B, n) marginals. Gradients are autograd through
:func:`trace_misfit`; :func:`calc_wasser_waveform` is the reference's
CalcWasserWaveform return contract on top of it.
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
    include_tant_in_dg: the origin-time derivative's convention: True divides
               by tantheta (t1 - t0), as the Ricker driver does
               (ricker_util.py:333); False by (t1 - t0) alone, as the loc/CMT
               driver does (loc_cmt_util.py:569)
    """

    nu: int
    ntg: int
    lambdav: float = 0.04
    q: int | None = None
    p: int = 2
    transform: bool = False
    include_tant_in_dg: bool = True

    @property
    def spec(self) -> FingerprintSpec:
        return FingerprintSpec(nu=self.nu, ntg=self.ntg)


class Targets(NamedTuple):
    """Observed-side marginals, (B, n) each, built once per inversion."""

    t: Density1D
    u: Density1D


def repeat_targets(targets: Targets, k: int) -> Targets:
    """The observed marginals (B, n) repeated for k models: (k*B, n),
    model-major, to pair with k models' flattened traces."""
    rep = lambda a: a.repeat(k, *([1] * (a.dim() - 1)))
    return Targets(*(Density1D(*(rep(a) for a in dens)) for dens in targets))


def as_model_batch(ms):
    """(k, nm) view of a model batch, and whether one model (nm,) was given."""
    return (ms[None], True) if ms.dim() == 1 else (ms, False)


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


def trace_misfit(t, w, win: Window, targets: Targets, cfg: TraceConfig,
                 tshift=0.0):
    """(W_t (B,), W_u (B,)) between the fingerprint marginals of waveforms
    ``w`` (B, nt) and the precomputed targets. Differentiable w.r.t. ``w``,
    ``t`` and the window; the gradient w.r.t. ``tshift`` (scalar or (B,))
    is the reference's normalized window-origin derivative."""
    pdf, (tg, ug) = build_fingerprint(t, w, win, cfg)
    return marg_wasserstein_value(pdf, tg, ug, targets.t, targets.u, p=cfg.p,
                                  tshift=tshift)


def dg_scale(win: Window, cfg: TraceConfig):
    """Normalized -> physical origin-time derivative factor: 1 / (tantheta
    (t1 - t0)) under ``cfg.include_tant_in_dg`` (ricker_util.py:333), else
    1 / (t1 - t0) (loc_cmt_util.py:569)."""
    scale = win.t1 - win.t0
    if cfg.include_tant_in_dg:
        scale = scale * win.tantheta
    return 1.0 / scale


def calc_wasser_waveform(t, w, win: Window, targets: Targets,
                         cfg: TraceConfig, deriv: bool = False,
                         returnmarg: bool = True):
    """The reference CalcWasserWaveform returns for waveforms ``w`` (B, nt),
    each field (B,) or (B, nt):

      returnmarg=True,  deriv=True:  ([Wt, Wu], [dWt/dw, dWu/dw], [dgt, dgu])
      returnmarg=False, deriv=True:  (Wavg, dWavg/dw, dgavg)
      deriv=False:                   [Wt, Wu] or Wavg

    ``w`` is the amplitude fed to the fingerprint: with the arctan transform,
    pass the transformed amplitudes and a (0, 1) window, as the reference
    does. One forward, then two backward passes over it (one per marginal).
    """
    cfg_notr = dataclasses.replace(cfg, transform=False)
    if not deriv:
        wt, wu = trace_misfit(t, w, win, targets, cfg_notr)
        return [wt, wu] if returnmarg else (wt + wu) / 2.0

    w = w.detach().requires_grad_(True)
    shift = w.new_zeros(w.shape[0], requires_grad=True)
    with torch.enable_grad():
        wt, wu = trace_misfit(t, w, win, targets, cfg_notr, tshift=shift)
        drt, dgt = torch.autograd.grad(wt.sum(), (w, shift), retain_graph=True)
        (dru,) = torch.autograd.grad(wu.sum(), w)
    wt, wu = wt.detach(), wu.detach()
    s = dg_scale(win, cfg)
    if returnmarg:
        return [wt, wu], [drt, dru], [dgt * s, torch.zeros_like(dgt)]
    return (wt + wu) / 2.0, (drt + dru) / 2.0, dgt * s / 2.0


def grid6_to_window(grid6, theta: float = 45.0, tantheta: float | None = None,
                    dtype=torch.float64, device="cuda"):
    """Reference 6-tuple (t0, t1, u0, u1, Nu, Nt) -> (Window on ``device``,
    FingerprintSpec); the window's angle is ``theta`` degrees, or its tangent
    ``tantheta`` where given."""
    t0, t1, u0, u1, nu, ntg = grid6
    win = make_window(t0, t1, u0, u1, theta=theta, tantheta=tantheta, dtype=dtype,
                      device=device)
    return win, FingerprintSpec(nu=int(nu), ntg=int(ntg))


def auto_grid6(t, wave, pad: float = 0.2, nu_factor: float = 1.3):
    """The reference's automatic window (BuildOTobjfromWaveform norm=True,
    ricker_util.py:233-240) of one waveform ``wave`` (nt,) on ``t``:
    amplitude limits padded by ``pad`` of the range, time limits from ``t``,
    Nu = int(nu_factor * nt), Ntg = nt. A host-side tuple of Python numbers."""
    wmin, wmax = float(wave.min()), float(wave.max())
    du = wmax - wmin
    n = wave.shape[-1]
    return (float(t.min()), float(t.max()), wmin - pad * du, wmax + pad * du,
            int(nu_factor * n), n)
