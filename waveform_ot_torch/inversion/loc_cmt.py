"""Source-location / moment-tensor objectives, batched over all traces.

Counterpart of waveform_ot_tpu.inversion.loc_cmt. The (nr, 3) traces are
flattened to one batch of nr*3 in the order of the JAX module; the gradient
w.r.t. the model is one autograd pass through forward physics, arctan
transform, fingerprint (CUDA kernel on the card), marginal OT and the sum
over traces.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from waveform_ot_torch._tree import TensorTreeModule
from waveform_ot_torch.inversion.pipeline import (
    Targets, TraceConfig, build_target, trace_misfit,
)
from waveform_ot_torch.inversion.windows import (
    build_windows, unit_amplitude_windows,
)
from waveform_ot_torch.models.seismo import (
    MediumConfig, StationSet, mxyz_from_upper, synthetic_seismograms,
)
from waveform_ot_torch.ops.fingerprint import Window
from waveform_ot_torch.ops.transforms import arctan_transform


@dataclasses.dataclass(frozen=True)
class InvOptions:
    """Static inversion switches (the reference's ``invopt``)."""

    loc: bool = True
    cmt: bool = False
    mistype: str = "OT"      # 'OT' | 'L2'
    wopt: str = "Wavg"       # 'Wavg' | 'Wt' | 'Wu'
    precon: bool = False
    zmin: float = 0.001


class LocCMTProblem(NamedTuple):
    """Problem data (the reference's ``optdata``), tensors on one device."""

    t: torch.Tensor              # (nt,) time axis
    seis_obs: torch.Tensor       # (nr, 3, nt) observed seismograms
    windows: Window              # per-trace raw-amplitude windows (nr, 3)
    targets: Targets             # observed marginals (nr*3, n)
    stations: StationSet
    medium: MediumConfig
    mref: torch.Tensor           # (3,) fixed location when loc=False
    mscal: torch.Tensor          # parameter preconditioner
    mxyz_fixed: torch.Tensor     # (3,3) moment tensor when cmt=False
    fc: torch.Tensor             # source pulse corner frequency


def _clamp_depth_straight_through(z, zmin):
    """Value max(z, zmin) with gradient 1 everywhere."""
    return z - (z - torch.clamp_min(z, zmin)).detach()


def _flat_unit_windows(windows: Window, nr: int, nc: int) -> Window:
    """(0, 1) windows with every field broadcast to the flat (nr*nc,) batch."""
    win01 = unit_amplitude_windows(windows)
    return Window(*(torch.broadcast_to(a, (nr, nc)).reshape(nr * nc)
                    for a in win01))


def build_loc_cmt_problem(t, seis_obs, stations: StationSet, cfg: TraceConfig,
                          mref=None, mscal=None, mxyz_fixed=None,
                          medium: MediumConfig | None = None, fc=0.08,
                          pad: float = 0.3) -> LocCMTProblem:
    """Windows and observed-side fingerprint marginals, computed once on the
    device of ``seis_obs``."""
    nr, nc, nt = seis_obs.shape
    dtype, device = seis_obs.dtype, seis_obs.device
    windows = build_windows(t, seis_obs, pad=pad)
    un_obs = arctan_transform(seis_obs, windows.u0[..., None],
                              windows.u1[..., None])
    cfg_fp = dataclasses.replace(cfg, transform=False)
    with torch.no_grad():
        targets = build_target(t, un_obs.reshape(nr * nc, nt),
                               _flat_unit_windows(windows, nr, nc), cfg_fp)
    if medium is None:
        medium = MediumConfig.default(dtype, device)
    kw = dict(dtype=dtype, device=device)
    arr = lambda v, default: torch.as_tensor(default if v is None else v, **kw)
    return LocCMTProblem(
        t=t, seis_obs=seis_obs, windows=windows, targets=targets,
        stations=stations, medium=medium, mref=arr(mref, torch.zeros(3)),
        mscal=arr(mscal, torch.ones(1)), mxyz_fixed=arr(mxyz_fixed, torch.eye(3)),
        fc=arr(fc, None))


def _model_to_physics(m, prob: LocCMTProblem, opts: InvOptions):
    """m -> (x, y, z, Mxyz) with preconditioning, depth floor and layout."""
    if opts.precon:
        m = m * prob.mscal
    if opts.loc:
        x, y, z = m[0], m[1], m[2]
    else:
        x, y, z = prob.mref[0], prob.mref[1], prob.mref[2]
    z = _clamp_depth_straight_through(z, opts.zmin)
    if opts.cmt:
        mxyz = mxyz_from_upper(m[3:] if opts.loc else m)
    else:
        mxyz = prob.mxyz_fixed
    return x, y, z, mxyz


def predicted_seismograms(m, prob: LocCMTProblem, opts: InvOptions):
    """Forward physics (nr, 3, nt) for model ``m``."""
    x, y, z, mxyz = _model_to_physics(m, prob, opts)
    _, s = synthetic_seismograms(x, y, z, mxyz, prob.stations,
                                 nt=prob.t.shape[0], dt=prob.t[1] - prob.t[0],
                                 medium=prob.medium, fc=prob.fc, t0=prob.t[0])
    return s


def misfit_from_seis(s, prob: LocCMTProblem, opts: InvOptions,
                     cfg: TraceConfig):
    """Scalar misfit of predicted seismograms ``s`` (nr, 3, nt)."""
    if opts.mistype == "L2":
        r = s - prob.seis_obs
        return (r * r).sum()
    nr, nc, nt = s.shape
    un = arctan_transform(s, prob.windows.u0[..., None],
                          prob.windows.u1[..., None])
    cfg_fp = dataclasses.replace(cfg, transform=False)
    wt, wu = trace_misfit(prob.t, un.reshape(nr * nc, nt),
                          _flat_unit_windows(prob.windows, nr, nc),
                          prob.targets, cfg_fp)
    if opts.wopt == "Wt":
        return wt.sum()
    if opts.wopt == "Wu":
        return wu.sum()
    return 0.5 * (wt.sum() + wu.sum())


def loc_cmt_misfit(m, prob: LocCMTProblem, opts: InvOptions, cfg: TraceConfig):
    """Scalar OT (or L2) misfit summed over all traces."""
    s = predicted_seismograms(m, prob, opts)
    return misfit_from_seis(s, prob, opts, cfg)


def loc_cmt_value_and_grad(m, prob: LocCMTProblem, opts: InvOptions,
                           cfg: TraceConfig):
    """(misfit, d misfit / dm), the reference optfunc contract."""
    m = m.detach().requires_grad_(True)
    with torch.enable_grad():
        v = loc_cmt_misfit(m, prob, opts, cfg)
        (g,) = torch.autograd.grad(v, m)
    return v.detach(), g


class LocCMTObjective(TensorTreeModule):
    """The loc/CMT misfit as a module: the problem's tensors are buffers, so
    ``.to(device)`` moves the problem and ``forward(m)`` returns the misfit."""

    def __init__(self, prob: LocCMTProblem, opts: InvOptions, cfg: TraceConfig):
        super().__init__(prob)
        self.opts = opts
        self.cfg = cfg

    def forward(self, m):
        return loc_cmt_misfit(m, self.tree(), self.opts, self.cfg)

    def value_and_grad(self, m):
        return loc_cmt_value_and_grad(m, self.tree(), self.opts, self.cfg)

