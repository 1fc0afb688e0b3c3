"""Source-location / moment-tensor objectives, batched over models and traces.

Counterpart of waveform_ot_tpu.inversion.loc_cmt. Every objective takes a
batch of k models ``ms`` (k, nm) and returns (k,) misfits, where the JAX
package vmaps a per-model function; a single model (nm,) still gives a
scalar. The k models' (nr, 3) traces are flattened to one batch of k*nr*3
traces, model-major and then in the JAX module's (nr, 3) order, so one
evaluation launches the distance-field kernel once for all k models. The
gradient is one autograd pass of the sum over lanes through forward
physics, arctan transform, fingerprint, marginal OT and the sum over
traces: the lanes are independent, so d(sum_j f_j)/dm_j = df_j/dm_j.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from waveform_ot_torch._tree import TensorTreeModule
from waveform_ot_torch.inversion import cuda_graph
from waveform_ot_torch.inversion.pipeline import (
    Targets, TraceConfig, as_model_batch, build_target, repeat_targets,
    trace_misfit,
)
from waveform_ot_torch.inversion.windows import (
    build_windows, unit_amplitude_windows,
)
from waveform_ot_torch.models.layered import _moment_coeffs
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

    # the fields split with the stations by parallel.pjit_batched_misfit
    trace_fields = ("seis_obs", "windows", "targets", "stations")


def _clamp_depth_straight_through(z, zmin):
    """Value max(z, zmin) with gradient 1 everywhere."""
    return z - (z - torch.clamp_min(z, zmin)).detach()


def _flat_unit_windows(windows: Window, nr: int, nc: int, k: int = 1) -> Window:
    """(0, 1) windows with every field broadcast to the flat (k*nr*nc,)
    batch of k models' traces."""
    win01 = unit_amplitude_windows(windows)
    return Window(*(torch.broadcast_to(a, (k, nr, nc)).reshape(k * nr * nc)
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


def _model_to_physics(ms, prob: LocCMTProblem, opts: InvOptions):
    """Models (k, nm) -> (x, y, z (k,), Mxyz (k, 3, 3) or the fixed (3, 3))
    with preconditioning, the depth floor per lane and the loc/cmt layout."""
    if opts.precon:
        ms = ms * prob.mscal
    k = ms.shape[0]
    if opts.loc:
        x, y, z = ms[:, 0], ms[:, 1], ms[:, 2]
    else:
        x, y, z = (prob.mref[i].expand(k) for i in range(3))
    z = _clamp_depth_straight_through(z, opts.zmin)
    if opts.cmt:
        mxyz = mxyz_from_upper(ms[:, 3:] if opts.loc else ms)
    else:
        mxyz = prob.mxyz_fixed
    return x, y, z, mxyz


def predicted_seismograms(ms, prob: LocCMTProblem, opts: InvOptions,
                          forward: Callable | None = None):
    """Forward physics: (k, nr, 3, nt) for models (k, nm), (nr, 3, nt) for
    one model (nm,). ``forward(x, y, z, mxyz)`` with sources (k,) and the
    moment tensor (3, 3) or (k, 3, 3) returns (k, nr, 3, nt) (e.g.
    :func:`models.layered.make_layered_forward`); the default is
    :func:`synthetic_seismograms`."""
    batch, single = as_model_batch(ms)
    x, y, z, mxyz = _model_to_physics(batch, prob, opts)
    if forward is not None:
        s = forward(x, y, z, mxyz)
    else:
        _, s = synthetic_seismograms(x, y, z, mxyz, prob.stations,
                                     nt=prob.t.shape[0], dt=prob.t[1] - prob.t[0],
                                     medium=prob.medium, fc=prob.fc, t0=prob.t[0])
    return s[0] if single else s


def misfit_from_seis(s, prob: LocCMTProblem, opts: InvOptions,
                     cfg: TraceConfig):
    """Misfits (k,) of predicted seismograms ``s`` (k, nr, 3, nt); a scalar
    for one model's (nr, 3, nt)."""
    single = s.dim() == 3
    if single:
        s = s[None]
    if opts.mistype == "L2":
        r = s - prob.seis_obs
        v = (r * r).sum(dim=(-3, -2, -1))
        return v[0] if single else v
    k, nr, nc, nt = s.shape
    un = arctan_transform(s, prob.windows.u0[..., None],
                          prob.windows.u1[..., None])
    cfg_fp = dataclasses.replace(cfg, transform=False)
    wt, wu = trace_misfit(prob.t, un.reshape(k * nr * nc, nt),
                          _flat_unit_windows(prob.windows, nr, nc, k),
                          repeat_targets(prob.targets, k), cfg_fp)
    wt = wt.reshape(k, nr * nc).sum(dim=-1)
    wu = wu.reshape(k, nr * nc).sum(dim=-1)
    if opts.wopt == "Wt":
        v = wt
    elif opts.wopt == "Wu":
        v = wu
    else:
        v = 0.5 * (wt + wu)
    return v[0] if single else v


def loc_cmt_misfit(ms, prob: LocCMTProblem, opts: InvOptions, cfg: TraceConfig,
                   forward: Callable | None = None):
    """OT (or L2) misfits (k,) of models ``ms`` (k, nm), each summed over
    all traces; a scalar for one model (nm,). One distance-field launch
    for the whole batch. ``forward`` as in :func:`predicted_seismograms`."""
    s = predicted_seismograms(ms, prob, opts, forward=forward)
    return misfit_from_seis(s, prob, opts, cfg)


def loc_cmt_value_and_grad(ms, prob: LocCMTProblem, opts: InvOptions,
                           cfg: TraceConfig, forward: Callable | None = None):
    """(misfits (k,), gradients (k, nm)) of models ``ms`` (k, nm) by one
    autograd pass of the sum over lanes; (scalar, (nm,)) for one model.
    The reference optfunc contract, batched. One model on a CUDA device
    is one replay of a captured CUDA graph of the whole call
    (:mod:`waveform_ot_torch.inversion.cuda_graph`): the same kernels in
    the same order."""
    if cuda_graph.engages(ms):
        return cuda_graph.value_and_grad(_value_and_grad, ms, prob, opts, cfg, forward)
    return _value_and_grad(ms, prob, opts, cfg, forward)


def _value_and_grad(ms, prob: LocCMTProblem, opts: InvOptions, cfg: TraceConfig,
                    forward: Callable | None):
    """:func:`loc_cmt_value_and_grad` run op by op."""
    ms = ms.detach().requires_grad_(True)
    with torch.enable_grad():
        v = loc_cmt_misfit(ms, prob, opts, cfg, forward=forward)
        (g,) = torch.autograd.grad(v.sum(), ms)
    return v.detach(), g


def misfit_grid(ms, prob: LocCMTProblem, opts: InvOptions, cfg: TraceConfig,
                forward: Callable | None = None):
    """Misfit-surface scan: misfits (k,) at the model nodes ``ms`` (k, nm),
    one batched evaluation (the reference's triple loop over the (z, x, y)
    grid). For values and gradients at every node, call
    :func:`loc_cmt_value_and_grad` on the same batch."""
    return loc_cmt_misfit(ms, prob, opts, cfg, forward=forward)


def misfit_grid_sharded(ms, prob: LocCMTProblem, opts: InvOptions, cfg: TraceConfig,
                        mesh, axis_name: str = "batch", forward: Callable | None = None):
    """Misfit-surface scan over a mesh: the model nodes ``ms`` (k, nm) split
    over the shards (the mesh size must divide k), the problem replicated,
    and each shard's :func:`misfit_grid` of its nodes in one evaluation (one
    kernel launch on the card), with no communication. Returns the misfits
    as a :class:`waveform_ot_torch.parallel.Sharded` of (k/n,) per shard;
    ``.gather()`` gives (k,) on the lead device.

    ``forward`` is replicated too: an nn.Module is copied to each distinct
    device; a function must compute on the device of its sources (see
    :mod:`waveform_ot_torch.parallel.mesh`).
    """
    from waveform_ot_torch.parallel.mesh import sharded_map

    f = sharded_map(lambda m, p, fwd: misfit_grid(m, p, opts, cfg, forward=fwd),
                    mesh, axis_name=axis_name)
    return f(ms, prob, forward)


class LocCMTObjective(TensorTreeModule):
    """The loc/CMT misfit as a module: the problem's tensors are buffers, so
    ``.to(device)`` moves the problem, and ``forward(ms)`` returns the
    misfits (k,) of a model batch (k, nm), or one model's scalar.
    ``forward`` is the physics of :func:`predicted_seismograms`."""

    def __init__(self, prob: LocCMTProblem, opts: InvOptions, cfg: TraceConfig,
                 forward: Callable | None = None):
        super().__init__(prob)
        self.opts = opts
        self.cfg = cfg
        self.physics = forward

    def forward(self, m):
        return loc_cmt_misfit(m, self.tree(), self.opts, self.cfg, forward=self.physics)

    def value_and_grad(self, m):
        return loc_cmt_value_and_grad(m, self.tree(), self.opts, self.cfg,
                                      forward=self.physics)


def layered_misfit_grid(zs, xy, prob: LocCMTProblem, opts: InvOptions,
                        cfg: TraceConfig, stages, xy_chunk: int | None = None):
    """Depth-amortized misfit-surface scan through the layered physics:
    values (nz, nxy) and (x, y, z) gradients (nz, nxy, 3) at every node of
    the (depths ``zs`` (nz,)) x (horizontal nodes ``xy`` (nxy, 2)) grid, the
    reference's Figs_9_10_11 cell-64 workload.

    ``stages`` = :func:`models.layered.make_layered_stages` (the problem's
    nt, dt, nk, ...). Stage A and its z-tangent run once for all nz depths;
    the response runs once per depth; every node gets its own Bessel
    assembly, synthesis and misfit, and its z gradient is the contraction
    of its spectra's cotangent with their z-tangent (the structured-VJP
    identity of make_layered_forward, amortized over the slice). All nodes
    go through one evaluation, so one distance-field launch; ``xy_chunk``
    evaluates the horizontal nodes in chunks of that size to bound memory
    (one launch per chunk). The moment tensor stays ``prob.mxyz_fixed``.
    """
    if opts.cmt:
        raise ValueError("layered_misfit_grid scans location only "
                         "(cmt=True has no 3-vector gradient contract)")
    stage_a, stage_b = stages[:2]
    dtype, device = xy.dtype, xy.device
    # the depth floor's value; its straight-through gradient factor is 1
    zc = torch.clamp_min(torch.as_tensor(zs, dtype=dtype, device=device), opts.zmin)
    ops, dops = stage_a(zc, tangent=True)
    a = _moment_coeffs(prob.mxyz_fixed)
    nz, nxy = zc.shape[0], xy.shape[0]
    step = nxy if xy_chunk is None else xy_chunk
    vals, grads = [], []
    for lo in range(0, nxy, step):
        part = xy[lo:lo + step]
        n = part.shape[0]
        leaf = lambda v: v.detach().expand(nz, n).clone().requires_grad_(True)
        x, y, z = leaf(part[:, 0]), leaf(part[:, 1]), leaf(zc[:, None])
        with torch.enable_grad():
            s = stage_b(ops, x, y, z, a, prob.stations, dops)
            v = misfit_from_seis(s.reshape((nz * n,) + s.shape[2:]), prob, opts, cfg)
            g = torch.autograd.grad(v.sum(), (x, y, z))
        vals.append(v.detach().reshape(nz, n))
        grads.append(torch.stack(g, -1))
    return torch.cat(vals, 1), torch.cat(grads, 1)

