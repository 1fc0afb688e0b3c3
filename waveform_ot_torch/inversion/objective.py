"""The Ricker objective (counterpart of waveform_ot_tpu.inversion.objective).

The same chain as the loc/CMT misfit on one trace per model: double
Ricker wavelet -> arctan transform -> fingerprint -> marginal W2, with
w2 = alpha*W_t + (1 - alpha)*W_u. Like the loc/CMT objectives it takes a
batch of models (k, 3) and gives (k,) misfits through one distance-field
launch; one model (3,) gives a scalar. :func:`ricker_objective` is the
reference's explicit gradient assembly, one model at a time.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from waveform_ot_torch._tree import TensorTreeModule
from waveform_ot_torch.inversion.pipeline import (
    Targets, TraceConfig, as_model_batch, calc_wasser_waveform,
    grid6_to_window, repeat_targets, trace_misfit,
)
from waveform_ot_torch.models.ricker import (
    ricker_wavelet, ricker_wavelet_with_jacobian,
)
from waveform_ot_torch.ops.fingerprint import Window
from waveform_ot_torch.ops.transforms import arctan_transform


class RickerProblem(NamedTuple):
    """Observed marginals (a batch of 1), raw-amplitude window, time range
    and marginal weight."""

    targets: Targets
    window: Window
    trange: tuple
    alpha: float


def make_ricker_problem(targets: Targets, grid6, trange=(-2.0, 7.0),
                        alpha: float = 0.5, theta: float = 45.0,
                        lambdav: float = 0.03, p: int = 2, q: int | None = None,
                        transform: bool = True):
    """(RickerProblem, TraceConfig) on the device and dtype of ``targets``: a
    window at ``theta`` degrees, the arctan transform where ``transform``,
    the density exp(-|d|/lambda) (q None) or its q-power form, W_p."""
    x = targets.t.x
    win, spec = grid6_to_window(grid6, theta=theta, dtype=x.dtype, device=x.device)
    cfg = TraceConfig(nu=spec.nu, ntg=spec.ntg, lambdav=lambdav, q=q, p=p,
                      transform=transform)
    prob = RickerProblem(targets=targets, window=win, trange=tuple(trange),
                         alpha=alpha)
    return prob, cfg


def ricker_misfit(ms, prob: RickerProblem, cfg: TraceConfig):
    """alpha*W_t + (1 - alpha)*W_u of models ms = (tpert, amp, f): (k,) for
    a batch (k, 3), a scalar for one model (3,)."""
    batch, single = as_model_batch(ms)
    t, w = ricker_wavelet(batch[:, 0], batch[:, 1], batch[:, 2], trange=prob.trange)
    wt, wu = trace_misfit(t, w, prob.window,
                          repeat_targets(prob.targets, batch.shape[0]), cfg)
    v = prob.alpha * wt + (1.0 - prob.alpha) * wu
    return v[0] if single else v


def ricker_value_and_grad(ms, prob: RickerProblem, cfg: TraceConfig):
    """(w2, dw2/dm) by one autograd pass of :func:`ricker_misfit` summed
    over lanes: ((k,), (k, 3)) for a batch, (scalar, (3,)) for one model."""
    ms = ms.detach().requires_grad_(True)
    with torch.enable_grad():
        v = ricker_misfit(ms, prob, cfg)
        (g,) = torch.autograd.grad(v.sum(), ms)
    return v.detach(), g


def ricker_objective(m, prob: RickerProblem, cfg: TraceConfig):
    """(w2, deriv) of one model m (3,) with the reference's explicit
    assembly (ricker_util.py:384-403): wavelet and analytic jacobian ->
    arctan transform -> misfit per marginal with its waveform derivative ->
    scaled by the arctan slope -> deriv = dudm . dr mixed by alpha ->
    deriv[0] overwritten by the window derivative dg."""
    tpos, wpos, dudm = ricker_wavelet_with_jacobian(m[0], m[1], m[2],
                                                    trange=prob.trange)
    win = prob.window
    un, dundu = arctan_transform(wpos, win.u0, win.u1, deriv=True)
    win01 = Window(win.t0, win.t1, torch.zeros_like(win.u0),
                   torch.ones_like(win.u1), win.tantheta)
    cfg_fp = dataclasses.replace(cfg, transform=False)
    w2m, dr, dgm = calc_wasser_waveform(tpos, un[None], win01, prob.targets,
                                        cfg_fp, deriv=True, returnmarg=True)
    a = prob.alpha
    w2 = a * w2m[0][0] + (1.0 - a) * w2m[1][0]
    dg = a * dgm[0][0] + (1.0 - a) * dgm[1][0]
    # (3, nt) . (nt,) as explicit sums: out of TF32 whatever the matmul setting
    deriv = (a * (dudm * (dr[0][0] * dundu)).sum(dim=-1)
             + (1.0 - a) * (dudm * (dr[1][0] * dundu)).sum(dim=-1))
    return w2, torch.cat([dg[None], deriv[1:]])


class RickerObjective(TensorTreeModule):
    """The Ricker misfit as a module holding the problem tensors as buffers."""

    def __init__(self, prob: RickerProblem, cfg: TraceConfig):
        super().__init__(prob)
        self.cfg = cfg

    def forward(self, ms):
        return ricker_misfit(ms, self.tree(), self.cfg)

    def value_and_grad(self, ms):
        return ricker_value_and_grad(ms, self.tree(), self.cfg)
