"""The Ricker objective (counterpart of waveform_ot_tpu.inversion.objective).

The same chain as the loc/CMT misfit on one trace (a batch of 1): double
Ricker wavelet -> arctan transform -> fingerprint -> marginal W2, with
w2 = alpha*W_t + (1 - alpha)*W_u.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from waveform_ot_torch._tree import TensorTreeModule
from waveform_ot_torch.inversion.pipeline import (
    Targets, TraceConfig, grid6_to_window, trace_misfit,
)
from waveform_ot_torch.models.ricker import ricker_wavelet
from waveform_ot_torch.ops.fingerprint import Window


class RickerProblem(NamedTuple):
    """Observed marginals (a batch of 1), raw-amplitude window, time range
    and marginal weight."""

    targets: Targets
    window: Window
    trange: tuple
    alpha: float


def make_ricker_problem(targets: Targets, grid6, trange=(-2.0, 7.0),
                        alpha: float = 0.5, lambdav: float = 0.03):
    """(RickerProblem, TraceConfig) on the device and dtype of ``targets``:
    45-degree window, arctan transform, exp(-|d|/lambda) density, W2."""
    x = targets.t.x
    win, spec = grid6_to_window(grid6, dtype=x.dtype, device=x.device)
    cfg = TraceConfig(nu=spec.nu, ntg=spec.ntg, lambdav=lambdav, q=None, p=2,
                      transform=True)
    prob = RickerProblem(targets=targets, window=win, trange=tuple(trange),
                         alpha=alpha)
    return prob, cfg


def ricker_misfit(m, prob: RickerProblem, cfg: TraceConfig):
    """Scalar objective alpha*W_t + (1 - alpha)*W_u of model m = (tpert, amp, f)."""
    t, w = ricker_wavelet(m[0], m[1], m[2], trange=prob.trange)
    wt, wu = trace_misfit(t, w[None], prob.window, prob.targets, cfg)
    return prob.alpha * wt[0] + (1.0 - prob.alpha) * wu[0]


def ricker_value_and_grad(m, prob: RickerProblem, cfg: TraceConfig):
    """(w2, dw2/dm) by autograd of :func:`ricker_misfit`."""
    m = m.detach().requires_grad_(True)
    with torch.enable_grad():
        v = ricker_misfit(m, prob, cfg)
        (g,) = torch.autograd.grad(v, m)
    return v.detach(), g


class RickerObjective(TensorTreeModule):
    """The Ricker misfit as a module holding the problem tensors as buffers."""

    def __init__(self, prob: RickerProblem, cfg: TraceConfig):
        super().__init__(prob)
        self.cfg = cfg

    def forward(self, m):
        return ricker_misfit(m, self.tree(), self.cfg)

    def value_and_grad(self, m):
        return ricker_value_and_grad(m, self.tree(), self.cfg)
