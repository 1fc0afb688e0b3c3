"""Explicit optimization traces (counterpart of waveform_ot_tpu.inversion.trace).

The reference records optimization history in module-global "blackboards"
appended inside the objective; here an :class:`InversionTrace` that the
caller owns records every evaluation of a wrapped (value, grad) objective
and every accepted iterate of a scipy run. Tensors are recorded as numpy
copies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import numpy as np
import torch


def _np_copy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().copy()
    return np.asarray(a).copy()


@dataclasses.dataclass
class InversionTrace:
    """Host-side record of an optimization run.

    models[i], misfits[i] (and grads[i], and aux[i] where given) record every
    objective evaluation; iterates[j] records accepted optimizer iterations
    (the reference's ``recordresult`` callback).
    """

    models: List[np.ndarray] = dataclasses.field(default_factory=list)
    misfits: List[float] = dataclasses.field(default_factory=list)
    grads: List[np.ndarray] = dataclasses.field(default_factory=list)
    iterates: List[np.ndarray] = dataclasses.field(default_factory=list)
    aux: List[Any] = dataclasses.field(default_factory=list)

    def record_eval(self, m, misfit, grad=None, aux=None) -> None:
        self.models.append(_np_copy(m))
        self.misfits.append(float(misfit))
        if grad is not None:
            self.grads.append(_np_copy(grad))
        if aux is not None:
            self.aux.append(aux)

    def record_iterate(self, m) -> None:
        self.iterates.append(_np_copy(m))

    def wrap_objective(self, value_and_grad_fn: Callable) -> Callable:
        """``value_and_grad_fn`` with every call recorded, for
        :func:`waveform_ot_torch.inversion.minimize_scipy`."""

        def wrapped(m, *args, **kwargs):
            v, g = value_and_grad_fn(m, *args, **kwargs)
            self.record_eval(m, v, g)
            return v, g

        return wrapped

    def scipy_callback(self) -> Callable:
        """Callback for scipy.optimize.minimize recording accepted iterates."""

        def cb(xk):
            self.record_iterate(xk)

        return cb

    def misfit_per_iterate(self) -> np.ndarray:
        """Misfit at each accepted iterate (the reference's findres): the
        evaluation log indexed once by model bytes, first occurrence wins."""
        index: dict = {}
        for m, w in zip(self.models, self.misfits):
            index.setdefault((m.shape, m.tobytes()), w)
        out = [index[key] for it in self.iterates
               if (key := (it.shape, it.tobytes())) in index]
        return np.asarray(out)
