"""Exact-EMD and entropic-OT validation bridges (native C++ solver, optional
POT) (counterpart of waveform_ot_tpu.ops.pot_bridge).

Reference: wasserPOT / sinkhornPOT (libs/OTlib.py:906-928, 1015-1053):
import-guarded wrappers around the POT library's exact network-simplex EMD
and Sinkhorn solvers, used purely for cross-validation.

The default backend is the package's own exact solver, a C++
successive-shortest-paths min-cost flow (waveform_ot_torch/native) on the
host, for the EMD, and a log-domain Sinkhorn-Knopp loop with POT's update
order and termination check for the entropic variant, on the densities'
device. POT is preferred when it is installed.
:class:`errors.POTLibraryError` is raised only when the requested backend
is unavailable (the reference guard at OTlib.py:24-28 for backend='pot').

Both take the port's Density1D/Density2D and return NumPy, as the JAX
module does: [cost, plan?, distance matrix?]. The distance matrix is formed
on the host as JAX forms it.
"""

from __future__ import annotations

import numpy as np
import torch

from waveform_ot_torch.ops import errors

try:
    import ot as _pot

    HAVE_POT = True
except ImportError:  # the wheel is optional
    _pot = None
    HAVE_POT = False

SINKHORN_MAX_ITER = 5000
SINKHORN_STOP = 1e-9
SINKHORN_CHECK_EVERY = 10


def _resolve_backend(backend: str) -> str:
    if backend == "auto":
        backend = "pot" if HAVE_POT else "native"
    if backend == "pot" and not HAVE_POT:
        raise errors.POTLibraryError()
    if backend not in ("pot", "native"):
        raise ValueError(f"unknown POT-bridge backend {backend!r}")
    return backend


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64) if isinstance(x, torch.Tensor) else x


def _cost(source, target, distfunc) -> np.ndarray:
    """The pairwise distance matrix (n, m), host float64 as the JAX module
    forms it (NumPy's sqrt, so the EMD sees the same costs): cityblock for
    'W1' (OTlib.py:913), Euclidean squared for 'W2', or the given (n, m)
    matrix."""
    if isinstance(distfunc, str):
        if distfunc not in ("W1", "W2"):
            raise errors.UnknownOTDistanceTypeError(distfunc)
        a = _host(source.x).reshape(source.pdf.numel(), -1)
        b = _host(target.x).reshape(target.pdf.numel(), -1)
        diff = a[:, None, :] - b[None, :, :]
        if distfunc == "W1":
            return np.sum(np.abs(diff), axis=2)
        return np.sqrt(np.sum(diff * diff, axis=2)) ** 2
    d = np.asarray(_host(distfunc), dtype=np.float64)
    if d.ndim != 2:
        raise errors.UnknownOTDistanceTypeError(distfunc)
    return d


def _masses(density) -> torch.Tensor:
    return density.pdf.detach().to(torch.float64).reshape(-1)


def wasser_pot(source, target, distfunc="W2", returnplan=False, returndist=False,
               maxiters: int = 100000, backend: str = "auto"):
    """Exact EMD (reference wasserPOT, OTlib.py:906-928), solved on the host.

    backend: 'pot' (the POT wheel; raises POTLibraryError when absent, the
    reference behaviour), 'native' (the package's C++ min-cost flow), or
    'auto' (POT when installed, else native).
    """
    backend = _resolve_backend(backend)
    A = _cost(source, target, distfunc)
    M = A / A.max()
    a, b = _host(_masses(source)), _host(_masses(target))
    if backend == "pot":
        G0 = _pot.emd(a, b, M, numItermax=maxiters)
    else:
        from waveform_ot_torch import native

        _, G0 = native.emd(a, b, M, max_iter=maxiters)
    out = [float(np.sum(G0 * A))]
    if returnplan:
        out.append(G0)
    if returndist:
        out.append(A)
    return out


def _sinkhorn_knopp(a, b, M, reg):
    """Sinkhorn fixed point with POT's (a / Kv, b / K^T u) update order, in
    the log domain so small regularizations do not underflow exp(-M/reg)
    (POT's method='sinkhorn_log'), on the tensors' device. The stop test on
    the plan's row sums runs every SINKHORN_CHECK_EVERY steps and reads one
    number from the device."""
    logK = -M / reg
    la, lb = torch.log(a), torch.log(b)
    f = torch.zeros_like(a)
    g = torch.zeros_like(b)
    for it in range(SINKHORN_MAX_ITER):
        f = la - torch.logsumexp(logK + g[None, :], dim=1)
        g = lb - torch.logsumexp(logK + f[:, None], dim=0)
        if it % SINKHORN_CHECK_EVERY == 0:
            rows = torch.exp(f[:, None] + logK + g[None, :]).sum(dim=1)
            if float(torch.linalg.vector_norm(rows - a)) < SINKHORN_STOP:
                break
    return torch.exp(f[:, None] + logK + g[None, :])


def sinkhorn_pot(source, target, distfunc="W2", returnplan=False, gamma: float = 5e-4,
                 returndist=False, backend: str = "auto"):
    """Entropic OT (reference sinkhornPOT, OTlib.py:1015-1053), with its
    replacement of zero amplitudes by the smallest non-zero one. The native
    backend iterates on the densities' device."""
    backend = _resolve_backend(backend)
    ab = []
    for d in (source, target):
        v = _masses(d).clone()
        z = v == 0.0
        if bool(z.any()):
            v[z] = v[~z].min()
        ab.append(v)
    A = _cost(source, target, distfunc)
    M = A / A.max()
    if backend == "pot":
        Gs = _pot.sinkhorn(*(_host(v) for v in ab), M, gamma)
    else:
        dev = ab[0].device
        Gs = _host(_sinkhorn_knopp(ab[0], ab[1].to(dev), torch.as_tensor(M, device=dev), gamma))
    out = [float(np.sum(Gs * A))]
    if returnplan:
        out.append(Gs)
    if returndist:
        out.append(A)
    return out
