"""Native (C++) validation solvers: exact EMD and fast marching
(counterpart of waveform_ot_tpu.native).

The reference reaches native code only through optional wheels: POT's
network-simplex EMD (libs/OTlib.py:906-928, 1015-1053) and scikit-fmm's
fast marching (libs/FingerprintLib.py:139-152). This package keeps its own
copy of a small self-contained C++ library (``src/wotnative.cpp``), built at
first use with g++ through the package's one build helper
(:func:`waveform_ot_torch._build.build_library`, into the git-ignored
``waveform_ot_torch/_build/``) and bound through ctypes. Both solvers are
sequential (a successive-shortest-path min-cost flow, a priority-queue
front), so they run on the host on NumPy arrays wherever the caller's
tensors live.

Public API:
  emd(a, b, cost)            -> (cost_value, plan)   exact transportation solve
  fmm_distance(phi, dx, ...) -> signed distance to phi's zero contour
  available()                -> bool (g++ present and the library builds)

A missing g++ or a failed compile raises :class:`NativeBuildError`; nothing
substitutes another solver.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from waveform_ot_torch import _build

__all__ = ["emd", "fmm_distance", "available", "NativeBuildError"]

_SRC = Path(__file__).parent / "src" / "wotnative.cpp"
_DP = ctypes.POINTER(ctypes.c_double)


class NativeBuildError(_build.KernelBuildError):
    """The native library could not be compiled or loaded."""


@functools.cache
def _load() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(_build.build_library(_SRC, _build.find_gxx, _build.GXX_FLAGS)))
    except (_build.KernelBuildError, OSError) as e:
        raise NativeBuildError(str(e)) from e
    lib.wot_emd.restype = ctypes.c_double
    lib.wot_emd.argtypes = [ctypes.c_int, ctypes.c_int, _DP, _DP, _DP, _DP,
                            ctypes.c_long, ctypes.POINTER(ctypes.c_int)]
    lib.wot_fmm_distance.restype = ctypes.c_int
    lib.wot_fmm_distance.argtypes = [ctypes.c_int, ctypes.c_int, _DP, ctypes.c_double,
                                     ctypes.c_double, ctypes.c_int, _DP]
    return lib


def available() -> bool:
    """True when the native library is built (or buildable) and loadable."""
    try:
        _load()
        return True
    except NativeBuildError:
        return False


def _as_c(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def emd(a, b, cost, max_ratio_check: float = 1e-6, max_iter: int | None = None):
    """Exact optimal transport between discrete masses (native solver).

    Solves min <F, cost> s.t. F 1 = a, F^T 1 = b, F >= 0 by successive
    shortest augmenting paths (wotnative.cpp). Equivalent to POT's
    ``ot.emd`` on balanced problems; ``b`` is rescaled to sum(a) within
    ``max_ratio_check`` (mirroring POT's tolerance behaviour).

    Args:
      a: (n,) non-negative source masses.
      b: (m,) non-negative target masses.
      cost: (n, m) pairwise cost matrix.
      max_iter: augmentation cap (like POT's numItermax); None selects the
        solver's internal bound n*m + n + m + 64.

    Returns:
      (value, plan): the optimal cost ``sum(plan * cost)`` and the (n, m)
      optimal transport plan, NumPy float64.

    About O((n+m) n m) with dense Dijkstra passes: sized for validation
    problems of a few hundred points.
    """
    lib = _load()
    a = _as_c(np.ravel(a))
    b = _as_c(np.ravel(b))
    cost = _as_c(cost)
    n, m = a.shape[0], b.shape[0]
    if cost.shape != (n, m):
        raise ValueError(f"cost shape {cost.shape} != ({n}, {m})")
    sa, sb = float(a.sum()), float(b.sum())
    if sa <= 0 or sb <= 0:
        raise ValueError("masses must have positive total")
    if abs(sa - sb) > max_ratio_check * max(sa, sb):
        raise ValueError(f"unbalanced masses: sum(a)={sa!r}, sum(b)={sb!r}")
    plan = np.zeros((n, m), dtype=np.float64)
    status = ctypes.c_int(0)
    value = lib.wot_emd(n, m, a.ctypes.data_as(_DP), b.ctypes.data_as(_DP),
                        cost.ctypes.data_as(_DP), plan.ctypes.data_as(_DP),
                        0 if max_iter is None else int(max_iter), ctypes.byref(status))
    if status.value != 0:
        raise RuntimeError(f"wot_emd failed with status {status.value}")
    return value, plan


def fmm_distance(phi, dx, order: int = 2):
    """Signed distance to the zero contour of ``phi`` by fast marching.

    Same contract as ``skfmm.distance``: ``phi`` is an (nu, nt) level-set
    field (the fingerprint pipeline passes a +/-1 indicator,
    libs/FingerprintLib.py:142-146); ``dx = (du, dt)`` are the grid
    spacings; the result carries the sign of ``phi``. ``order`` selects
    first- or second-order upwind differences (skfmm defaults to 2).
    """
    lib = _load()
    phi = _as_c(phi)
    if phi.ndim != 2:
        raise ValueError("phi must be 2-D")
    nu, nt = phi.shape
    out = np.empty((nu, nt), dtype=np.float64)
    rc = lib.wot_fmm_distance(nu, nt, phi.ctypes.data_as(_DP), float(dx[0]), float(dx[1]),
                              int(order), out.ctypes.data_as(_DP))
    if rc == 2:
        raise ValueError("phi has no zero contour")
    if rc != 0:
        raise ValueError(f"wot_fmm_distance failed with rc {rc}")
    return out
