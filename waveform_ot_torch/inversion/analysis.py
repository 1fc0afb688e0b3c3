"""Convergence analysis for repeat-inversion studies (counterpart of
waveform_ot_tpu.inversion.analysis; numpy only, so the port keeps its own
copy rather than importing the JAX package).

Reference: loc_cmt_util.checkconverge / printanalysis
(loc_cmt_util.py:399-427, 667-702), vectorized over the batch of solutions.
Tensors are read as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(a) -> np.ndarray:
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


def check_convergence(m_starts, m_finals, m_true, dlimit: float = 1.0,
                      exclude_edge: float | None = 80.0):
    """Classify repeat inversions as converged by distance to the truth.

    Args:
      m_starts: (k, nm) starting models; m_finals: (k, nm) solutions.
      m_true: (nm,) or (3,) true model (location part used).
      dlimit: convergence radius |loc_final - loc_true|.
      exclude_edge: drop starts with |x| equal to this value from the
        statistics (the reference restricts to an inner square).

    Returns (converged (k,) bool, dist (k,), considered (k,) bool,
    fraction_converged).
    """
    m_starts = _np(m_starts)
    m_finals = _np(m_finals)
    loc_true = _np(m_true)[:3]
    dist = np.linalg.norm(m_finals[:, :3] - loc_true[None, :], axis=1)
    converged = dist < dlimit
    considered = np.ones(len(m_starts), bool)
    if exclude_edge is not None:
        considered = np.abs(m_starts[:, 0]) != exclude_edge
    n = max(int(considered.sum()), 1)
    frac = float((converged & considered).sum()) / n
    return converged, dist, considered, frac


def solution_report(m_final, m_true, mis_start, mis_final, mis_true=None):
    """Structured printanalysis: location error, and CMT percentage errors
    when the models carry a moment tensor."""
    m_final = _np(m_final)
    m_true = _np(m_true)
    out = {
        "loc_final": m_final[:3],
        "loc_true": m_true[:3],
        "loc_error": np.linalg.norm(m_final[:3] - m_true[:3]),
        "mis_start": float(mis_start),
        "mis_final": float(mis_final),
    }
    if mis_true is not None:
        out["mis_true"] = float(mis_true)
    if m_final.size > 3 and m_true.size > 3:
        with np.errstate(divide="ignore", invalid="ignore"):
            out["cmt_percent_error"] = 100.0 * (m_final[3:9] - m_true[3:9]) / m_true[3:9]
    return out
