"""The comparison that decides ``correct``: what the timed path produced
against the float64 reference, on a sample of the window's units drawn from
the seed.

  value_gap    the largest |v - v_ref| / |v_ref| over the compared points:
               misfits of scan nodes and calls, and the misfits a study
               reports at its end points;
  grad_gap     the largest |g - g_ref| / max(|g_ref|, median |g_ref|) over
               the compared points (norms of the 3-vectors; the median
               keeps nodes near the minimum, where |g_ref| is all but zero,
               from reading rounding as a fault);
  grad_end     a study's largest reference gradient norm (misfit per km) at
               the compared end points that the solver reports converged:
               that they are stationary points of the reference's misfit
               (infinite when none of them is reported converged);
  unconverged_share  a study's share of lanes, over every start of every
               study the window finished, that the solver reports not
               converged. It needs no reference: the two numbers above judge
               only what the solver hands back and the lanes it calls
               converged, so a solver that leaves lanes where they began and
               flags them would pass them; this number does not.

Each number has a limit in ``limits/<cell>.json``; a run is correct when
every number is at or below its limit (a number that is not finite is not).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sample(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """k of range(n) without repeats (all of them when k >= n), sorted."""
    return np.sort(rng.choice(n, size=min(n, k), replace=False))


def gaps(v, v_ref, g=None, g_ref=None) -> dict:
    """value_gap and, given gradients (k, 3), grad_gap."""
    v, v_ref = v.double().cpu(), v_ref.double().cpu()
    out = {"value_gap": float(((v - v_ref).abs() / v_ref.abs()).max())}
    if g is not None:
        g, g_ref = g.double().cpu(), g_ref.double().cpu()
        n_ref = torch.linalg.vector_norm(g_ref, dim=-1)
        scale = torch.maximum(n_ref, n_ref.median())
        out["grad_gap"] = float((torch.linalg.vector_norm(g - g_ref, dim=-1) / scale).max())
    return out


def points(traffic: dict, units: list, outputs: list, seed: int):
    """The sample the reference compares, drawn from the seed over the
    window's units: (models (n, 3) float64, the program's values (n,), and
    its gradients (n, 3), or for a study the end points' converged flags (n,))."""
    rng = np.random.default_rng([seed % 2 ** 64, 2])
    chk = traffic["check"]
    picked = sample(rng, len(units), chk["units"])
    ms, vs, gs = [], [], []
    for i in picked:
        u, o = units[i], outputs[i]
        if traffic["kind"] == "study":
            j = sample(rng, o["x"].shape[0], chk["points_per_unit"])
            ms.append(o["x"][j].double())
            vs.append(o["value"][j])
            gs.append(o["converged"][j])
            continue
        m = torch.as_tensor(u["nodes"] if traffic["kind"] == "scan" else u["m"][None])
        n = m.shape[0]
        j = sample(rng, n, chk.get("points_per_unit", n))
        # the lowest node of the scan too, where the gradient is smallest
        j = np.union1d(j, [int(torch.argmin(o["value"]))])
        ms.append(m[j])
        vs.append(o["value"][j])
        gs.append(o["grad"][j])
    return torch.cat(ms), torch.cat(vs), torch.cat(gs)


def grad_end(g_ref, converged) -> float:
    """The largest reference gradient norm at end points reported converged."""
    ok = converged.cpu() > 0
    if not bool(ok.any()):
        return math.inf
    return float(torch.linalg.vector_norm(g_ref.double().cpu()[ok], dim=-1).max())


def unconverged_share(converged: list) -> float:
    """The share of lanes flagged not converged over studies' flags (k,) each."""
    flags = torch.cat([c.cpu().reshape(-1) for c in converged])
    return float((flags <= 0).double().mean())


def judge(numbers: dict, limits: dict) -> bool:
    """Every limited number finite and at or below its limit."""
    return all(math.isfinite(numbers.get(k, math.nan)) and numbers[k] <= lim
               for k, lim in limits.items())


def lines(numbers: dict, limits: dict) -> list[str]:
    """One line per number: name, reading, limit."""
    return [f"{k} {numbers.get(k, math.nan)!r} limit {lim!r}" for k, lim in limits.items()]
