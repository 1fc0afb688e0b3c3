"""Derivative chain walkthrough with finite-difference verification on the
PyTorch port (reference Ricker_waveform_derivatives notebook).

The port's counterpart of examples/derivative_walkthrough.py (lines 40-110).
It checks every derivative stage of the pipeline against central
differences: the distance field w.r.t. waveform amplitudes, the trace's
marginal-Wasserstein misfit w.r.t. the waveform, and the end-to-end dW/dm of
the Ricker objective by one autograd pass. The reference runs these
interactively (cells 31, 36, 41, 50); here it is one script printing the
largest errors, each asserted below 1e-6.

Float64 on ``--device``: the JAX script pins itself to the CPU for float64,
the card computes it natively. Every value and gradient is one
distance-field launch there.

Run: python examples/torch_derivative_walkthrough.py [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))

import numpy as np
import torch

from waveform_ot_torch.inversion import (
    TraceConfig, build_target, grid6_to_window, make_ricker_problem, ricker_misfit,
    ricker_value_and_grad, trace_misfit,
)
from waveform_ot_torch.models import ricker_wavelet
from waveform_ot_torch.ops import (
    FingerprintSpec, distance_field_diff, grid_axes, make_window, normalize_vertices,
)

GRID6 = (-2.0, 7.0, -2.0, 2.6, 80, 512)
TRANGE = (-2.0, 7.0)
F64 = torch.float64


def fd(fn, x, eps=1e-6, idxs=None) -> dict:
    """Central differences {i: (fn(x + eps e_i) - fn(x - eps e_i)) / (2 eps)}."""
    idxs = range(x.numel()) if idxs is None else idxs
    out = {}
    with torch.no_grad():
        for i in idxs:
            e = torch.zeros_like(x).reshape(-1)
            e[i] = eps
            e = e.reshape(x.shape)
            out[i] = (float(fn(x + e)) - float(fn(x - e))) / (2 * eps)
    return out


def grad(fn, x):
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(fn(x), x)
    return g


def walkthrough(device, grid6=GRID6) -> dict:
    """The three stages on ``device``, stages 2 and 3 on ``grid6``: each
    stage's autograd derivatives, central differences and their largest
    difference."""
    arr = lambda a: torch.as_tensor(np.asarray(a), dtype=F64, device=device)
    rng = np.random.default_rng(1)

    # stage 1: distance field w.r.t. waveform amplitudes --------------------
    nt = 40
    tn = np.linspace(-2.0, 2.0, nt)
    t = arr(tn)
    w = arr(np.sin(3 * tn) + 0.05 * rng.standard_normal(nt))
    win = make_window(-2.0, 2.0, float(w.min()) - 0.3, float(w.max()) + 0.3, dtype=F64,
                      device=device)
    spec = FingerprintSpec(nu=24, ntg=nt)

    def dsum(w_):
        v = normalize_vertices(t, w_[None], win)
        tg, ug = grid_axes(t, win, spec)
        return torch.sin(distance_field_diff(v, tg[None], ug[None])).sum()

    idx1 = [0, 5, 17, 33]
    g1, fd1 = grad(dsum, w), fd(dsum, w, idxs=idx1)

    # stage 2: full trace misfit w.r.t. the waveform -------------------------
    mtrue = arr((0.0, 1.6, 1.0))
    tobs, wobs = ricker_wavelet(*mtrue, trange=TRANGE)
    wobs = wobs + 0.01 * wobs.abs().max() * arr(rng.standard_normal(tuple(wobs.shape)))
    win2, _ = grid6_to_window(grid6, dtype=F64, device=device)
    cfg = TraceConfig(nu=grid6[4], ntg=grid6[5], lambdav=0.03, q=None, p=2, transform=True)
    with torch.no_grad():
        targets = build_target(tobs, wobs[None], win2, cfg)
    tp, wp = ricker_wavelet(*arr((0.4, 1.2, 1.1)), trange=TRANGE)

    def wsum(w_):
        wt, wu = trace_misfit(tp, w_[None], win2, targets, cfg)
        return 0.5 * (wt + wu)[0]

    # indices inside the active wavelet: in the flat tails an amplitude
    # perturbation flips nearest segments and central differences break
    # (the reference documents this caveat at FingerprintLib.py:517)
    idx2 = [90, 128, 180]
    g2, fd2 = grad(wsum, wp), fd(wsum, wp, idxs=idx2)

    # stage 3: end-to-end dW/dm via one value_and_grad -----------------------
    prob, cfg3 = make_ricker_problem(targets, grid6, trange=TRANGE, alpha=0.5, lambdav=0.03)
    m = arr((0.4, 1.2, 1.1))
    w2, dm = ricker_value_and_grad(m, prob, cfg3)
    fd3 = fd(lambda mm: ricker_misfit(mm, prob, cfg3), m)

    out = {}
    for k, g, fds in (("1", g1, fd1), ("2", g2, fd2), ("3", dm, fd3)):
        ga = np.array([float(g[i]) for i in fds])
        fa = np.array(list(fds.values()))
        out[f"grad{k}"], out[f"fd{k}"] = ga, fa
        out[f"err{k}"] = np.abs(ga - fa)
    out["w2"], out["dm"] = w2.item(), dm.cpu().numpy()
    return out


def run(device="cuda") -> dict:
    """The walkthrough on ``device``; asserts every stage's largest
    central-difference error below 1e-6 and returns the stages' numbers."""
    r = walkthrough(device)
    assert r["err1"].max() < 1e-6 and r["err2"].max() < 1e-6 and r["err3"].max() < 1e-6
    return r


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    r = run(ap.parse_args().device)
    print(f"stage 1  d(distance field)/d(amplitude)  max FD err = {r['err1'].max():.2e}")
    print(f"stage 2  dW/d(waveform amplitude)        max FD err = {r['err2'].max():.2e}")
    e = r["err3"]
    print(f"stage 3  dW/dm (t0, amp, freq) vs FD     errs = {e[0]:.2e} {e[1]:.2e} {e[2]:.2e}")
    print(f"         W2 = {r['w2']:.6e}, grad = {r['dm']}")
    print("OK - all derivative stages verified by central differences")


if __name__ == "__main__":
    main()
