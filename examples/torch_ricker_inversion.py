"""Double-Ricker 3-parameter inversion on the PyTorch port (reference
Ricker_Figs_3_8).

The port's counterpart of examples/ricker_inversion.py (lines 23-74). Fits
(t0, amplitude, frequency) on the weighted marginal-W2 misfit (80x512 grid,
lambda 0.03, arctan transform, alpha 0.5) from m0 = (0.7, 1.1, 1.3), with
gradients from one autograd pass through the fingerprint -> marginal -> OT
pipeline, and recovers mtrue = (0, 1.6, 1). Float64. Each objective
evaluation is one distance-field launch on the card.

By default scipy's L-BFGS-B runs the inversion, recorded by an
InversionTrace. ``--zoom`` runs the on-device solver instead,
``minimize_lbfgs`` (optax's L-BFGS with the zoom line search, max_iter 100):
the JAX script calls that switch ``--device``, which in the port's scripts
names the torch device.

Run: python examples/torch_ricker_inversion.py [--zoom] [--plot] [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))

import numpy as np
import torch

from waveform_ot_torch.inversion import (
    InversionTrace, TraceConfig, build_target, grid6_to_window, make_ricker_problem,
    minimize_lbfgs, minimize_scipy, ricker_misfit, ricker_value_and_grad,
)
from waveform_ot_torch.models import ricker_wavelet

MTRUE = (0.0, 1.6, 1.0)
M0 = (0.7, 1.1, 1.3)
TRANGE = (-2.0, 7.0)
GRID6 = (-2.0, 7.0, -2.0, 2.6, 80, 512)
LAMBDA = 0.03


def build_problem(device, grid6=GRID6, dtype=torch.float64):
    """The observed double Ricker at MTRUE plus 0.005 max|w| noise from
    numpy default_rng(42), on ``grid6``: (prob, cfg, m0)."""
    arr = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    tobs, wobs = ricker_wavelet(*arr(MTRUE), trange=TRANGE)
    rng = np.random.default_rng(42)
    wobs = wobs + 0.005 * float(wobs.abs().max()) * arr(rng.standard_normal(tuple(wobs.shape)))
    win, spec = grid6_to_window(grid6, dtype=dtype, device=device)
    cfg = TraceConfig(nu=spec.nu, ntg=spec.ntg, lambdav=LAMBDA, q=None, p=2, transform=True)
    with torch.no_grad():
        targets = build_target(tobs, wobs[None], win, cfg)
    prob, cfg = make_ricker_problem(targets, grid6, trange=TRANGE, alpha=0.5, lambdav=LAMBDA)
    return prob, cfg, arr(M0)


def invert(prob, cfg, m0, zoom: bool = False, max_iter: int = 100) -> dict:
    """scipy L-BFGS-B with an InversionTrace, or with ``zoom`` the on-device
    minimize_lbfgs(max_iter); returns the solution, its misfit, the
    iteration count and the objective evaluations (value+grad calls)."""
    if zoom:
        calls = 0

        def fn(ms):
            nonlocal calls
            calls += 1
            return ricker_misfit(ms, prob, cfg)

        res = minimize_lbfgs(fn, m0, max_iter=max_iter)
        return {"x": res.x.cpu().numpy(), "fun": res.fun.item(), "nit": int(res.n_iter),
                "evaluations": calls}
    trace = InversionTrace()
    vg = trace.wrap_objective(lambda m: ricker_value_and_grad(m, prob, cfg))
    res = minimize_scipy(vg, m0, callback=trace.scipy_callback())
    return {"x": res.x, "fun": float(res.fun), "nit": int(res.nit), "evaluations": int(res.nfev),
            "misfits": list(trace.misfits)}


def run(device="cuda", zoom: bool = False) -> dict:
    """The inversion on ``device``; asserts that it recovers the truth
    within 0.05 and returns its numbers."""
    prob, cfg, m0 = build_problem(device)
    out = invert(prob, cfg, m0, zoom=zoom)
    out["err"] = np.abs(out["x"] - np.asarray(MTRUE))
    assert out["err"].max() < 0.05, "inversion failed to recover the truth"
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--zoom", action="store_true",
                    help="the on-device zoom L-BFGS (JAX's --device) instead of scipy")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args()
    print("start:", np.asarray(M0), " true:", np.asarray(MTRUE))
    r = run(args.device, zoom=args.zoom)
    if args.zoom:
        print(f"on-device LBFGS: {r['nit']} iters, {r['evaluations']} value+grad calls, "
              f"final w2={r['fun']:.3e}")
    else:
        print(f"scipy L-BFGS-B: {r['nit']} iters, {r['evaluations']} evals, "
              f"final w2={r['fun']:.3e}")
        if args.plot:
            from waveform_ot_torch import viz

            viz.plot_misfit_trace(r["misfits"], filename="ricker_convergence.png")
            print("wrote ricker_convergence.png")
    print("recovered:", r["x"])
    print("abs error:", r["err"])
    print("OK")


if __name__ == "__main__":
    main()
