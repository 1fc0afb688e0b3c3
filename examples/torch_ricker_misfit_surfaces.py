"""W1/W2 vs L2 misfit surfaces for the double-Ricker problem on the PyTorch
port (reference Ricker_Figs_1_7).

The port's counterpart of examples/ricker_misfit_surfaces.py (lines 24-120).
The reference evaluates the misfit at each (time shift x amplitude) node in a
serial Python loop; here each W1 or W2 profile and surface is one batched
``ricker_misfit`` call over all its models, one distance-field launch on the
card. The L2 misfit has no fingerprint and runs model by model. Float64.

Run: python examples/torch_ricker_misfit_surfaces.py [--n 20] [--plot] [--device cpu]
"""

import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))

import numpy as np
import torch

from waveform_ot_torch.inversion import (
    TraceConfig, build_target, grid6_to_window, ls_misfit, make_ricker_problem, ricker_misfit,
)
from waveform_ot_torch.models import ricker_wavelet
from waveform_ot_torch.utils.profiling import device_label, timed

MTRUE = (0.0, 1.6, 1.0)
TRANGE = (-2.0, 7.0)
GRID6 = (-2.0, 7.0, -2.0, 2.6, 80, 512)


def build_problem(device, grid6=GRID6, dtype=torch.float64) -> dict:
    """The observed double Ricker at MTRUE plus 0.01 max|w| noise from numpy
    default_rng(0), the W2 problem on ``grid6`` and its W1 config."""
    arr = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    tobs, wobs = ricker_wavelet(*arr(MTRUE), trange=TRANGE)
    rng = np.random.default_rng(0)
    wobs = wobs + 0.01 * float(wobs.abs().max()) * arr(rng.standard_normal(tuple(wobs.shape)))
    win, spec = grid6_to_window(grid6, dtype=dtype, device=device)
    cfg = TraceConfig(nu=spec.nu, ntg=spec.ntg, lambdav=0.03, q=None, p=2, transform=True)
    with torch.no_grad():
        targets = build_target(tobs, wobs[None], win, cfg)
    prob, cfg = make_ricker_problem(targets, grid6, trange=TRANGE, alpha=0.5, lambdav=0.03)
    return {"tobs": tobs, "wobs": wobs, "prob": prob, "cfg": cfg,
            "cfg_w1": dataclasses.replace(cfg, p=1)}


def l2_misfits(p: dict, ms):
    """The L2 misfits (k,) of the models ``ms`` (k, 3), model by model."""
    def l2_of(m):
        t, w = ricker_wavelet(m[0], m[1], m[2], trange=TRANGE)
        return ls_misfit(p["tobs"], p["wobs"], t, w, nt=p["wobs"].shape[0])

    return torch.stack([l2_of(m) for m in ms])


def n_local_minima(v) -> int:
    v = np.asarray(v)
    return int(np.sum((v[1:-1] < v[:-2]) & (v[1:-1] <= v[2:])))


def shift_models(shifts, like):
    """(len(shifts), 3) models (shift, 1.6, 1)."""
    s = torch.as_tensor(np.asarray(shifts), dtype=like.dtype, device=like.device)
    return torch.stack([s, torch.full_like(s, 1.6), torch.ones_like(s)], dim=1)


def surface_models(n: int, like):
    """The n x n (time shift, amplitude) grid as (n*n, 3) models, amplitude-major."""
    tv, av = np.meshgrid(np.linspace(-1.5, 1.5, n), np.linspace(0.8, 2.4, n))
    ms = np.stack([tv.ravel(), av.ravel(), np.ones(n * n)], axis=1)
    return torch.as_tensor(ms, dtype=like.dtype, device=like.device)


def profiles(p: dict, nprof: int) -> dict:
    """The W1, W2 and L2 time-shift profiles over nprof shifts in [-3, 3];
    asserts that W1 and W2 have at most two local minima and fewer than
    L2's."""
    shifts = np.linspace(-3.0, 3.0, nprof)
    msp = shift_models(shifts, p["wobs"])
    with torch.no_grad():
        prof = {"w1": ricker_misfit(msp, p["prob"], p["cfg_w1"]),
                "w2": ricker_misfit(msp, p["prob"], p["cfg"]), "l2": l2_misfits(p, msp)}
    prof = {k: v.cpu().numpy() for k, v in prof.items()}
    nmin = {k: n_local_minima(v) for k, v in prof.items()}
    assert nmin["w1"] <= 2 and nmin["w2"] <= 2 and nmin["l2"] > nmin["w2"], \
        "expected W basins wider/fewer than L2's cycle-skipping minima"
    return {"shifts": shifts, "profiles": prof, "profile_minima": nmin}


def surfaces(p: dict, n: int) -> dict:
    """The W2 (timed twice), W1 and L2 surfaces on the n x n grid, their
    minima, and the W2 surface's two host-clock times."""
    ms = surface_models(n, p["wobs"])
    surface = lambda: ricker_misfit(ms, p["prob"], p["cfg"])
    with torch.no_grad():
        _, first_s = timed(surface)
        w2, steady_s = timed(surface)
        surf = {"w2": w2, "w1": ricker_misfit(ms, p["prob"], p["cfg_w1"]),
                "l2": l2_misfits(p, ms)}
    surf = {k: v.cpu().numpy() for k, v in surf.items()}
    msn = ms.cpu().numpy()
    minima = {k: msn[int(np.argmin(v)), :2] for k, v in surf.items()}
    return {"models": msn, "surfaces": surf, "minima": minima, "first_s": first_s,
            "steady_s": steady_s}


def run(device="cuda", n: int = 20) -> dict:
    """The profiles (max(41, n) points) and the n x n surfaces on
    ``device``, with the profiles' assertion; returns both."""
    p = build_problem(device)
    return {**profiles(p, max(41, n)), **surfaces(p, n), "device": device_label(device)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args()
    n = args.n
    r = run(args.device, n=n)
    nm = r["profile_minima"]
    print(f"time-shift profile local minima: W1={nm['w1']} W2={nm['w2']} L2={nm['l2']}")
    print(f"W2 surface {n}x{n} ({n * n} objective evals): {r['first_s']:.3f} s (first call) "
          f"on {r['device']}")
    print(f"steady state: {r['steady_s']:.3f} s on {r['device']}")
    for k in ("w2", "w1", "l2"):
        ts, amp = r["minima"][k]
        print(f"{k.upper()} minimum at tshift={ts:+.3f} amp={amp:.3f}")
    if args.plot:
        from waveform_ot_torch import viz

        tshifts, amps = np.linspace(-1.5, 1.5, n), np.linspace(0.8, 2.4, n)
        for k in ("w2", "l2", "w1"):
            viz.plot_misfit_surface(r["surfaces"][k].reshape(n, n), tshifts, amps,
                                    xtrue=0.0, ytrue=1.6, filename=f"ricker_{k}_surface.png",
                                    xlab="time shift", ylab="amplitude")
        viz.plot_misfit_profiles(r["shifts"], [r["profiles"][k] for k in ("w1", "w2", "l2")],
                                 ["W1", "W2", "L2"], title="Fig-1 time-shift profiles",
                                 filename="ricker_profiles.png")
        print("wrote ricker_w2_surface.png, ricker_l2_surface.png, "
              "ricker_w1_surface.png, ricker_profiles.png")


if __name__ == "__main__":
    main()
