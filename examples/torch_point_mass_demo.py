"""Point-mass 1-D optimal transport demo on the PyTorch port (reference
Point_mass_demo_Fig_5).

The port's counterpart of examples/point_mass_demo.py (lines 22-62): W1 and
W2 between two sets of point masses by the exact CDF/quantile solver, the
transport plan, the barycentric path, and the numerical-integration and LP
oracles of ``waveform_ot_torch.ops.validate``. Float64. No distance field is
computed, so the CUDA kernel is not launched.

Run: python examples/torch_point_mass_demo.py [--plot] [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))

import numpy as np
import torch

from waveform_ot_torch.ops import make_density_1d, transport_plan_1d, wasserstein_1d
from waveform_ot_torch.ops.barycenter import barycenter_pointmass
from waveform_ot_torch.ops.validate import wasserstein_linprog, wasserstein_numint

# the exact Fig-5 configuration (Point_mass_demo_Fig_5.ipynb cells 3-13):
# expected W1 = 4.11, W2^2 = 18.09
FX = np.linspace(3.0, 14.0, 6)
GX = np.linspace(7.0, 18.0, 6)
F = np.array([0.2, 0.01, 0.18, 0.21, 0.2, 0.2])
G = np.array([0.18, 0.07, 0.2, 0.05, 0.27, 0.23])


def run(device="cuda") -> dict:
    """W1, W2^2, the oracles' values, the plan and the barycentric path on
    ``device``; returns them (the plan and path as NumPy)."""
    arr = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    f, fx, g, gx = arr(F), arr(FX), arr(G), arr(GX)
    w1, w2 = (wasserstein_1d(f[None], fx[None], g[None], gx[None], p).item() for p in (1, 2))
    w1n, w2n = wasserstein_numint(F, FX, G, GX)
    wlp = wasserstein_linprog(F, FX, G, GX, p=2)
    plan = transport_plan_1d(f, fx, g, gx)
    rows_ok = bool(torch.allclose(plan.sum(1), f / f.sum()))
    src, tgt = make_density_1d(f, fx), make_density_1d(g, gx)
    pos, mass = barycenter_pointmass(src, tgt, np.linspace(0, 1, 5))
    return {"w1": w1, "w2": w2, "w1_numint": w1n, "w2_numint": w2n, "w2_linprog": wlp,
            "plan_rows_ok": rows_ok, "plan": plan.cpu().numpy(),
            "path_pos": pos.cpu().numpy(), "path_mass": mass.cpu().numpy()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args()
    r = run(args.device)
    print(f"W1          = {r['w1']:.10f}   (Fig 5: 4.11)")
    print(f"W2^2        = {r['w2']:.10f}   (Fig 5: 18.09)")
    print(f"numint      : W1={r['w1_numint']:.6f} W2^2={r['w2_numint']:.6f}")
    print(f"linprog W2^2= {r['w2_linprog']:.10f}")
    print("plan row sums == f:", r["plan_rows_ok"])
    print("barycenter path shape:", r["path_pos"].shape)
    if args.plot:
        from waveform_ot_torch import viz

        src = make_density_1d(torch.as_tensor(F), torch.as_tensor(FX))
        tgt = make_density_1d(torch.as_tensor(G), torch.as_tensor(GX))
        viz.plot_wasser_panels(src, tgt, filename="pointmass_panels.png")
        viz.plot_transport_plan(r["plan"], filename="pointmass_plan.png")
        print("wrote pointmass_panels.png, pointmass_plan.png")


if __name__ == "__main__":
    main()
