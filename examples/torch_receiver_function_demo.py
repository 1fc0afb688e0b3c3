"""Receiver-function fingerprint demo on the PyTorch port (the FingerprintLib
``__main__`` flow).

The port's counterpart of examples/receiver_function_demo.py (lines 24-93).
It rebuilds the reference's self-demo (libs/FingerprintLib.py:893-1047): a
synthetic receiver-function-style waveform (626 samples) and its 800x600
fingerprint density (lambda 0.04) by both methods, the exact polyline
distance field (``compat.waveformFP.calcpdf(method="Enumerate")``, one
distance-field launch on the card) and fast marching from the +/-1 indicator
(``ops.fmm.distance_field_fmm``, the package's host C++ solver in place of
scikit-fmm), with the field statistics and the FMM-vs-exact error over the
band d > 2/nu. Float64. ``--small`` is 63 samples on an 80x60 grid.

``--outdir DIR`` writes the demo's four figures there (phi level sets, the
distance and PDF level sets, rays back to the waveform) through
``waveform_ot_torch.viz``; without it nothing is drawn.

Run: python examples/torch_receiver_function_demo.py [--small] [--outdir DIR] [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))

import numpy as np

from waveform_ot_torch.compat import waveformFP
from waveform_ot_torch.ops.fmm import distance_field_fmm, fmm_ray_endpoints, signed_indicator
from waveform_ot_torch.utils.profiling import device_label, timed


def run(device="cuda", small: bool = False) -> dict:
    """Both fields of the demo waveform on ``device``: the statistics the
    script prints, the two fields' host-clock seconds, and under "figures"
    what the figures draw."""
    # synthetic RF waveform (FingerprintLib.py:932-936)
    nt = 63 if small else 626
    t = np.linspace(0.0, 1.0, nt)
    rf = 2 * np.sin(t * 6 * np.pi) - 3 * np.cos((2 * t + 0.30) * 2 * np.pi)
    du = rf.max() - rf.min()
    u0, u1 = rf.min() - 0.15 * du, rf.max() + 0.15 * du
    nu, ntg = (80, 60) if small else (800, 600)
    lambdav = 0.04

    # the exact polyline field (the reference's Enumerate branch)
    wf = waveformFP(t, rf, (t[0], t[-1], u0, u1, nu, ntg), device=device)
    _, exact_s = timed(lambda: wf.calcpdf(lambdav=lambdav, method="Enumerate"))
    d_exact = np.asarray(wf.dfield)

    # fast marching from the indicator (the reference's fmm=True branch)
    tgrid, ugrid = np.linspace(0.0, 1.0, ntg), np.linspace(0.0, 1.0, nu)
    tn = (t - t[0]) / (t[-1] - t[0])
    un = (rf - u0) / (u1 - u0)
    d_fmm, fmm_s = timed(distance_field_fmm, tn, un, tgrid, ugrid)

    pdf = np.asarray(wf.pdf)
    err = np.abs(d_fmm - d_exact)
    band = d_exact > 2.0 / nu
    xw, yw = fmm_ray_endpoints(d_fmm, ((ugrid[-1] - ugrid[0]) / nu, (tgrid[-1] - tgrid[0]) / ntg))
    figures = {"tn": tn, "un": un, "tgrid": tgrid, "ugrid": ugrid, "d_exact": d_exact,
               "pdf": pdf, "fld": wf._fld}
    return {"lambdav": lambdav, "nt": ntg, "nu": nu, "dmin": float(d_exact.min()),
            "dmax": float(d_exact.max()), "pdfmin": float(pdf.min()), "pdfmax": float(pdf.max()),
            "exact_s": exact_s, "fmm_s": fmm_s, "band_median": float(np.median(err[band])),
            "band_max": float(err[band].max()), "cell": 1.0 / nu,
            "rays_t": (float(xw.min()), float(xw.max())),
            "rays_u": (float(yw.min()), float(yw.max())),
            "device": device_label(device), "figures": figures}


def draw(figures: dict, outdir) -> None:
    """The reference demo's figures: phi level sets, distance/PDF level
    sets, rays back to the waveform (plot_phi / plot_LS / plot_rays)."""
    from waveform_ot_torch import viz

    out = pathlib.Path(outdir)
    f = figures
    phi = signed_indicator(f["tn"], f["un"], f["tgrid"], f["ugrid"])
    viz.plot_phi(f["tn"], f["un"], f["tgrid"], f["ugrid"], phi=phi,
                 filename=str(out / "rf_phi.png"))
    verts = np.stack([f["tn"], f["un"]], axis=1)
    for name in ("d_exact", "pdf"):
        viz.plot_fingerprint(f[name], waveform_verts=verts, tgrid=f["tgrid"], ugrid=f["ugrid"],
                             filename=str(out / f"rf_{'dfield' if name == 'd_exact' else name}.png"))
    viz.plot_rays(f["fld"], verts, f["tgrid"], f["ugrid"], filename=str(out / "rf_rays.png"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="downsampled waveform + 80x60 grid")
    ap.add_argument("--outdir", default=None, help="write the four figures here")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args()
    r = run(args.device, small=args.small)
    print(f" Lambda  {r['lambdav']}\n Nt      {r['nt']}\n Nu      {r['nu']}")
    print(f" Dmin    {r['dmin']:.6f}\n Dmax    {r['dmax']:.6f}")
    print(f" PDFmin  {r['pdfmin']:.3e}\n PDFmax  {r['pdfmax']:.6f}")
    print(f"\n exact polyline field : {r['exact_s']:.3f} s (on {r['device']})")
    print(f" native fast marching : {r['fmm_s']:.3f} s (host C++)")
    print(f" FMM vs exact: median |diff| {r['band_median']:.5f}, max {r['band_max']:.5f} "
          f"(grid cell {r['cell']:.5f})")
    print(f" FMM ray endpoints span t [{r['rays_t'][0]:.3f}, {r['rays_t'][1]:.3f}], "
          f"u [{r['rays_u'][0]:.3f}, {r['rays_u'][1]:.3f}]")
    if args.outdir is not None:
        draw(r["figures"], args.outdir)
        print(f" figures -> {args.outdir}/rf_*.png")


if __name__ == "__main__":
    main()
