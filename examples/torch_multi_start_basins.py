"""Convergence-basin comparison, W2 vs L2, from many starting points on the
PyTorch port (reference source_location_cmt_W2L2_Fig_12).

The port's counterpart of examples/multi_start_basins.py (lines 36-156).
The reference runs one scipy inversion per start in a Python loop; here all
starts run as one batched L-BFGS per misfit type, and every batched
evaluation of the OT misfit is one distance-field launch on the card.

Modes (Fig_12 cells 34-47):
  * location only (default): 3-dim (x, y, z) starts on a grid;
  * ``--cmt``: the notebook's joint loc+CMT mode, a 9-dim parameter space,
    each start's moment-tensor block from the linear least-squares solve at
    that start (cell 43; ``moment_tensor_ls`` with the forward at that
    start, one call per start), constant preconditioning
    (mscal = [60 km x3, max |M| x6]).

Physics: the layered-medium f-k forward (models/layered.py) on the
reference's six-layer Fukuoka model by default, solved by
``minimize_lbfgs_batched_host`` (eval_chunk 16), or the homogeneous far-field
synthetic with ``--physics farfield``, solved by ``minimize_multi_start``.
Float64. Prints per misfit the share of starts that end within 2 km of the
source (``check_convergence``) and the lanes whose line search failed.

Run: python examples/torch_multi_start_basins.py [--nstarts 16] [--nr 8]
         [--cmt] [--physics layered|farfield] [--nk 256] [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))

import numpy as np
import torch

from waveform_ot_torch.inversion import (
    InvOptions, TraceConfig, build_loc_cmt_problem, check_convergence, loc_cmt_misfit,
    minimize_lbfgs_batched_host, minimize_multi_start,
)
from waveform_ot_torch.models import (
    StationSet, fukuoka_model, make_layered_forward, moment_tensor_from_sdr,
    moment_tensor_ls, mxyz_from_upper, synthetic_seismograms, upper_from_mxyz,
)
from waveform_ot_torch.utils.profiling import device_label, timed

NT = 61
F64 = torch.float64


def ls_block(l, stations, obs, forward=None):
    """The least-squares moment tensor (6 upper-triangle entries) at the
    location ``l`` (3,), through ``forward`` (the layered physics at that
    location) or the far-field default."""
    fwd = None if forward is None else (
        lambda m6: forward(l[0].expand(6), l[1].expand(6), l[2].expand(6), mxyz_from_upper(m6)))
    with torch.no_grad():
        return moment_tensor_ls(l, stations, obs, nt=NT, dt=1.0, forward=fwd)


def build_study(device, nstarts: int = 16, nr: int = 8, cmt: bool = False,
                physics: str = "layered", nk: int = 256) -> dict:
    """Stations on a 60 km circle, the source, noisy observed data (numpy
    default_rng(3)), the W2 problem and the (scaled) starts; in the joint
    mode the starts carry their least-squares moment tensors."""
    arr = lambda a: torch.as_tensor(np.asarray(a), dtype=F64, device=device)
    ang = np.linspace(0, 2 * np.pi, nr, endpoint=False)
    stations = StationSet(x=arr(60.0 * np.cos(ang)), y=arr(60.0 * np.sin(ang)))
    loc_true = arr([2.0, -1.5, 12.0])
    mxyz = moment_tensor_from_sdr(30.0, 60.0, 45.0, m0=5.0e6, device=device).to(F64)
    if physics == "layered":
        forward = make_layered_forward(stations, model=fukuoka_model(device=device), nt=NT,
                                       dt=1.0, nk=nk)
        t = torch.arange(NT, dtype=F64, device=device)
        with torch.no_grad():
            s = forward(*loc_true, mxyz)
    else:
        forward = None
        t, s = synthetic_seismograms(*loc_true, mxyz, stations, nt=NT, dt=1.0)
    rng = np.random.default_rng(3)
    obs = s + 0.005 * float(s.abs().max()) * arr(rng.standard_normal(tuple(s.shape)))
    cfg = TraceConfig(nu=79, ntg=NT, lambdav=0.04, q=None, p=2)
    prob = build_loc_cmt_problem(t, obs, stations, cfg, mxyz_fixed=mxyz)

    k = int(np.sqrt(nstarts))
    # the 9-dim joint mode starts nearer the source: with the homogeneous
    # far-field physics the joint OT/L2 landscapes carry local minima beyond
    # ~20 km (a landscape property, not a solver one), unlike the reference's
    # layered Fukuoka setup whose OT basin spans its (-40, -40, 40) start
    span = 12.0 if cmt else 50.0
    gx, gy = np.meshgrid(np.linspace(-span, span, k), np.linspace(-span, span, k))
    loc = loc_true.cpu().numpy()
    starts = arr(np.stack([gx.ravel() + loc[0], gy.ravel() + loc[1], np.full(k * k, 10.0)], 1))
    m_true = loc
    mscal = torch.ones(3, dtype=F64, device=device)
    if cmt:
        # per-start CMT block from the linear LS solve at that start (Fig_12
        # cell 43: mstart = append(mstart, Moment_LS(mstart, ...)))
        m6s = torch.stack([ls_block(l, stations, obs, forward) for l in starts])
        mscal = torch.cat([torch.full((3,), 60.0, dtype=F64, device=device),
                           torch.full((6,), float(upper_from_mxyz(mxyz).abs().max()), dtype=F64,
                                      device=device)])
        prob = prob._replace(mscal=mscal)
        starts = torch.cat([starts, m6s], dim=1) / mscal
        m_true = np.concatenate([loc, upper_from_mxyz(mxyz).cpu().numpy()])
    return {"physics": physics, "cmt": cmt, "cfg": cfg, "prob": prob, "forward": forward,
            "starts": starts, "mscal": mscal, "m_true": m_true, "stations": stations,
            "obs": obs}


def solve(st: dict, mistype: str, max_iter: int | None = None) -> dict:
    """One batched study of ``mistype``: the solutions (unscaled), each
    start's distance to the source, the share within 2 km, the line-search
    failures, the host-clock seconds and the objective calls (one per
    batched evaluation of every start, one launch each on the card for OT).
    ``max_iter`` defaults to the script's 600 in the joint mode (the 9-dim
    OT surface is ill-conditioned in the tensor block; scipy needs ~300
    evaluations there too), else 150."""
    cmt = st["cmt"]
    opts = InvOptions(loc=True, cmt=cmt, mistype=mistype, precon=cmt)
    calls = 0

    def fn(ms):
        nonlocal calls
        calls += 1
        return loc_cmt_misfit(ms, st["prob"], opts, st["cfg"], forward=st["forward"])

    if max_iter is None:
        max_iter = 600 if cmt else 150
    if st["physics"] == "layered":
        res, secs = timed(lambda: minimize_lbfgs_batched_host(fn, st["starts"], max_iter=max_iter,
                                                              eval_chunk=16))
    else:
        res, secs = timed(lambda: minimize_multi_start(fn, st["starts"], max_iter=max_iter))
    mscal = st["mscal"].cpu().numpy()
    sol = res.x.cpu().numpy() * mscal
    start = st["starts"].cpu().numpy() * mscal
    _, dist, _, frac = check_convergence(start[:, :3], sol[:, :3], st["m_true"], dlimit=2.0,
                                         exclude_edge=None)
    out = {"x": sol, "dist": dist, "frac": frac, "n_iter": res.n_iter.cpu().numpy(),
           "ls_failed": int(res.ls_failed.sum()), "seconds": secs, "evaluations": calls}
    if cmt:
        mt = st["m_true"][3:]
        out["cmt_rel_err"] = (np.abs(sol[:, 3:] - mt) / np.abs(mt).max()).max(axis=1)
    return out


def run(device="cuda", nstarts: int = 16, nr: int = 8, cmt: bool = False,
        physics: str = "layered", nk: int = 256) -> dict:
    """The OT and the L2 study on ``device``; returns each one's numbers."""
    st = build_study(device, nstarts=nstarts, nr=nr, cmt=cmt, physics=physics, nk=nk)
    return {"starts": len(st["starts"]), "device": device_label(device),
            **{m: solve(st, m) for m in ("OT", "L2")}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nstarts", type=int, default=16)
    ap.add_argument("--nr", type=int, default=8)
    ap.add_argument("--cmt", action="store_true", help="joint 9-dim loc+CMT mode (Fig_12 cmt=True)")
    ap.add_argument("--physics", choices=("layered", "farfield"), default="layered")
    ap.add_argument("--nk", type=int, default=256,
                    help="wavenumber samples for the layered forward")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args()
    r = run(args.device, nstarts=args.nstarts, nr=args.nr, cmt=args.cmt, physics=args.physics,
            nk=args.nk)
    for mistype in ("OT", "L2"):
        o = r[mistype]
        line = (f"{mistype}: {r['starts']} starts in {o['seconds']:.2f} s on {r['device']} -> "
                f"{100 * o['frac']:.0f}% converged (median loc |err| = "
                f"{np.median(o['dist']):.2f} km")
        if args.cmt:
            line += f", median CMT rel err = {np.median(o['cmt_rel_err']):.3f}"
        if o["ls_failed"]:
            line += f", {o['ls_failed']} linesearch-frozen lanes"
        print(line + f"; {o['evaluations']} batched evaluations)")


if __name__ == "__main__":
    main()
