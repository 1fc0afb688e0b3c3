"""Throughput scaling study on one card, on the PyTorch port.

The port's counterpart of examples/scaling_study.py (lines 23-78). It times
the batched W2 misfit + gradient w.r.t. the source location at 64, 256 and
1,024 stations (3 traces each; 61-sample traces, 79x61 grids; ``--quick``:
64 and 256) through ``utils.profiling.benchmark`` (30 calls after 2 warm-up
calls, synchronized with the card), and complete multi-start inversions,
16 and 32 simultaneous ones (``--quick``: 16), through
``minimize_multi_start`` (max_iter 50, tol 1e-6) at 16 stations. Float32,
as in JAX. The problem is ``chip_smoke.build_loc64_problem``, the port's
copy of the bench's loc/CMT problem. Every value+grad call and every batched
evaluation is one distance-field launch on the card.

Run: python examples/torch_scaling_study.py [--quick] [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))

import numpy as np
import torch

from chip_smoke import DM, build_loc64_problem
from waveform_ot_torch.inversion import (
    InvOptions, loc_cmt_misfit, loc_cmt_value_and_grad, minimize_multi_start,
)
from waveform_ot_torch.utils.profiling import benchmark, device_label, timed

OPTS = InvOptions(loc=True, cmt=False, mistype="OT")


def time_value_and_grad(nr: int, device, n_iter: int = 30, dtype=torch.float32) -> dict:
    """Host-clock seconds per value+grad call at nr stations, at the
    bench's evaluation point (source + (4, -3, 2) km), the traces per
    second, and the value and gradient of that call."""
    loc, cfg, prob = build_loc64_problem(nr, dtype, device)
    m = loc + torch.tensor(DM, dtype=dtype, device=device)
    fn = lambda mm, pp: loc_cmt_value_and_grad(mm, pp, OPTS, cfg)
    sec = benchmark(fn, m, prob, n_iter=n_iter)
    v, g = fn(m, prob)
    return {"stations": nr, "traces": 3 * nr, "seconds": sec, "traces_per_s": 3 * nr / sec,
            "value": v.item(), "grad": g.cpu().numpy()}


def inversions(k: int, device, nr: int = 16, max_iter: int = 50, dtype=torch.float32) -> dict:
    """k simultaneous inversions (at most max_iter iterations, tol 1e-6)
    from source + 20 km normal noise (numpy default_rng(0)), run twice (the
    first a warm-up, as in JAX); the second run's host-clock seconds, the
    share of starts within 2 km of the source, the median iterations and
    the batched evaluations of both runs."""
    loc, cfg, prob = build_loc64_problem(nr, dtype, device)
    calls = 0

    def fn(ms):
        nonlocal calls
        calls += 1
        return loc_cmt_misfit(ms, prob, OPTS, cfg)

    rng = np.random.default_rng(0)
    starts = torch.as_tensor(loc.cpu().numpy()[None, :] + 20.0 * rng.standard_normal((k, 3)),
                             dtype=dtype, device=device)
    solve = lambda: minimize_multi_start(fn, starts, max_iter=max_iter, tol=1e-6)
    solve()
    res, sec = timed(solve)
    err = np.linalg.norm(res.x.double().cpu().numpy() - loc.double().cpu().numpy(), axis=1)
    return {"k": k, "seconds": sec, "ms_per_inversion": sec / k * 1e3,
            "converged": float(np.mean(err < 2.0)),
            "median_iters": int(np.median(res.n_iter.cpu().numpy())), "evaluations": calls}


def run(device="cuda", quick: bool = False) -> dict:
    """The timings and the inversions on ``device``."""
    sizes = [64, 256] if quick else [64, 256, 1024]
    return {"device": device_label(device),
            "value_and_grad": [time_value_and_grad(nr, device) for nr in sizes],
            "inversions": [inversions(k, device) for k in ([16] if quick else [16, 32])]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args()
    print(f"device: {device_label(args.device)}\n")
    r = run(args.device, quick=args.quick)
    print("batched W2 misfit + gradient (61-sample traces, 79x61 grids, float32):")
    for s in r["value_and_grad"]:
        print(f"  {s['stations']:5d} stations ({s['traces']:5d} traces): "
              f"{s['seconds'] * 1e3:8.3f} ms/call  = {s['traces_per_s']:10.0f} traces/s "
              f"on {r['device']}")
    print("\ncomplete inversions (batched L-BFGS, 50 iters max, float32):")
    for o in r["inversions"]:
        print(f"  {o['k']:3d} simultaneous inversions: {o['seconds']:7.2f} s "
              f"({o['ms_per_inversion']:7.1f} ms/inversion), {o['converged'] * 100:3.0f}% "
              f"converged, median iters {o['median_iters']} on {r['device']}")


if __name__ == "__main__":
    main()
