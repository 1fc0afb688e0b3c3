"""Smoke run of the PyTorch port (waveform_ot_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one printed line or more each; any failure raises and the exit code
is non-zero:

  1. setup      card name and power limit (the nvidia-smi line, printed as
                it comes), kernel build time;
  2. kernel     the CUDA distance-field kernel against its plain PyTorch
                version on the card, at the main path's three shapes
                (loc64 batch, Ricker, 800x600 fingerprint), float32 and float64;
  3. loc64      the headline: batched loc/CMT W2 misfit + gradient w.r.t.
                the source location, 64 stations x 3 components, float32 on
                the card, through the kernel (launch count checked), against
                the same problem in float64 on the CPU;
  4. ricker     the Ricker objective in float64 on the card against the
                golden reference values in tests_golden_ref.json;
  5. timing     medians of 20 calls after warm-up: loc64 value+grad in
                float32 and float64, and the kernel against the plain version.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA card it exits non-zero before
printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
NT = 61
LOC = (2.0, -1.5, 12.0)
DM = (4.0, -3.0, 2.0)           # the bench's evaluation point is LOC + DM
N_TIMED = 20
TOL = {torch.float64: 1e-12, torch.float32: 1e-6}
VALUE_RTOL_F32 = 1e-4            # loc64 f32 on the card vs f64 on the CPU
GRAD_TOL_F32 = 1e-3              # ... in units of max |g|
RICKER_W2_TOL = 1e-8             # the JAX package's golden bars
RICKER_GRAD_TOL = 5e-7


def build_loc64_problem(nr: int, dtype, device):
    """The bench's loc/CMT problem (``__graft_entry__._build_problem``) in
    the port: nr stations on a 60 km circle, source at LOC, strike/dip/rake
    30/60/45 with M0 5e6, noise 0.002*max|s| from numpy default_rng(0),
    79x61 grids, lambda 0.04, W2. Returns (loc, cfg, prob)."""
    from waveform_ot_torch.inversion import TraceConfig, build_loc_cmt_problem
    from waveform_ot_torch.models import (
        StationSet, moment_tensor_from_sdr, synthetic_seismograms,
    )

    arr = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    ang = np.linspace(0, 2 * np.pi, nr, endpoint=False)
    stations = StationSet(x=arr(60.0 * np.cos(ang)), y=arr(60.0 * np.sin(ang)))
    loc = arr(LOC)
    mxyz = moment_tensor_from_sdr(30.0, 60.0, 45.0, m0=5.0e6,
                                  device=device).to(dtype)
    t, s = synthetic_seismograms(loc[0], loc[1], loc[2], mxyz, stations,
                                 nt=NT, dt=1.0)
    rng = np.random.default_rng(0)
    obs = s + 0.002 * float(s.abs().max()) * arr(rng.standard_normal(tuple(s.shape)))
    cfg = TraceConfig(nu=79, ntg=NT, lambdav=0.04, q=None, p=2)
    return loc, cfg, build_loc_cmt_problem(t, obs, stations, cfg, mxyz_fixed=mxyz)


def build_ricker_problem(golden: dict, dtype, device):
    """The Ricker_Figs_3_8 problem from the golden observed waveform:
    80x512 grid, arctan transform, W2, alpha 0.5. Returns (prob, cfg)."""
    from waveform_ot_torch.inversion import (
        TraceConfig, build_target, grid6_to_window, make_ricker_problem,
    )

    gd = golden["ricker_full"]
    win, spec = grid6_to_window(gd["grid"], dtype=dtype, device=device)
    cfg = TraceConfig(nu=spec.nu, ntg=spec.ntg, lambdav=gd["lambdav"], q=None,
                      p=2, transform=True)
    arr = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    with torch.no_grad():
        targets = build_target(arr(gd["tobs"]), arr(gd["wobs"])[None], win, cfg)
    prob, cfg = make_ricker_problem(targets, gd["grid"], trange=(-2.0, 7.0),
                                    alpha=0.5, lambdav=gd["lambdav"])
    return prob, cfg


def _field_inputs(t, w, win, spec):
    """(verts, tgrid, ugrid), contiguous, as fingerprint_density forms them."""
    from waveform_ot_torch.ops.fingerprint import grid_axes, normalize_vertices

    verts = normalize_vertices(t, w, win)
    tg, ug = grid_axes(t, win, spec)
    bsz = verts.shape[0]
    return (verts.contiguous(), tg.expand(bsz, spec.ntg).contiguous(),
            ug.expand(bsz, spec.nu).contiguous())


def main_path_shapes(dtype, device, golden):
    """The distance-field inputs of the main path: {name: (verts, tgrid, ugrid)}."""
    from waveform_ot_torch.inversion import InvOptions, apply_transform
    from waveform_ot_torch.inversion.loc_cmt import (
        _flat_unit_windows, predicted_seismograms,
    )
    from waveform_ot_torch.models import ricker_wavelet
    from waveform_ot_torch.ops import FingerprintSpec, arctan_transform, make_window

    with torch.no_grad():
        loc, cfg, prob = build_loc64_problem(64, dtype, device)
        s = predicted_seismograms(loc + torch.tensor(DM, dtype=dtype, device=device),
                                  prob, InvOptions())
        nr, nc, nt = s.shape
        un = arctan_transform(s, prob.windows.u0[..., None], prob.windows.u1[..., None])
        loc64 = _field_inputs(prob.t, un.reshape(nr * nc, nt),
                              _flat_unit_windows(prob.windows, nr, nc), cfg.spec)

        rprob, rcfg = build_ricker_problem(golden, dtype, device)
        m = torch.tensor([0.5, 1.2, 1.1], dtype=dtype, device=device)
        t, w = ricker_wavelet(m[0], m[1], m[2], trange=rprob.trange)
        wn, win01 = apply_transform(w[None], rprob.window, rcfg)
        ricker = _field_inputs(t, wn, win01, rcfg.spec)

        # FingerprintLib's demo at full scale: 626 samples, 800x600 grid
        tb = torch.linspace(0.0, 1.0, 626, dtype=torch.float64)
        wb = 2 * torch.sin(tb * 6 * np.pi) - 3 * torch.cos((2 * tb + 0.30) * 2 * np.pi)
        du = float(wb.max() - wb.min())
        bwin = make_window(0.0, 1.0, float(wb.min()) - 0.15 * du,
                           float(wb.max()) + 0.15 * du, dtype=dtype, device=device)
        bigfp = _field_inputs(tb.to(device, dtype), wb.to(device, dtype)[None], bwin,
                              FingerprintSpec(nu=800, ntg=600))
    return {"loc64": loc64, "ricker": ricker, "bigfp": bigfp}


def compare_fields(got, ref, tol: float) -> dict:
    """The kernel's bars: d to rtol ``tol``; winners differ only at exact
    ties; lam and dvec within ``tol`` where the winners agree."""
    err_d = (got.d - ref.d).abs()
    if not bool((err_d <= tol * ref.d.abs() + 1e-30).all()):
        raise AssertionError(f"d differs: max abs {err_d.max().item():.3e}")
    same = got.iclose == ref.iclose
    tie_err = torch.where(same, 0.0, err_d).max().item()
    if tie_err > tol * max(1.0, ref.d.abs().max().item()):
        raise AssertionError(f"winners differ away from ties ({tie_err:.3e})")
    lam_err = torch.where(same, (got.lam - ref.lam).abs(), 0.0).max().item()
    dvec_err = torch.where(same[..., None], (got.dvec - ref.dvec).abs(), 0.0).max().item()
    if lam_err > tol or dvec_err > tol:
        raise AssertionError(f"lam/dvec differ where winners agree: {lam_err:.3e} {dvec_err:.3e}")
    return {"max_abs_err_d": err_d.max().item(), "tie_flips": int((~same).sum()),
            "lam_err": lam_err, "dvec_err": dvec_err}


def cuda_median_ms(fn, n: int = N_TIMED, warm: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_median_ms(fn, n: int = N_TIMED, warm: int = 3) -> float:
    """Median wall time of one call, synchronized before and after."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from waveform_ot_torch import _build
    from waveform_ot_torch.inversion import (
        InvOptions, loc_cmt_value_and_grad, ricker_value_and_grad,
    )
    from waveform_ot_torch.ops import DistanceField, cuda_distance, distance_field_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    golden = json.loads((REPO / "tests_golden_ref.json").read_text())

    # 1. setup
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    lib = _build.library_path("distance_field")
    how = "reused" if lib.exists() else "built"
    t0 = time.perf_counter()
    cuda_distance._library()
    print(f"[setup] {how} {lib.relative_to(REPO)} in {time.perf_counter() - t0:.2f} s")

    # 2. kernel against its plain version at the main path's shapes
    shapes = {dt: main_path_shapes(dt, dev, golden)
              for dt in (torch.float32, torch.float64)}
    max_abs_err = 0.0
    for dt, by_name in shapes.items():
        for name, args in by_name.items():
            got = DistanceField(*cuda_distance.distance_field_cuda(*args))
            ref = distance_field_torch(*args)
            torch.cuda.synchronize()
            rep = compare_fields(got, ref, TOL[dt])
            max_abs_err = max(max_abs_err, rep["max_abs_err_d"])
            b, nt = args[0].shape[:2]
            print(f"[kernel] {name} {str(dt)[6:]} B={b} nt={nt} "
                  f"grid={args[2].shape[1]}x{args[1].shape[1]}: agree at rtol "
                  f"{TOL[dt]:g}; {json.dumps(rep)}")

    # 3. loc64 value and gradient on the card, float32, through the kernel
    opts = InvOptions(loc=True, cmt=False, mistype="OT")
    loc, cfg, prob32 = build_loc64_problem(64, torch.float32, dev)
    m32 = loc + torch.tensor(DM, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    cuda_distance.LAUNCHES = 0
    v32, g32 = loc_cmt_value_and_grad(m32, prob32, opts, cfg)
    torch.cuda.synchronize()
    launches = cuda_distance.LAUNCHES
    if launches < 1:
        raise AssertionError("loc64 main path launched no distance-field kernel")
    v32, g32 = v32.item(), g32.double().cpu()
    if not (np.isfinite(v32) and torch.isfinite(g32).all()):
        raise AssertionError(f"non-finite loc64 result {v32} {g32}")
    print(f"[loc64] f32 on {torch.cuda.get_device_name(0)}: value {v32!r} grad "
          f"{g32.tolist()} kernel launches {launches}")
    cpu = torch.device("cpu")
    loc64c, cfg64, prob64c = build_loc64_problem(64, torch.float64, cpu)
    v64, g64 = loc_cmt_value_and_grad(loc64c + torch.tensor(DM, dtype=torch.float64),
                                      prob64c, opts, cfg64)
    v64 = v64.item()
    dv = abs(v32 - v64) / abs(v64)
    dg = (g32 - g64).abs().max().item() / g64.abs().max().item()
    print(f"[loc64] f64 on cpu: value {v64!r} grad {g64.tolist()}")
    print(f"[loc64] f32-card vs f64-cpu: value rel dev {dv:.3e} (bound "
          f"{VALUE_RTOL_F32:g}), grad dev / max|g| {dg:.3e} (bound {GRAD_TOL_F32:g})")
    if dv > VALUE_RTOL_F32 or dg > GRAD_TOL_F32:
        raise AssertionError("loc64 f32 deviates from the f64 reference")

    # 4. Ricker float64 on the card against the golden reference
    rprob, rcfg = build_ricker_problem(golden, torch.float64, dev)
    m = torch.tensor([0.5, 1.2, 1.1], dtype=torch.float64, device=dev)
    w2, dm = ricker_value_and_grad(m, rprob, rcfg)
    ref = golden["ricker_obj"]
    w2_err = abs(w2.item() - ref["w2"])
    g_err = float(np.abs(dm.cpu().numpy() - np.asarray(ref["deriv"])).max())
    print(f"[ricker] f64 on card: w2 {w2.item()!r} (|err| {w2_err:.3e}, bound "
          f"{RICKER_W2_TOL:g}), grad {dm.tolist()} (max |err| {g_err:.3e}, bound "
          f"{RICKER_GRAD_TOL:g})")
    if w2_err > RICKER_W2_TOL or g_err > RICKER_GRAD_TOL:
        raise AssertionError("Ricker objective deviates from the golden values")

    # 5. timings (medians of N_TIMED calls after warm-up)
    card = f"[{smi}]"
    _, _, prob64 = build_loc64_problem(64, torch.float64, dev)
    m64 = m32.double()
    for name, fn in (("f32", lambda: loc_cmt_value_and_grad(m32, prob32, opts, cfg)),
                     ("f64", lambda: loc_cmt_value_and_grad(m64, prob64, opts, cfg))):
        print(f"[timing] loc64 value+grad {name}: {host_median_ms(fn):.4f} ms/call "
              f"(host clock, synchronized) {card}")
    times = {}
    for dt, by_name in shapes.items():
        for name, args in by_name.items():
            k = cuda_median_ms(lambda: cuda_distance.distance_field_cuda(*args))
            p = cuda_median_ms(lambda: distance_field_torch(*args))
            times[(name, dt)] = (k, p)
            print(f"[timing] distance field {name} {str(dt)[6:]}: kernel {k:.4f} ms, "
                  f"plain {p:.4f} ms (CUDA events) {card}")

    k, p = times[("loc64", torch.float32)]
    print(json.dumps({"kernels": [{
        "name": "distance_field", "route": "cuda",
        "source": "waveform_ot_torch/csrc/distance_field.cu",
        "replaces": "waveform_ot_tpu/ops/pallas_distance.py:52",
        "launches": launches, "max_abs_err": max_abs_err, "ms": k, "plain_ms": p,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
