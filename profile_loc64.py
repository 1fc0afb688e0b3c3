"""Where the time of a loc/CMT workload goes, on one CUDA card.

    python3 profile_loc64.py [--workload W] [--out FILE]

Builds the workload's problem as chip_smoke.py does (float32, 79x61 grids):

  loc64         one value+grad call at 64 stations x 3 components (10 calls);
  scan          value+grad at the 1,764 scan nodes, 11 stations (3 calls);
  study         the 64-start study through minimize_multi_start, 11 stations
                (1 call: the whole study, solver included);
  layered       one value+grad through the six-layer layered physics, 11
                stations, nk 512 (10 calls);
  layered_scan  layered_misfit_grid at the 1,764 scan nodes (3 calls);
  layered_ms    the 64-start study through minimize_lbfgs_batched_host and
                the layered physics (1 call);
  toolbox       chip_smoke.py phase 12's sliced and Sinkhorn calls, float64,
                each profiled on its own: SlicedWasserstein (10 slices, with
                derivatives) and the Gaussian Sinkhorn (250 steps) between the
                800x600 fingerprints (3 calls each), Sinkhorn_MS (5001 steps)
                and sinkhorn_log (500 steps) at the 40x120 grid (1 call each),

warms up, then runs the calls under torch.profiler and prints, per call:

  - the host-clock time (synchronized) and the device busy time, i.e. the
    union of the device-side intervals, with their ratio (busy share);
  - the device operations (kernels, memsets, copies) and kernel launch
    calls (cudaLaunchKernel, and cuLaunchKernel, which cuBLAS uses);
  - the device operations with the most time, each with its share of the
    busy time.

For the layered workloads it then profiles one evaluation split into its
stages, with a synchronisation between them, and prints each stage's share
of the device busy time and its host-clock time: stage A (the surface
operators and their depth tangent), stage B (response, Bessel assembly, synthesis), the misfit
(fingerprint, distance-field kernel, 1-D OT) and the backward pass, with the
kernel's own share; at layered_ms the evaluation is one value+grad of all 64
starts.

``--out`` also writes the profiler's full table there. Without a CUDA card
it exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import subprocess
import sys

import torch
from torch.autograd import DeviceType

from chip_smoke import (
    DM, KERNEL_NAME, NR_STUDY, RF_LAMBDA, RF_SHIFT, SINKHORN_ITERS, SINKHORN_SIGMA_PX,
    TOOLBOX_NPROJ,
    build_layered_problem, build_loc64_problem, fingerprint_pdfs, migration_waveforms,
    rf_grid6, rf_waveform, scan_axes, scan_nodes, study_starts,
)
from otbench.trace import busy_us
from waveform_ot_torch.utils.profiling import LAUNCH_CALLS, device_trace

WORKLOADS = ("loc64", "scan", "study", "layered", "layered_scan", "layered_ms", "toolbox")


def layered_workload(name: str, dev):
    """(call, warm-up calls, profiled calls, description, the sources (x, y,
    z) of one evaluation grouped per operator) of a layered workload."""
    from waveform_ot_torch.inversion import (
        InvOptions, layered_misfit_grid, loc_cmt_misfit, loc_cmt_value_and_grad,
        minimize_lbfgs_batched_host,
    )

    f32, opts = torch.float32, InvOptions()
    loc, cfg, prob, fwd, stages = build_layered_problem(f32, dev)
    if name == "layered":
        m = loc + torch.tensor(DM, dtype=f32, device=dev)
        return (lambda: loc_cmt_value_and_grad(m, prob, opts, cfg, forward=fwd), 5, 10,
                "layered value+grad f32", (m[0:1], m[1:2], m[2:3]))
    if name == "layered_scan":
        zs, xy = scan_axes(f32, dev)
        n = (len(zs), len(xy))
        return (lambda: layered_misfit_grid(zs, xy, prob, opts, cfg, stages), 2, 3,
                f"{len(zs) * len(xy)}-node layered scan f32",
                (xy[:, 0].expand(n), xy[:, 1].expand(n), zs[:, None].expand(n)))
    starts = study_starts(f32, dev)
    fun = lambda ms: loc_cmt_misfit(ms, prob, opts, cfg, forward=fwd)
    return (lambda: minimize_lbfgs_batched_host(fun, starts, max_iter=25, tol=1e-4, ls_max=8),
            1, 1, f"{len(starts)}-start layered study f32 (minimize_lbfgs_batched_host)",
            (starts[:, 0], starts[:, 1], starts[:, 2]))


def stage_breakdown(dev, sources, smi: str):
    """Profile one layered evaluation in stages, synchronised between them,
    and print each stage's share of the device busy time."""
    from waveform_ot_torch.inversion import InvOptions, misfit_from_seis
    from waveform_ot_torch.models.layered import _moment_coeffs

    _, cfg, prob, _, (stage_a, stage_b) = build_layered_problem(torch.float32, dev)
    x, y, z = (v.detach().clone().requires_grad_(True) for v in sources)
    a = _moment_coeffs(prob.mxyz_fixed)
    zg = z if z.dim() == 1 else z[:, 0]

    labels = ("stage A (operators + depth tangent)",
              "stage B (response, Bessel assembly, synthesis)",
              "misfit (fingerprint, kernel, 1-D OT)", "backward (misfit and stage B)")

    def run(record):
        with record(labels[0]):
            ops, dops = stage_a(zg.detach(), tangent=True)
            torch.cuda.synchronize()
        with record(labels[1]):
            s = stage_b(ops, x, y, z, a, prob.stations, dops)
            torch.cuda.synchronize()
        with record(labels[2]):
            v = misfit_from_seis(s.reshape((-1,) + s.shape[-3:]), prob, InvOptions(), cfg)
            torch.cuda.synchronize()
        with record(labels[3]):
            torch.autograd.grad(v.sum(), (x, y, z))
            torch.cuda.synchronize()

    for _ in range(2):
        run(lambda name: contextlib.nullcontext())
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(torch.profiler.record_function)
    events = prof.events()
    # a range also appears on the device as one span over its kernels: leave it out
    dev_ev = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in labels]
    ranges = [e for e in events if e.device_type == DeviceType.CPU and e.name in labels]
    busy = busy_us((e.time_range.start, e.time_range.end) for e in dev_ev)
    print(f"[stages] {smi}; one evaluation, {x.numel()} sources, synchronised between "
          f"stages: device busy {busy / 1e3:.4f} ms")
    for r in sorted(ranges, key=lambda e: e.time_range.start):
        inside = [e for e in dev_ev if r.time_range.start <= e.time_range.start
                  < r.time_range.end]
        us = busy_us((e.time_range.start, e.time_range.end) for e in inside)
        kern = sum(e.time_range.elapsed_us() for e in inside if KERNEL_NAME in e.name)
        print(f"[stages] {100 * us / busy:5.1f}%  {us / 1e3:9.4f} ms device busy, "
              f"{r.time_range.elapsed_us() / 1e3:9.4f} ms host clock, {len(inside):6d} device "
              f"ops  {r.name}" + (f"; distance-field kernel {kern / 1e3:.4f} ms "
                                  f"({100 * kern / busy:.1f}%)" if kern else ""))


def toolbox_workloads(dev):
    """[(call, warm-up calls, profiled calls, description)] of phase 12's
    sliced and Sinkhorn calls, as chip_smoke.toolbox_phase makes them."""
    from waveform_ot_torch import compat
    from waveform_ot_torch.ops.sinkhorn import sinkhorn_log

    t, rf = rf_waveform()
    _, rfd = rf_waveform(RF_SHIFT)
    fps = fingerprint_pdfs(t, [rfd, rf], rf_grid6(), RF_LAMBDA, dev)
    src, tgt = (compat.OTpdf((w.pdf, w.pos), dev) for w in fps)
    tm, wpred, wobs, grid = migration_waveforms()
    msrc, mtgt = (compat.OTpdf((w.pdf, w.pos), dev)
                  for w in fingerprint_pdfs(tm, [wpred, wobs], grid, 0.04, dev))
    return [
        (lambda: compat.SlicedWasserstein(src, tgt, TOOLBOX_NPROJ, derivatives=True), 1, 3,
         f"SlicedWasserstein({TOOLBOX_NPROJ}, derivatives) 800x600 f64"),
        (lambda: compat.Sinkhorn(src, tgt, gamma=SINKHORN_SIGMA_PX, iter=SINKHORN_ITERS), 1,
         3, f"Gaussian Sinkhorn sigma {SINKHORN_SIGMA_PX:g} px, {SINKHORN_ITERS} steps, "
            f"800x600 f64"),
        (lambda: compat.Sinkhorn_MS(msrc, mtgt), 1, 1,
         "Sinkhorn_MS 5001 steps, 4,800 points f64"),
        (lambda: sinkhorn_log(msrc.density, mtgt.density, iters=500), 1, 1,
         "sinkhorn_log 500 steps, 4,800 points f64"),
    ]


def workload(name: str, dev):
    """(call, warm-up calls, profiled calls, description) of the workload."""
    from waveform_ot_torch.inversion import (
        InvOptions, loc_cmt_misfit, loc_cmt_value_and_grad, minimize_multi_start,
    )

    if name.startswith("layered"):
        return layered_workload(name, dev)[:4]
    f32, opts = torch.float32, InvOptions(loc=True, cmt=False, mistype="OT")
    if name == "loc64":
        loc, cfg, prob = build_loc64_problem(64, f32, dev)
        m = loc + torch.tensor(DM, dtype=f32, device=dev)
        return (lambda: loc_cmt_value_and_grad(m, prob, opts, cfg), 5, 10,
                "loc64 value+grad f32")
    _, cfg, prob = build_loc64_problem(NR_STUDY, f32, dev)
    if name == "scan":
        nodes = scan_nodes(f32, dev)
        return (lambda: loc_cmt_value_and_grad(nodes, prob, opts, cfg), 2, 3,
                f"{len(nodes)}-node scan value+grad f32")
    starts = study_starts(f32, dev)
    fun = lambda ms: loc_cmt_misfit(ms, prob, opts, cfg)
    return (lambda: minimize_multi_start(fun, starts, max_iter=30, tol=3e-5), 1, 1,
            f"{len(starts)}-start study f32 (minimize_multi_start)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=WORKLOADS, default="loc64")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_loc64: torch sees no CUDA device", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    runs = (toolbox_workloads(dev) if args.workload == "toolbox"
            else [workload(args.workload, dev)])
    tables = [profile(*run, smi) for run in runs]
    if args.workload.startswith("layered"):
        stage_breakdown(dev, layered_workload(args.workload, dev)[4], smi)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n\n".join(tables))
    return 0


def profile(call, warm: int, calls: int, what: str, smi: str) -> str:
    """Profile ``calls`` calls after ``warm`` warm-up calls, print the
    summary lines and return the profiler's full table."""
    for _ in range(warm):
        call()
    prof, dev_ev, wall_ms = device_trace(call, calls)
    events = prof.events()
    if not dev_ev:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = busy_us((e.time_range.start, e.time_range.end) for e in dev_ev) / 1e3
    busy_ms /= calls
    launches = sum(e.name in LAUNCH_CALLS for e in events) / calls
    by_name = collections.Counter()
    count = collections.Counter()
    for e in dev_ev:
        by_name[e.name] += e.time_range.elapsed_us()
        count[e.name] += 1
    total_us = sum(by_name.values())

    print(f"[profile] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"[profile] {what}, {calls} calls under the profiler: "
          f"{wall_ms:.4f} ms/call host clock, device busy {busy_ms:.4f} ms/call "
          f"({100 * busy_ms / wall_ms:.1f}% busy), {len(dev_ev) / calls:g} device "
          f"ops and {launches:g} kernel launch calls per call")
    for name, us in by_name.most_common(15):
        print(f"[profile] {100 * us / total_us:5.1f}%  {us / calls:8.2f} us/call  "
              f"x{count[name] / calls:g}  {name[:110]}")
    return f"{what}\n" + prof.key_averages().table(sort_by="self_device_time_total",
                                                   row_limit=200)


if __name__ == "__main__":
    sys.exit(main())
