"""Where the time of one loc64 value+grad call goes, on one CUDA card.

    python3 profile_loc64.py [--out FILE]

Builds the loc64 problem of chip_smoke.py (64 stations x 3 components,
79x61 grids, float32), warms up, then runs CALLS calls of
``loc_cmt_value_and_grad`` under torch.profiler and prints, per call:

  - the host-clock time (synchronized) and the device busy time, i.e. the
    union of the device-side intervals, with their ratio (busy share);
  - the device operations (kernels, memsets, copies) and cudaLaunchKernel
    calls;
  - the device operations with the most time, each with its share of the
    busy time.

``--out`` also writes the profiler's full table there. Without a CUDA card
it exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

from chip_smoke import DM, build_loc64_problem

CALLS = 10


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals, microseconds."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_loc64: torch sees no CUDA device", file=sys.stderr)
        return 1
    from waveform_ot_torch.inversion import InvOptions, loc_cmt_value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    loc, cfg, prob = build_loc64_problem(64, torch.float32, dev)
    m = loc + torch.tensor(DM, dtype=torch.float32, device=dev)
    opts = InvOptions(loc=True, cmt=False, mistype="OT")
    call = lambda: loc_cmt_value_and_grad(m, prob, opts, cfg)
    for _ in range(5):
        call()
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS

    events = prof.events()
    dev_ev = [e for e in events if e.device_type == DeviceType.CUDA]
    if not dev_ev:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = _busy_us((e.time_range.start, e.time_range.end) for e in dev_ev) / 1e3
    busy_ms /= CALLS
    launches = sum(e.name == "cudaLaunchKernel" for e in events) / CALLS
    by_name = collections.Counter()
    count = collections.Counter()
    for e in dev_ev:
        by_name[e.name] += e.time_range.elapsed_us()
        count[e.name] += 1
    total_us = sum(by_name.values())

    print(f"[profile] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"[profile] loc64 value+grad f32, {CALLS} calls under the profiler: "
          f"{wall_ms:.4f} ms/call host clock, device busy {busy_ms:.4f} ms/call "
          f"({100 * busy_ms / wall_ms:.1f}% busy), {len(dev_ev) / CALLS:g} device "
          f"ops and {launches:g} cudaLaunchKernel per call")
    for name, us in by_name.most_common(15):
        print(f"[profile] {100 * us / total_us:5.1f}%  {us / CALLS:8.2f} us/call  "
              f"x{count[name] / CALLS:g}  {name[:110]}")
    if args.out:
        with open(args.out, "w") as f:
            f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                              row_limit=200))
    return 0


if __name__ == "__main__":
    sys.exit(main())
