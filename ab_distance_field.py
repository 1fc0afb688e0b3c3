"""Times the distance-field kernel on one card: at every split, and against an
earlier revision of it.

    python3 ab_distance_field.py                       # the split sweep
    git show <rev>:waveform_ot_torch/csrc/distance_field.cu > _chipcheck/old.cu
    python3 ab_distance_field.py --old _chipcheck/old.cu

Device times come from ``waveform_ot_torch.utils.profiling.device_ms`` (with
chip_smoke's launches per run for each shape) and bounds from
``otbench.roofline.kernel_bound_s``, the benchmark's own, at chip_smoke.py's
shapes (loc64, Ricker, bigfp, one multistart evaluation, the scan) in
float32 and float64, plus the loc64 grid at fewer traces.

  * The sweep times the kernel at every split S it is built for (1, 2, 4,
    ..., 32 lanes per point group), marks the S that ``cuda_distance.plan``
    picks and the fastest. It is the measurement behind ``plan``'s rule.
  * ``--old`` builds an earlier ``distance_field.cu`` with the package's
    nvcc flags into a temporary directory and launches it through the
    current wrapper (``cuda_distance.distance_field_cuda``: its checks,
    allocations and ``plan``), so the source must have the current C
    interface. The two kernels are timed in turns (old, new, new, old), and
    the largest |d| difference and the winner flips between them are
    printed. Then the loc64 float32 value+grad call is timed on the host
    clock (``utils.profiling.host_median_ms``) through each kernel, in the
    same turns.

The last line is a JSON record. Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke
from otbench.roofline import kernel_bound_s
from waveform_ot_torch.utils.profiling import device_ms, host_median_ms

SPLITS = (1, 2, 4, 8, 16, 32)
FEWER_TRACES = (3, 12, 48)           # loc64's grid at 1, 4 and 16 stations
HOST_CALLS = 20                      # loc64 calls per host-clock median


@contextlib.contextmanager
def kernel_library(lib):
    """Route ``distance_field_cuda`` to ``lib`` (a loaded library) inside."""
    from waveform_ot_torch.ops import cuda_distance

    saved = cuda_distance._library
    cuda_distance._library = lambda: lib
    try:
        yield
    finally:
        cuda_distance._library = saved


@contextlib.contextmanager
def forced_split(s: int):
    """Make ``distance_field_cuda`` launch with S = ``s`` inside."""
    from waveform_ot_torch.ops import cuda_distance

    saved = cuda_distance.plan
    cuda_distance.plan = lambda *shape: s
    try:
        yield
    finally:
        cuda_distance.plan = saved


def load_old(src: Path, tmp: Path) -> ctypes.CDLL:
    """Build ``src`` with the package's flags and load it with the current
    C interface."""
    from waveform_ot_torch import _build
    from waveform_ot_torch.ops import cuda_distance

    so = tmp / "old_distance_field.so"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.find_nvcc(), *flags, str(src), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    for sym in cuda_distance._SYMBOLS.values():
        getattr(lib, sym).argtypes = cuda_distance._ARGTYPES
        getattr(lib, sym).restype = ctypes.c_int
    lib.wot_cuda_error_string.argtypes = [ctypes.c_int]
    lib.wot_cuda_error_string.restype = ctypes.c_char_p
    return lib


def shapes(dev, golden) -> list:
    """[(name, dtype, (verts, tgrid, ugrid))] of the sweep and the A/B."""
    out = []
    for dt in (torch.float32, torch.float64):
        by_name = chip_smoke.main_path_shapes(dt, dev, golden)
        out += [(name, dt, args) for name, args in by_name.items()]
        out += [(f"loc64[:{b}]", dt, tuple(x[:b].contiguous() for x in by_name["loc64"]))
                for b in FEWER_TRACES]
    return out


def launches_for(name: str) -> int:
    """Back-to-back launches per timed run at the shape ``name``."""
    return chip_smoke.BACK_TO_BACK_BY_SHAPE.get(name, chip_smoke.BACK_TO_BACK)


def bound_ms(dt, args) -> float:
    """The benchmark's least time for the distance field of ``args``."""
    bsz, nt = args[0].shape[:2]
    return kernel_bound_s(bsz, nt, args[2].shape[1], args[1].shape[1], str(dt)[6:]) * 1e3


def sweep(cases, sms: int, smi: str) -> list:
    from waveform_ot_torch.ops import cuda_distance

    rows = []
    for name, dt, args in cases:
        bsz, nt = args[0].shape[:2]
        picked = cuda_distance.plan(bsz, args[2].shape[1], args[1].shape[1], nt - 1, sms)
        bound = bound_ms(dt, args)
        times = {}
        for s in SPLITS:
            with forced_split(s):
                times[s] = device_ms(
                    lambda: cuda_distance.distance_field_cuda(*args), launches=launches_for(name))
        best = min(times, key=times.get)
        rows.append({"shape": name, "dtype": str(dt)[6:], "plan_S": picked, "best_S": best,
                     "ms_by_S": times, "bound_ms": bound})
        print(f"[sweep] {name} {str(dt)[6:]} B={bsz} nseg={nt - 1}: plan S={picked} "
              f"{times[picked]:.6f} ms, best S={best} {times[best]:.6f} ms; "
              + ", ".join(f"S={s} {t:.6f}" for s, t in times.items())
              + f" ms; bound {bound:.6f} ms [{smi}]")
    return rows


def ab(cases, old, smi: str) -> tuple[list, dict]:
    from waveform_ot_torch.inversion import InvOptions, loc_cmt_value_and_grad
    from waveform_ot_torch.ops import cuda_distance

    new = cuda_distance._library()
    rows = []
    for name, dt, args in cases:
        if name.startswith("loc64["):
            continue
        with kernel_library(old):
            a = cuda_distance.distance_field_cuda(*args)
        b = cuda_distance.distance_field_cuda(*args)
        torch.cuda.synchronize()
        flips = int((a[1] != b[1]).sum())
        d_diff = (a[0] - b[0]).abs().max().item()
        t = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            with kernel_library(old if who == "old" else new):
                t[who].append(device_ms(
                    lambda: cuda_distance.distance_field_cuda(*args),
                    launches=launches_for(name)))
        bound = bound_ms(dt, args)
        row = {"shape": name, "dtype": str(dt)[6:],
               "old_ms": sum(t["old"]) / 2, "new_ms": sum(t["new"]) / 2,
               "old_runs": t["old"], "new_runs": t["new"], "bound_ms": bound,
               "max_abs_d_diff": d_diff, "winner_flips": flips}
        rows.append(row)
        print(f"[ab] {name} {row['dtype']}: old {row['old_ms']:.6f} ms {t['old']}, new "
              f"{row['new_ms']:.6f} ms {t['new']}, bound {bound:.6f} ms, "
              f"share old {bound / row['old_ms']:.4f} new {bound / row['new_ms']:.4f}; "
              f"max |d old - d new| {d_diff:.3e}, winner flips {flips} [{smi}]")
    # the whole loc64 value+grad call through each kernel
    dev = torch.device("cuda", 0)
    loc, cfg, prob = chip_smoke.build_loc64_problem(64, torch.float32, dev)
    m = loc + torch.tensor(chip_smoke.DM, dtype=torch.float32, device=dev)
    opts = InvOptions(loc=True, cmt=False, mistype="OT")
    call = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        with kernel_library(old if who == "old" else new):
            call[who].append(host_median_ms(
                lambda: loc_cmt_value_and_grad(m, prob, opts, cfg), n=HOST_CALLS))
    print(f"[ab] loc64 value+grad f32 (host clock, median of {HOST_CALLS}): "
          f"old {call['old']} ms, new {call['new']} ms [{smi}]")
    return rows, call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, help="an earlier distance_field.cu to A/B against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_distance_field: torch sees no CUDA device", file=sys.stderr)
        return 1
    from waveform_ot_torch.ops import cuda_distance

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    golden = json.loads((chip_smoke.REPO / "tests_golden_ref.json").read_text())
    cases = shapes(dev, golden)
    cuda_distance._library()
    record = {"card": smi, "sweep": sweep(cases, sms, smi)}
    if args.old is not None:
        with tempfile.TemporaryDirectory() as tmp:
            old = load_old(args.old, Path(tmp))
            record["ab"], record["loc64_value_grad_f32_ms"] = ab(cases, old, smi)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
