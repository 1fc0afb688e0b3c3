"""The system's benchmark program on the port (counterpart of ``bench.py``).

    python -m waveform_ot_torch.bench [--device cuda|cpu] [--stage NAME]

Runs ``bench.py``'s ten stages (``bench.py:580-581``), each in a fresh
interpreter of its own, and after every stage prints ``bench.py``'s one JSON
line (``_emit``, ``bench.py:469-566``: the same keys, metric strings,
rounding and statuses) from what has landed so far, so the last line holds
every stage that finished. ``vs_baseline`` divides the times of
``bench_baseline.json`` (the reference library's single-core CPU times, and
the JAX package's own float64 one-core layered objective) by the stage's
time. Everything else goes to stderr: the card's ``nvidia-smi`` name and
power limit, the host's CPU model, the torch and CUDA versions, and each
stage's raw numbers as they land. ``--stage NAME`` runs one stage in this
process and prints its raw numbers. The stages, with ``bench.py``'s lines:

  loc64, loc1024  ``bench_loc_cmt`` (``:80``): the far-field loc-only W2
                  misfit and gradient at LOC + (4, -3, 2), float32, 64 or
                  1,024 stations x 3 components;
  ricker          ``bench_ricker`` (``:99``): the Ricker_Figs_3_8 objective,
                  80x512 grid, float32, noise from numpy default_rng(42);
  bigfp           ``bench_big_fingerprint`` (``:331``): the 626-sample demo
                  waveform's 800x600 fingerprint density, float32;
  scan            ``bench_grid_scan`` (``:133``): value and gradient at the
                  21x21x4 = 1,764 nodes, 11 stations, one batched call;
  multistart      ``bench_multi_start`` (``:162``): 64 starts through
                  ``minimize_multi_start`` (max_iter 30, tol 3e-5), every
                  start within 0.1 km of the source;
  f32dev          ``f32_deviation`` (``:358``): loc16 float32 on the stage's
                  device against float64 on the CPU;
  layered         ``bench_layered`` (``:196``): value and gradient through
                  the six-layer Fukuoka f-k forward, 11 stations, nk 512;
  layered_scan    ``bench_layered_scan`` (``:254``): the 1,764 nodes through
                  ``layered_misfit_grid``;
  layered_ms      ``bench_layered_multistart`` (``:286``): 64 starts through
                  ``minimize_lbfgs_batched_host`` (max_iter 25, tol 1e-4,
                  ls_max 8), at least 75% of them within 1 km.

Each timing is one warm call, then the mean of n calls, synchronized with
the card before and after (``_time``). The repeat counts are ``bench.py``'s
(``:409-410``): its accelerator counts on the card, its CPU counts with
``--device cpu``. A stage's raw numbers also carry its kernel launches:
``launches`` (every launch the stage process made), ``launches_per_call``
over the timed calls, and for the two studies the batched ``evaluations``
per study and ``launches_per_evaluation``.

Where the port parts from ``bench.py``, by decision:

1. No ``jax.jit`` and no compile cache (``_setup_cache``, ``:382``): the
   port runs eagerly, so host dispatch is part of every stage's time. The
   distance-field kernel's nvcc build is cached in ``waveform_ot_torch/
   _build/``; :func:`main` builds it once before the first stage, so no
   stage's warm call pays for nvcc.
2. No x64 subprocess for the oracle (``:49-65``: JAX needs a fresh
   interpreter to turn x64 on). torch has no global switch, so
   :func:`f32_deviation` computes the float64 oracle on the CPU inside the
   stage's own process.
3. The v5e chunks are dropped: ``layered_misfit_grid(xy_chunk=63)``
   (``:277-278``) and ``minimize_lbfgs_batched_host(eval_chunk=16)``
   (``:312-319``) exist because the 64-lane layered evaluation exceeded one
   v5e's memory. On an H100 both run unchunked (the layered scan peaks near
   23 GB), and chunks do not change what is computed. So the layered scan
   makes one kernel launch per call, and the layered study one per batched
   evaluation.
4. The stage subprocesses stay. On the card they no longer guard against
   the TPU runtime's contamination (``:398-402``), but they keep one stage's
   peak memory, allocator state and autograd graphs out of the next, and the
   reprinted line survives a kill.

There is no fallback: with no card visible and no ``--device cpu``,
:func:`run_stage` and :func:`main` raise. A failed stage is reported as
``bench.py`` reports it (``"failed:<Exception>"``, null values), and then
:func:`main` exits non-zero where ``bench.py`` exits 0; so does a stage
skipped for the budget. TF32 is off in every stage process, the port's
counterpart of the JAX package's ``Precision.HIGHEST`` pins.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from waveform_ot_torch import entry
from waveform_ot_torch.entry import LOC_ONLY, NT
from waveform_ot_torch.inversion import (
    TraceConfig, build_target, grid6_to_window, layered_misfit_grid, loc_cmt_misfit,
    loc_cmt_value_and_grad, make_ricker_problem, minimize_lbfgs_batched_host,
    minimize_multi_start, ricker_value_and_grad,
)
from waveform_ot_torch.models import fukuoka_model, make_layered_stages, ricker_wavelet
from waveform_ot_torch.ops import cuda_distance
from waveform_ot_torch.ops.fingerprint import FingerprintSpec, fingerprint_density, make_window
from waveform_ot_torch.utils.profiling import benchmark

REPO = Path(__file__).resolve().parent.parent
STAGES = ["loc64", "ricker", "bigfp", "loc1024", "scan", "multistart",
          "f32dev", "layered", "layered_scan", "layered_ms"]
# timed calls per stage after the warm one (bench.py:409-410 and the layered
# stages' counts): on the card, and on the CPU
CARD_REPEATS = {"loc64": 200, "ricker": 100, "loc1024": 20, "scan": 3, "multistart": 2,
                "bigfp": 20, "layered": 10, "layered_scan": 2, "layered_ms": 1}
CPU_REPEATS = {"loc64": 5, "ricker": 2, "loc1024": 1, "scan": 1, "multistart": 1,
               "bigfp": 1, "layered": 1, "layered_scan": 1, "layered_ms": 1}
DM = (4.0, -3.0, 2.0)            # the evaluation point is LOC + DM
F64_ORACLE_NR = 16               # stations of the f32-vs-f64 check (48 traces)
NR_STUDY = 11                    # stations of the scans, the studies and the layered stages
N_STARTS = 64
START_KM = 15.0                  # starts: LOC + uniform(-15, 15) km from default_rng(1)
STUDY_RADIUS_KM = 0.1            # every far-field start must end this close to LOC
LAYERED_MS_RADIUS_KM = 1.0
LAYERED_MS_SHARE = 0.75          # this share of the layered starts within 1 km
LAYERED_NK = 512
LAYERED_KMAX = 2.0
RICKER_TRANGE = (-2.0, 7.0)
RICKER_GRID6 = (-2.0, 7.0, -2.0, 2.6, 80, 512)
RICKER_LAMBDA = 0.03
RICKER_M = (0.7, 1.1, 1.3)
BIGFP_SAMPLES = 626
BIGFP_GRID = (800, 600)          # nu, ntg


def _device(device) -> torch.device:
    """``device``, or the card when it is None; raises when it is None and
    torch sees no card (there is no fallback to the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("the bench runs on the card and torch sees no CUDA device; "
                           "pass --device cpu (run_stage(name, device='cpu')) to run its "
                           "stages on the CPU")
    return torch.device("cuda")


def _time(fn, args, n_iter: int) -> float:
    """Mean host-clock seconds per call of ``fn(*args)`` over ``n_iter``
    calls after one warm call, synchronized with the card before and after."""
    return benchmark(fn, *args, n_iter=n_iter, warmup=1)


def _timed_launches(fn, args, n_iter: int):
    """(``_time(fn, args, n_iter)``, kernel launches per call over its
    1 + n_iter calls)."""
    before = cuda_distance.LAUNCHES
    per = _time(fn, args, n_iter)
    return per, (cuda_distance.LAUNCHES - before) / (n_iter + 1)


class _Counted:
    """A batched objective that counts its calls: the solvers call it once
    per batched evaluation (value, or value and gradient)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, ms):
        self.calls += 1
        return self.fn(ms)


def _study_time(run, starts, fobj: _Counted, n_iter: int):
    """(seconds per study, {"evaluations": batched evaluations per study,
    "launches_per_evaluation"}), over the 1 + n_iter studies of ``_time``."""
    before, calls = cuda_distance.LAUNCHES, fobj.calls
    per = _time(run, (starts,), n_iter)
    evals = fobj.calls - calls
    return per, {"evaluations": evals / (n_iter + 1),
                 "launches_per_evaluation": (cuda_distance.LAUNCHES - before) / evals}


def _check_finite(what: str, *tensors) -> None:
    if not all(bool(torch.isfinite(torch.as_tensor(t)).all()) for t in tensors):
        raise AssertionError(f"non-finite {what}")


def bench_loc_cmt(nr: int, n_iter: int, device):
    """The far-field loc-only W2 misfit and gradient (``bench.py:80``):
    ``entry._build_problem(nr)`` in float32 on ``device``, evaluated at
    LOC + DM. Returns (seconds per call, value, gradient (3,) float32 numpy,
    {"launches_per_call"})."""
    loc, cfg, prob = entry._build_problem(nr, torch.float32, device)
    m = loc + torch.tensor(DM, dtype=torch.float32, device=loc.device)
    fn = lambda mm: loc_cmt_value_and_grad(mm, prob, LOC_ONLY, cfg)
    per, launches = _timed_launches(fn, (m,), n_iter)
    v, g = fn(m)
    _check_finite("loc/CMT value or gradient", v, g)
    return per, v.item(), g.cpu().numpy(), {"launches_per_call": launches}


def ricker_problem(device):
    """``bench.py:99-127``'s Ricker problem in float32 on ``device``: the
    double Ricker at (0, 1.6, 1) on trange (-2, 7) plus 0.005 max|w| of
    float32 normals from numpy default_rng(42), grid6 (-2, 7, -2, 2.6, 80,
    512), lambda 0.03, arctan transform, alpha 0.5. Returns (prob, cfg, m)
    with m = (0.7, 1.1, 1.3)."""
    f32 = torch.float32
    arr = lambda a: torch.as_tensor(a, dtype=f32, device=device)
    tobs, wobs = ricker_wavelet(arr(0.0), arr(1.6), arr(1.0), trange=RICKER_TRANGE)
    rng = np.random.default_rng(42)
    wobs = wobs + 0.005 * float(wobs.abs().max()) * arr(rng.standard_normal(tuple(wobs.shape)))
    win, _ = grid6_to_window(RICKER_GRID6, dtype=f32, device=device)
    cfg = TraceConfig(nu=80, ntg=512, lambdav=RICKER_LAMBDA, q=None, p=2, transform=True)
    with torch.no_grad():
        targets = build_target(tobs, wobs[None], win, cfg)
    prob, _ = make_ricker_problem(targets, RICKER_GRID6, trange=RICKER_TRANGE, alpha=0.5,
                                  lambdav=RICKER_LAMBDA)
    return prob, cfg, arr(RICKER_M)


def bench_ricker(n_iter: int, device):
    """The Ricker_Figs_3_8 objective's value and gradient (``bench.py:99``).
    Returns (seconds per call, {"launches_per_call"})."""
    prob, cfg, m = ricker_problem(device)
    fn = lambda mm: ricker_value_and_grad(mm, prob, cfg)
    per, launches = _timed_launches(fn, (m,), n_iter)
    _check_finite("Ricker value or gradient", *fn(m))
    return per, {"launches_per_call": launches}


def scan_nodes(dtype, device) -> torch.Tensor:
    """The 21x21x4 scan nodes (x, y, z), (1764, 3), in ``bench.py:147-150``'s
    meshgrid(z, x, y, indexing="ij") order."""
    xg = np.linspace(-20, 20, 21)
    yg = np.linspace(-20, 20, 21)
    zg = np.linspace(4, 22, 4)
    Z, X, Y = np.meshgrid(zg, xg, yg, indexing="ij")
    return torch.as_tensor(np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1), dtype=dtype,
                           device=device)


def bench_grid_scan(n_iter: int, device):
    """The Figs_9_10_11 cell-64 scan (``bench.py:133``): value and gradient
    at the 1,764 nodes, 11 stations x 3 components, float32, in one batched
    call. Returns (seconds per scan, nodes, {"launches_per_call"})."""
    _, cfg, prob = entry._build_problem(NR_STUDY, torch.float32, device)
    ms = scan_nodes(torch.float32, device)
    fn = lambda mm: loc_cmt_value_and_grad(mm, prob, LOC_ONLY, cfg)
    per, launches = _timed_launches(fn, (ms,), n_iter)
    v, g = fn(ms)
    _check_finite("scan values or gradients", v, g)
    return per, ms.shape[0], {"launches_per_call": launches}


def study_starts(loc: torch.Tensor) -> torch.Tensor:
    """``bench.py:178-179``'s starts: loc + uniform(-15, 15) km, (64, 3),
    from numpy default_rng(1), in loc's dtype and on its device."""
    rng = np.random.default_rng(1)
    return torch.as_tensor(
        loc.cpu().numpy() + rng.uniform(-START_KM, START_KM, size=(N_STARTS, 3)),
        dtype=loc.dtype, device=loc.device)


def _distances(res, loc) -> torch.Tensor:
    return torch.linalg.vector_norm(res.x - loc, dim=1)


def bench_multi_start(n_iter: int, device):
    """The Fig_12 study (``bench.py:162``): 64 starts through the on-device
    batched L-BFGS (max_iter 30, tol 3e-5), 11 stations, float32; raises
    AssertionError unless every start ends within STUDY_RADIUS_KM of the
    source. Returns (seconds per study, starts, {"evaluations",
    "launches_per_evaluation"})."""
    loc, cfg, prob = entry._build_problem(NR_STUDY, torch.float32, device)
    starts = study_starts(loc)
    fobj = _Counted(lambda ms: loc_cmt_misfit(ms, prob, LOC_ONLY, cfg))
    run = lambda xs: minimize_multi_start(fobj, xs, max_iter=30, tol=3e-5)
    per, counts = _study_time(run, starts, fobj, n_iter)
    err = _distances(run(starts), loc)
    if not bool((err < STUDY_RADIUS_KM).all()):
        raise AssertionError(f"multi-start did not converge: max err {err.max().item()}")
    return per, starts.shape[0], counts


def _build_layered_problem(device):
    """The Figs 9-11 configuration (``bench.py:216``): the six-layer
    Fukuoka model, 11 stations, nt 61, nk 512, kmax 2.0, float32, through
    ``entry._build_layered_problem``. Returns (loc, cfg, prob, forward)."""
    return entry._build_layered_problem(NR_STUDY, nt=NT, nk=LAYERED_NK, kmax=LAYERED_KMAX,
                                        dtype=torch.float32, device=device)


def bench_layered(n_iter: int, device):
    """W2 misfit and gradient through the layered forward at LOC + DM
    (``bench.py:196``). Returns (seconds per call, {"launches_per_call"})."""
    loc, cfg, prob, forward = _build_layered_problem(device)
    m = loc + torch.tensor(DM, dtype=torch.float32, device=loc.device)
    fn = lambda mm: loc_cmt_value_and_grad(mm, prob, LOC_ONLY, cfg, forward=forward)
    per, launches = _timed_launches(fn, (m,), n_iter)
    _check_finite("layered value or gradient", *fn(m))
    return per, {"launches_per_call": launches}


def layered_scan_axes(dtype, device):
    """``bench.py:270-273``'s depths linspace(4, 22, 4) and (x, y) nodes of
    linspace(-20, 20, 21) squared, (441, 2), x-major."""
    xg = np.linspace(-20, 20, 21)
    X, Y = np.meshgrid(xg, xg, indexing="ij")
    arr = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return arr(np.linspace(4, 22, 4)), arr(np.stack([X.ravel(), Y.ravel()], 1))


def bench_layered_scan(n_iter: int, device):
    """The 1,764-node scan through the layered physics (``bench.py:254``),
    depth-amortized (``layered_misfit_grid``), unchunked. Returns (seconds
    per scan, nodes, {"launches_per_call"})."""
    _, cfg, prob, _ = _build_layered_problem(device)
    stages = make_layered_stages(model=fukuoka_model(device=device), nt=NT, dt=1.0,
                                 nk=LAYERED_NK, kmax=LAYERED_KMAX)
    zs, xy = layered_scan_axes(torch.float32, device)
    fn = lambda zz, xx: layered_misfit_grid(zz, xx, prob, LOC_ONLY, cfg, stages)
    per, launches = _timed_launches(fn, (zs, xy), n_iter)
    vals, grads = fn(zs, xy)
    _check_finite("layered scan values or gradients", vals, grads)
    return per, int(vals.numel()), {"launches_per_call": launches}


def bench_layered_multistart(n_iter: int, device):
    """The Fig_12 study through the layered physics (``bench.py:286``): 64
    starts through ``minimize_lbfgs_batched_host`` (max_iter 25, tol 1e-4,
    ls_max 8), unchunked; raises AssertionError unless at least
    LAYERED_MS_SHARE of the starts end within LAYERED_MS_RADIUS_KM. Returns
    (seconds per study, starts, {"evaluations", "launches_per_evaluation"})."""
    loc, cfg, prob, forward = _build_layered_problem(device)
    starts = study_starts(loc)
    fobj = _Counted(lambda ms: loc_cmt_misfit(ms, prob, LOC_ONLY, cfg, forward=forward))
    run = lambda xs: minimize_lbfgs_batched_host(fobj, xs, max_iter=25, tol=1e-4, ls_max=8)
    per, counts = _study_time(run, starts, fobj, n_iter)
    err = _distances(run(starts), loc)
    _check_finite("layered study distances", err)
    frac = (err < LAYERED_MS_RADIUS_KM).double().mean().item()
    if not frac >= LAYERED_MS_SHARE:
        raise AssertionError(f"only {frac:.0%} of starts converged: {err.tolist()}")
    return per, starts.shape[0], counts


def big_fingerprint(dtype, device):
    """(fn, w): the FingerprintLib demo waveform (``bench.py:338-344``),
    2 sin(6 pi t) - 3 cos(2 pi (2t + 0.3)) on 626 samples of [0, 1] as
    (1, 626), and ``fn(w)``, its fingerprint density (nu, ntg) on the 800x600
    grid (BIGFP_GRID) of the window padded by 15% of its amplitude range,
    lambda 0.04."""
    t = torch.as_tensor(np.linspace(0.0, 1.0, BIGFP_SAMPLES), dtype=dtype, device=device)
    w = 2 * torch.sin(t * 6 * np.pi) - 3 * torch.cos((2 * t + 0.30) * 2 * np.pi)
    du = float(w.max() - w.min())
    win = make_window(float(t[0]), float(t[-1]), float(w.min()) - 0.15 * du,
                      float(w.max()) + 0.15 * du, dtype=dtype, device=device)
    nu, ntg = BIGFP_GRID
    spec = FingerprintSpec(nu=nu, ntg=ntg)
    return (lambda ww: fingerprint_density(t, ww, win, spec, lambdav=0.04)[0][0]), w[None]


def bench_big_fingerprint(n_iter: int, device):
    """The demo's 800x600 fingerprint density with its derivative
    precompute, float32 (``bench.py:331``). Returns (seconds per call,
    {"launches_per_call"})."""
    fn, w = big_fingerprint(torch.float32, device)
    per, launches = _timed_launches(fn, (w,), n_iter)
    _check_finite("fingerprint density", fn(w))
    return per, {"launches_per_call": launches}


def f64_oracle(nr: int):
    """(value, gradient (3,)) of ``bench_loc_cmt``'s problem at nr stations
    in float64 on the CPU (``bench.py:49-65``'s oracle)."""
    loc, cfg, prob = entry._build_problem(nr, torch.float64, "cpu")
    v, g = loc_cmt_value_and_grad(loc + torch.tensor(DM, dtype=torch.float64), prob,
                                  LOC_ONLY, cfg)
    return v.item(), g.numpy()


def f32_deviation(device):
    """Relative value and gradient deviation of the float32 pipeline on
    ``device`` from the float64 oracle on the CPU, loc16 (``bench.py:358``).
    Returns (dv, dg, {"launches_per_call"} of the float32 run)."""
    _, v32, g32, counts = bench_loc_cmt(F64_ORACLE_NR, 1, device)
    v64, g64 = f64_oracle(F64_ORACLE_NR)
    dv = abs(v32 - v64) / abs(v64)
    dg = float(np.max(np.abs(g32 - g64)) / np.max(np.abs(g64)))
    return dv, dg, counts


def _stage(name):
    print(f"[bench {time.strftime('%H:%M:%S')}] {name}", file=sys.stderr, flush=True)


def run_stage(name: str, device=None) -> dict:
    """Run one stage in this process on ``device`` (default: the card;
    raises without one) and return its raw numbers: ``bench.py``'s keys
    (``:395``) and the kernel launches."""
    device = _device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reps = CARD_REPEATS if device.type == "cuda" else CPU_REPEATS
    before = cuda_distance.LAUNCHES
    if name in ("loc64", "loc1024"):
        per, _, _, counts = bench_loc_cmt(64 if name == "loc64" else 1024, reps[name], device)
        out = {"per": per}
    elif name == "ricker":
        per, counts = bench_ricker(reps[name], device)
        out = {"per": per}
    elif name == "scan":
        per, n_nodes, counts = bench_grid_scan(reps[name], device)
        out = {"per": per, "n_nodes": n_nodes}
    elif name == "multistart":
        per, n_starts, counts = bench_multi_start(reps[name], device)
        out = {"per": per, "n_starts": n_starts}
    elif name == "bigfp":
        per, counts = bench_big_fingerprint(reps[name], device)
        out = {"per": per}
    elif name == "layered":
        per, counts = bench_layered(reps[name], device)
        out = {"per": per}
    elif name == "layered_scan":
        per, n_nodes, counts = bench_layered_scan(reps[name], device)
        out = {"per": per, "n_nodes": n_nodes}
    elif name == "layered_ms":
        per, n_starts, counts = bench_layered_multistart(reps[name], device)
        out = {"per": per, "n_starts": n_starts}
    elif name == "f32dev":
        dv, dg, counts = f32_deviation(device)
        out = {"dv": dv, "dg": dg}
    else:
        raise ValueError(f"unknown stage {name!r}; the stages are {STAGES}")
    return {**out, **counts, "launches": cuda_distance.LAUNCHES - before}


def _run_stage_subprocess(name: str, timeout: float, device: str = "cuda") -> dict:
    """run_stage(name, device) in a fresh interpreter (its stderr passes
    through); its raw numbers from the last line it prints."""
    _stage(name)
    out = subprocess.run(
        [sys.executable, "-m", "waveform_ot_torch.bench", "--stage", name, "--device", device],
        cwd=REPO, stdout=subprocess.PIPE, text=True, timeout=timeout)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"bench stage {name} failed with exit code {out.returncode} "
                           f"(its stderr is above)")
    return json.loads(lines[-1])


# Total wall-clock budget for the whole suite, bench.py's: the line is
# reprinted after every stage, and once the budget is spent the remaining
# stages are skipped with null entries.
_BUDGET_S = float(os.environ.get("WOT_BENCH_BUDGET_S", 20 * 60.0))


def _emit(results: dict, baseline: dict, status: dict) -> None:
    """Print the full one-line JSON from whatever stages have completed
    (``bench.py:469-566``, the same string for the same results).

    Missing stages contribute null values so the schema is stable from the
    first emission to the last."""
    ref_batch = baseline["ref_batch_64x3_s"]
    ref_ricker = baseline["ref_ricker_objective_s"]
    ref_per_trace = ref_batch / 192.0
    # reference costs for the Fukuoka-style 11x3 configuration: the measured
    # per-call cost is linear in trace count (per-trace python loop)
    ref_node = ref_per_trace * 33
    ref_bigfp = baseline["ref_bigfp_800x600_s"]

    def row(metric, unit, value, vs):
        return {"metric": metric, "unit": unit,
                "value": value, "vs_baseline": vs}

    def scaled(stage, key, scale, ref, digits=4):
        r = results.get(stage)
        if r is None:
            return None, None
        v = r[key] * scale
        return round(v, digits), (round(ref / r[key], 2)
                                  if ref is not None else None)

    per_ricker, vsr = scaled("ricker", "per", 1e3, ref_ricker)
    per_1024, vs1024 = scaled("loc1024", "per", 1e3, ref_per_trace * 3072)
    if results.get("loc1024"):
        thr = round(3072 / results["loc1024"]["per"])
        thr_vs = round((3072 / results["loc1024"]["per"])
                       / (1.0 / ref_per_trace), 2)
    else:
        thr = thr_vs = None
    if results.get("scan"):
        ref_scan = ref_node * results["scan"]["n_nodes"]
        per_scan, vs_scan = scaled("scan", "per", 1e3, ref_scan, 1)
    else:
        per_scan = vs_scan = None
    if results.get("multistart"):
        ref_study = (ref_node * baseline["ref_invert_nfev"]
                     * results["multistart"]["n_starts"])
        per_study, vs_study = scaled("multistart", "per", 1e3, ref_study, 1)
    else:
        per_study = vs_study = None
    per_bigfp, vs_bigfp = scaled("bigfp", "per", 1e3, ref_bigfp)
    # no pyprop8 baseline exists; vs_baseline is the JAX package's own f64
    # CPU path on one core (bench_baseline.json)
    self_layered = baseline.get("self_f64_layered_1core_s")
    per_layered, vs_layered = scaled("layered", "per", 1e3, self_layered, 2)
    if results.get("layered_scan") and self_layered:
        n_nodes = results["layered_scan"]["n_nodes"]
        per_lscan, vs_lscan = scaled("layered_scan", "per", 1e3,
                                     self_layered * n_nodes, 1)
    else:
        per_lscan = vs_lscan = None
    if results.get("layered_ms") and self_layered:
        ref_lms = (self_layered * baseline["ref_invert_nfev"]
                   * results["layered_ms"]["n_starts"])
        per_lms, vs_lms = scaled("layered_ms", "per", 1e3, ref_lms, 1)
    else:
        per_lms = vs_lms = None
    dev = results.get("f32dev")
    dv = float(f"{dev['dv']:.3e}") if dev else None
    dg = float(f"{dev['dg']:.3e}") if dev else None

    extra = [
        row("ricker objective 80x512 misfit+grad", "ms", per_ricker, vsr),
        row("batched W2 misfit+grad, 1024 stations x 3 comps", "ms",
            per_1024, vs1024),
        row("throughput at 1024x3", "traces/s", thr, thr_vs),
        row("misfit grid scan 21x21x4 (1764 nodes), 11 stations x 3 comps",
            "ms", per_scan, vs_scan),
        row("64-start repeat inversion study, on-device LBFGS", "ms",
            per_study, vs_study),
        row("fingerprint density 800x600 grid, 625 segments "
            "(w/ deriv precompute)", "ms", per_bigfp, vs_bigfp),
        row("layered-physics W2 misfit+grad (6-layer Fukuoka f-k), "
            "11 stations x 3 comps [vs own f64 CPU 1-core oracle]", "ms",
            per_layered, vs_layered),
        row("LAYERED misfit grid scan 21x21x4 (1764 nodes), depth-"
            "amortized stage A [vs own f64 CPU 1-core oracle]", "ms",
            per_lscan, vs_lscan),
        row("LAYERED 64-start repeat study, on-device LBFGS "
            "[vs own f64 CPU 1-core oracle x ref nfev]", "ms",
            per_lms, vs_lms),
        row("f32 vs f64 relative deviation (value)", "rel", dv, None),
        row("f32 vs f64 relative deviation (grad, max)", "rel", dg, None),
    ]
    per_64 = results.get("loc64", {}).get("per")
    print(json.dumps({
        "metric": "batched W2 misfit+grad, 64 stations x 3 comps",
        "value": round(per_64 * 1e3, 4) if per_64 is not None else None,
        "unit": "ms",
        "vs_baseline": (round(ref_batch / per_64, 2)
                        if per_64 is not None else None),
        "extra": extra,
        "stages": dict(status),
    }), flush=True)


def _cpu_model() -> str:
    """The host CPU as /proc/cpuinfo describes its first processor: model
    name, vendor, family, model and clock (a virtual machine may report the name as
    "unknown" and still give the family and model)."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return "not readable (/proc/cpuinfo)"
    info = {}
    for line in text.split("\n\n")[0].splitlines():
        key, _, value = line.partition(":")
        info[key.strip()] = value.strip()
    get = lambda k: info.get(k, "?")
    return (f"{get('model name')} ({get('vendor_id')} family {get('cpu family')} model "
            f"{get('model')}, {get('cpu MHz')} MHz)")


def _describe(device: torch.device) -> None:
    """The card's nvidia-smi name and power limit, the host's CPU model and
    the torch and CUDA versions, on stderr."""
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print(smi, file=sys.stderr)
    print(f"[bench] host CPU {_cpu_model()} ({os.cpu_count()} logical cores); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; stages on {device}", file=sys.stderr,
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card); 'cpu' runs the stages on the CPU")
    ap.add_argument("--stage", choices=STAGES, default=None,
                    help="run this one stage in this process and print its raw numbers")
    args = ap.parse_args(argv)
    if args.stage is not None:
        print(json.dumps(run_stage(args.stage, args.device)))
        return 0
    device = _device(args.device)
    _describe(device)
    if device.type == "cuda":
        cuda_distance._library()          # the kernel's nvcc build, before any stage
    baseline = json.loads((REPO / "bench_baseline.json").read_text())
    t0 = time.monotonic()
    results: dict = {}
    status: dict = {}
    for name in STAGES:
        remaining = _BUDGET_S - (time.monotonic() - t0)
        if remaining <= 30.0:
            status[name] = "skipped:budget"
            _stage(f"{name} skipped (budget spent)")
            continue
        try:
            results[name] = _run_stage_subprocess(name, remaining, device.type)
            status[name] = "ok"
            print(f"[bench stage] {name} {json.dumps(results[name])}", file=sys.stderr,
                  flush=True)
        except (RuntimeError, subprocess.TimeoutExpired,
                json.JSONDecodeError) as e:
            status[name] = f"failed:{type(e).__name__}"
            _stage(f"{name} FAILED ({type(e).__name__}): "
                   f"{str(e)[:500]}")
        _emit(results, baseline, status)
    _stage("done")
    return 0 if all(s == "ok" for s in status.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
