"""One run of one cell: set-up, the measured window, the metrics and the
comparison that decides ``correct``.

Everything that belongs to one cell is found by name: the workload entry of
``BENCHMARK.json`` names its configuration (``configs/<config>.json``) and
its traffic mix (``traffic/<mix>.json``); its limits are
``limits/<cell>.json``; each metric the manifest gives the cell is read by
the file named for the part of its name before the first dot
(``metrics/models_per_s.py``; ``device_idle.scan`` and ``device_idle.calls``
share ``metrics/device_idle.py``), whose ``read(run)`` returns a number or
None (then the metric is left out of the line).

The window is a closed loop: one unit of the mix after another, each
waited for (a synchronize) before the next is sent, until ``seconds`` have
passed; the window ends when the last unit started ends, so every unit it
counts finished inside it. With ``trace`` the window runs under
torch.profiler for the mix's ``trace_seconds`` instead, and the metrics are
the cell's per-layer ones.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from otbench import compare, generator, trace
from otbench.reference import Reference, moment_tensor_from_sdr

HERE = Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "waveform_ot_tpu")


class Inputs(NamedTuple):
    """What the benchmark hands both sides, float64 on the device: the
    stations (nr,), the true source (3,), its moment tensor (3, 3) and the
    standard normal noise (nr, 3, nt) of the observed data."""

    sx: torch.Tensor
    sy: torch.Tensor
    loc: torch.Tensor
    mxyz: torch.Tensor
    noise: torch.Tensor


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclass
class Run:
    """What a run measured; the metric readers read it."""

    cell: Cell
    seed: int
    setup_s: float = math.nan
    window_s: float = math.nan
    latencies_s: list = field(default_factory=list)
    evaluations: int = 0
    peak_bytes: int = 0
    summary: trace.Summary | None = None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``."""
    man = load_json(MANIFEST)
    wl = {w["name"]: w for w in man["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in the manifest")
    w = wl[name]
    mine = lambda ms: [m for m in ms if name in m.get("workloads", [name])]
    return Cell(name=name, chips=w["chips"],
                config=load_json(HERE / "configs" / f"{w['config']}.json"),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=mine(man["end_to_end"]), per_layer=mine(man["per_layer"]))


def reader(metric: str):
    """``read`` of the file named for the part of ``metric`` before its
    first dot."""
    path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"otbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_inputs(config: dict, seed: int, device) -> Inputs:
    """The configuration's stations, source and moment tensor, and the
    seed's noise, drawn on the device by one torch.Generator."""
    f64 = dict(dtype=torch.float64, device=device)
    ang = np.linspace(0, 2 * np.pi, config["stations"], endpoint=False)
    r = config["station_radius_km"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    noise = torch.randn((config["stations"], 3, config["nt"]), generator=gen, **f64)
    strike, dip, rake = config["strike_dip_rake_deg"]
    mxyz = moment_tensor_from_sdr(strike, dip, rake, m0=config["m0"], **f64)
    return Inputs(torch.as_tensor(r * np.cos(ang), **f64), torch.as_tensor(r * np.sin(ang), **f64),
                  torch.as_tensor(config["source_km"], **f64), mxyz, noise)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def finite(out: dict) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in out.values())


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def window(system, cell: Cell, seed: int, seconds: float, device, log):
    """The closed loop. Returns (units' inputs, outputs (None for a unit
    that raised), latencies, window seconds)."""
    units, outputs, lat = [], [], []
    sync(device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        u = generator.unit(cell.traffic, cell.config, seed, len(units))
        t = time.perf_counter()
        try:
            out = system.run(u)
            sync(device)
        except Exception:  # a unit that raises is a failed unit; the loop goes on
            log(traceback.format_exc())
            out = None
        lat.append(time.perf_counter() - t)
        units.append(u)
        outputs.append(out)
    return units, outputs, lat, time.perf_counter() - t0


def check(cell: Cell, inputs: Inputs, units, outputs, seed: int, dtype, device,
          candidate=None) -> dict:
    """The compared numbers of a run against the float64 reference.
    ``candidate`` (a Reference in a lower precision: the control) replaces
    the program's outputs at the sampled points of a scan or of calls."""
    done = [(u, o) for u, o in zip(units, outputs) if o is not None]
    if not done:
        return {}
    study = cell.traffic["kind"] == "study"
    ms, v, g = compare.points(cell.traffic, [u for u, _ in done], [o for _, o in done], seed)
    if not study:
        ms = ms.to(dtype).double()          # the locations as the program was handed them
    ms = ms.to(device)
    if candidate is not None and not study:
        v, g = candidate.value_and_grad(ms)
    v_ref, g_ref = Reference(cell.config, inputs).value_and_grad(ms)
    if study:
        return {**compare.gaps(v, v_ref), "grad_end": compare.grad_end(g_ref, g),
                "unconverged_share": compare.unconverged_share([o["converged"] for _, o in done])}
    return compare.gaps(v, v_ref, g, g_ref)


def device_info(cell: Cell, device, peak_bytes: int, summary) -> dict:
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": cell.chips, "memory_peak_bytes": int(peak_bytes)}
    if summary is not None:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    return info


def card_line(device) -> str:
    """nvidia-smi's name and power limit of the card, beside every number."""
    if torch.device(device).type != "cuda":
        return "no card"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def run(name: str, seed: int, seconds: float, trace_on: bool, device="cuda",
        t_start: float | None = None, cell: Cell | None = None,
        system_factory=None, log=None) -> tuple[dict, list[str]]:
    """One run of the cell. Returns (the result line's object, the lines
    that end standard error: each compared number beside its limit).
    ``system_factory(config, traffic, inputs, device)`` builds the system
    under test (default :class:`otbench.system.System`)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cell = cell or load_cell(name)
    device = torch.device(device)
    on_card = device.type == "cuda"
    if system_factory is None:
        from otbench.system import System as system_factory
    log(f"[otbench] {cell.name} seed {seed} seconds {seconds} trace {int(trace_on)}; "
        f"{card_line(device)}; torch {torch.__version__} cuda {torch.version.cuda}")

    inputs = make_inputs(cell.config, seed, device)
    system = system_factory(cell.config, cell.traffic, inputs, device)
    system.run(generator.unit(cell.traffic, cell.config, seed, 0, stream=generator.WARM))
    sync(device)
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    rec = Run(cell=cell, seed=seed, setup_s=time.perf_counter() - t_start)
    evals0 = system.objective.calls

    if trace_on:
        with trace.profile(on_card) as prof:
            with torch.profiler.record_function(trace.MARK):
                units, outputs, lat, win = window(
                    system, cell, seed, min(seconds, cell.traffic["trace_seconds"]), device, log)
        rec.summary = trace.summarize(prof, win)
        del prof
    else:
        units, outputs, lat, win = window(system, cell, seed, seconds, device, log)
    # an answer that is not finite is a failed unit too (read after the window)
    outputs = [o if o is not None and finite(o) else None for o in outputs]
    failed = sum(o is None for o in outputs)
    rec.window_s, rec.latencies_s = win, lat
    rec.evaluations = system.objective.calls - evals0
    rec.peak_bytes = torch.cuda.max_memory_allocated(device) if on_card else 0
    peak = max(setup_peak, rec.peak_bytes)
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {bad}")

    metrics = {}
    for m in (cell.per_layer if trace_on else cell.end_to_end):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if not trace_on and lat:
        log(f"[otbench] {len(lat)} units in {win!r} s; latency median "
            f"{statistics.median(lat) * 1e3!r} ms, max {max(lat) * 1e3!r} ms")

    # the program's state is freed before the reference runs
    outputs = [None if o is None else {k: v.detach().cpu() for k, v in o.items()}
               for o in outputs]
    dtype = system.dtype
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = check(cell, inputs, units, outputs, seed, dtype, device)
    log(f"[otbench] reference check of {cell.name}: {time.perf_counter() - t!r} s")
    correct = failed == 0 and len(units) > 0 and compare.judge(numbers, cell.limits)
    result = {"correct": correct, "attempted": len(units), "failed": failed,
              "metrics": metrics, "device": device_info(cell, device, peak, rec.summary)}
    if rec.summary is not None:
        result["breakdown"] = {"device_ops": trace.top(rec.summary.device_s),
                               "idle_gaps": trace.top(rec.summary.idle_by_host_op)}
    shown = lambda x: x if x is not None and math.isfinite(x) else None
    result["checks"] = {k: {"value": shown(numbers.get(k)), "limit": lim}
                        for k, lim in cell.limits.items()}
    return result, compare.lines(numbers, cell.limits)
