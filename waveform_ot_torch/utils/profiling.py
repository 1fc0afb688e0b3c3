"""Profiling and timing utilities (counterpart of
waveform_ot_tpu.utils.profiling), the package's one copy of its timing code.

The reference instruments with ad-hoc ``time.time()`` deltas stored on
objects (tcalc_fp/tcalc_pdf, FingerprintLib.py:169-177). This module gives:

  * :func:`benchmark` — mean host-clock seconds per call after warm-up,
    synchronized with the card when the output lives there;
  * :func:`host_median_ms` — the median host-clock milliseconds of one call,
    synchronized before and after each;
  * :func:`timed` — one call's result and its host-clock seconds,
    synchronized with the card when one is present; :func:`device_label`
    names the device a time was taken on;
  * :func:`events_ms` and :func:`device_ms` — device time by CUDA events,
    one run or the median per call of back-to-back runs queued behind a spin
    kernel;
  * :func:`device_trace` — ``torch.profiler`` over a few calls: the device
    operations, the launch calls and the host-clock time per call;
  * :func:`top_device_ops` — the most expensive operations of one call:
    device kernels on the card, CPU operators on the CPU; with
    ``trace_dir`` it leaves the call's trace there;
  * :class:`StageTimer` — named stage timings as an explicit record.
"""

from __future__ import annotations

import os
import statistics
import tempfile
import time
from pathlib import Path
from typing import Callable

import torch
from torch.autograd import DeviceType

# launch calls of the CUDA runtime and of the cu* API (which cuBLAS uses)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def _on_card(out) -> bool:
    """Whether any tensor in ``out`` (nested tuples, lists, dicts) is on a CUDA card."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        out = list(out.values())
    return isinstance(out, (tuple, list)) and any(_on_card(o) for o in out)


def benchmark(fn: Callable, *args, n_iter: int = 50, warmup: int = 2) -> float:
    """Mean host-clock seconds per call of ``fn(*args)`` after ``warmup``
    calls; when the output lives on the card (or, with no warm-up, whenever
    a card is present), the timed block starts and ends with
    ``torch.cuda.synchronize``."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    card = _on_card(out) if warmup else torch.cuda.is_available()
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        fn(*args)
    if card:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_iter


def host_median_ms(fn: Callable, n: int = 20, warm: int = 3) -> float:
    """Median host-clock milliseconds of one call of ``fn()`` on the card,
    synchronized before and after each, after ``warm`` calls."""
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


def timed(fn: Callable, *args):
    """(fn(*args), host-clock seconds of the call). When a card is present
    the call starts and ends with ``torch.cuda.synchronize``, so the time
    covers its device work."""
    card = torch.cuda.is_available()
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    if card:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_label(device) -> str:
    """The card's name (``torch.cuda.get_device_name``) for a CUDA device,
    else the device's type, to print beside a time taken on it."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def events_ms(run: Callable) -> float:
    """Device milliseconds of ``run()``, by a CUDA event pair around it."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def device_ms(fn: Callable, launches: int = 50, samples: int = 5) -> float:
    """Device time of one call of ``fn``: events around ``launches``
    back-to-back calls, over their count, median of ``samples`` runs after a
    warm-up run.

    Before each run a spin kernel (torch.cuda._sleep) holds the stream for
    longer than the host takes to enqueue the run, so the calls reach the
    device queued up and the events time the device's work, not the host's
    checks, allocations and launch calls in between."""
    def run():
        for _ in range(launches):
            fn()   # each result is freed at once: its memory serves the next call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()                                              # warm-up; enqueue time
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = events_ms(lambda: torch.cuda._sleep(1_000_000)) / 1e6  # per cycle
    hold = int((2.0 * enqueue_ms + 1.0) / spin_ms)
    times = []
    for _ in range(samples):
        torch.cuda._sleep(hold)
        times.append(events_ms(run) / launches)
    return statistics.median(times)


def device_trace(call: Callable, calls: int = 1, card: bool = True):
    """``calls`` calls of ``call()`` under torch.profiler, with CUDA activity
    (and a synchronize before and after) when ``card``, CPU activity alone
    otherwise. Returns (profiler, device events, host-clock ms per call);
    without ``card`` the device events are empty."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        if card:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return prof, dev_ev, wall_ms


def top_device_ops(fn: Callable, *args, top: int = 20,
                   trace_dir=None) -> list[tuple[float, str]]:
    """Run ``fn(*args)`` once to warm up, then once under torch.profiler;
    return [(total_ms, op_name)] sorted by time, descending: when the output
    lives on the card, its kernels' summed device time (a trace with no
    device time raises); otherwise the CPU operators' self time. With
    ``trace_dir`` the profiled call's trace is left there as a Chrome trace,
    ``torch_profiler_*.pt.trace.json`` (the JAX package leaves its
    jax.profiler trace in ``trace_dir``)."""
    card = _on_card(fn(*args))
    prof, dev_ev, _ = device_trace(lambda: fn(*args), card=card)
    if trace_dir is not None:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        fd, trace = tempfile.mkstemp(prefix="torch_profiler_", suffix=".pt.trace.json",
                                     dir=trace_dir)
        os.close(fd)
        prof.export_chrome_trace(trace)
    totals: dict[str, float] = {}
    if card:
        if not dev_ev:
            raise RuntimeError("the profiler recorded no device time")
        for e in dev_ev:
            totals[e.name] = totals.get(e.name, 0.0) + e.time_range.elapsed_us()
    else:
        for e in prof.key_averages():
            totals[e.key] = e.self_cpu_time_total
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [(us / 1e3, name) for name, us in ranked]


class StageTimer:
    """Named stage timings as an explicit returned record (replaces the
    reference's object-mutation timing pattern); host clock, seconds."""

    def __init__(self):
        self.stages: dict[str, float] = {}
        self._t0 = None
        self._name = None

    def start(self, name: str):
        self._name = name
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        if self._name is not None:
            self.stages[self._name] = (self.stages.get(self._name, 0.0)
                                       + time.perf_counter() - self._t0)
            self._name = None
        return self.stages
