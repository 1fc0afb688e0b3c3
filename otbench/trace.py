"""What a traced window's profiler events say: device busy time, kernel
times by name, launch calls and idle gaps.

The busy time is the union of the device intervals (the arithmetic of
``profile_loc64._busy_us``) and the launch calls are the CUDA runtime's
and driver's launch entry points (``utils/profiling.LAUNCH_CALLS``), both
copied here so that a change to the port cannot change the yardstick.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

import torch
from torch.autograd import DeviceType

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
TOP = 10
MARK = "otbench.window"
"""The range around the traced window; its host event gives the window's
bounds on the profiler's clock (and its device-side copy is no work)."""


class Event(NamedTuple):
    name: str
    start_us: float
    end_us: float


class Summary(NamedTuple):
    """A traced window: its host-clock length, the device busy time (union
    of device intervals), device time by operation name, launch calls, and
    the idle gaps' time by what the host was doing."""

    window_s: float
    busy_s: float
    device_s: dict
    launches: int
    idle_by_host_op: dict


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def raw_events(prof):
    """(device events, host events) of a finished torch.profiler run, the
    window's mark left out of the device events."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        ev = Event(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type() == DeviceType.CUDA:
            if ev.name != MARK:
                dev.append(ev)
        else:
            host.append(ev)
    return dev, host


def host_op_at(host_sorted, starts, t: float, look: int = 256) -> str:
    """The innermost host event running at time t (the latest-started one
    that has not ended), or "python between ops" when none is found among
    the last ``look`` started (only the window's mark spans t)."""
    i = bisect.bisect_right(starts, t) - 1
    for e in host_sorted[max(0, i - look + 1):i + 1][::-1]:
        if e.end_us >= t:
            return e.name
    return "python between ops"


def summarize(prof, window_s: float) -> Summary:
    """The window's :class:`Summary` from its profiler run; the idle gaps
    are those inside the host event named :data:`MARK`."""
    dev, host = raw_events(prof)
    marks = [e for e in host if e.name == MARK]
    t0_us, t1_us = (marks[0].start_us, marks[0].end_us) if marks else (None, None)
    iv = [(e.start_us, e.end_us) for e in dev]
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end_us - e.start_us) / 1e6
    launches = sum(e.name in LAUNCH_CALLS for e in host)
    idle: dict[str, float] = {}
    if iv:
        lo = min(a for a, _ in iv) if t0_us is None else t0_us
        hi = max(b for _, b in iv) if t1_us is None else t1_us
        host_sorted = sorted(host, key=lambda e: e.start_us)
        starts = [e.start_us for e in host_sorted]
        for a, b in gaps(iv, lo, hi):
            name = host_op_at(host_sorted, starts, 0.5 * (a + b))
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return Summary(window_s, busy_us(iv) / 1e6, by_name, launches, idle)


def top(d: dict, n: int = TOP):
    """[[name, seconds], ...], the n largest."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def profile(activities_cuda: bool):
    """A torch.profiler context over the host and, on the card, the device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if activities_cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)
