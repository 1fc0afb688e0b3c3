"""The trace arithmetic (busy union, gaps, launches, idle attribution), the
kernel's bound and every metric reader, on synthetic events and runs."""

from __future__ import annotations

import math

import pytest
from torch.autograd import DeviceType

from otbench import harness, roofline, trace


def test_busy_union_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (10.0, 11.0)]
    assert trace.busy_us(iv) == 5.0
    assert trace.busy_us([]) == 0.0
    assert trace.gaps(iv, -1.0, 12.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 10.0), (11.0, 12.0)]


class _Ev:
    def __init__(self, name, dev, a_us, b_us):
        self._n, self._d, self._a, self._b = name, dev, a_us, b_us

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return int(self._a * 1e3)

    def end_ns(self):
        return int(self._b * 1e3)


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": staticmethod(lambda: events)})})


def test_summarize_synthetic_window():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    ev = [_Ev(trace.MARK, cpu, 0, 100), _Ev(trace.MARK, cuda, 0, 100),
          _Ev("aten::mul", cpu, 1, 9), _Ev("cudaLaunchKernel", cpu, 2, 3),
          _Ev("cuLaunchKernel", cpu, 3.5, 4.5), _Ev("cudaMemcpyAsync", cpu, 6, 7),
          _Ev("kern_a", cuda, 10, 30), _Ev("kern_b", cuda, 20, 40),
          _Ev("cudaStreamSynchronize", cpu, 40, 60), _Ev("kern_a", cuda, 60, 70)]
    s = trace.summarize(_Prof(ev), window_s=1e-4)
    assert s.launches == 2
    assert s.busy_s == pytest.approx(40e-6)
    assert s.device_s == pytest.approx({"kern_a": 30e-6, "kern_b": 20e-6})
    # gaps [0, 10) under aten::mul's span at 5 us, [40, 60) under the sync, [70, 100) under the mark
    assert s.idle_by_host_op == pytest.approx({"aten::mul": 10e-6, "cudaStreamSynchronize": 20e-6,
                                               trace.MARK: 30e-6})
    assert trace.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0], ["c", 2.0]]


@pytest.mark.parametrize("traces,ms", [(58212, 3.02918), (192, 0.0099911), (2112, 0.109902),
                                       (33, 0.0017172)])
def test_kernel_bound_frozen(traces, ms):
    # PERF.md's kernel table (f32, nt 61, 79x61): the frozen copy gives chip_smoke's bound
    assert roofline.kernel_bound_s(traces, 61, 79, 61, "float32") * 1e3 == pytest.approx(ms, rel=1e-4)


def _run(cell_name, **kw):
    cell = harness.load_cell(cell_name)
    return harness.Run(cell=cell, seed=1, **kw)


def test_metric_readers():
    summ = trace.Summary(window_s=2.0, busy_s=1.5,
                         device_s={"void distance_field_kernel<float, 1>(Args)": 0.06, "x": 1.0},
                         launches=3000, idle_by_host_op={})
    r = _run("farfield.scan", window_s=4.0, latencies_s=[0.5] * 8, setup_s=12.5,
             peak_bytes=3 * 2 ** 30, summary=summ)
    read = lambda m: harness.reader(m)(r)
    assert read("models_per_s") == pytest.approx(8 * 1764 / 4.0)
    assert read("scan_peak_gib") == pytest.approx(3.0)
    assert read("setup_s") == 12.5
    assert read("device_idle.scan") == pytest.approx(25.0)
    bound = roofline.kernel_bound_s(1764 * 33, 61, 79, 61, "float32")
    assert read("df_roofline") == pytest.approx(100 * bound * 8 / 0.06)
    c = _run("layered.calls", window_s=2.0, latencies_s=[0.01 * i for i in range(1, 101)],
             summary=summ)
    assert harness.reader("call_p95_ms")(c) == pytest.approx(1e3 * 0.9505)
    assert harness.reader("launches_per_call.calls")(c) == pytest.approx(30.0)
    s = _run("farfield.study", window_s=6.0, latencies_s=[2.0] * 3, evaluations=300,
             summary=summ)
    assert harness.reader("study_s")(s) == 2.0
    assert harness.reader("evals_per_study")(s) == 100.0
    assert harness.reader("launches_per_eval.study")(s) == 10.0


def test_readers_find_nothing_and_say_so():
    empty = _run("farfield.scan")
    for m in ("models_per_s", "scan_peak_gib", "df_roofline", "device_idle.scan",
              "launches_per_call.calls", "evals_per_study", "call_p95_ms", "study_s"):
        assert harness.reader(m)(empty) is None, m
    no_kernel = _run("layered.scan", window_s=1.0, latencies_s=[0.2],
                     summary=trace.Summary(1.0, 0.5, {"other": 0.5}, 10, {}))
    assert harness.reader("df_roofline")(no_kernel) is None
    assert math.isnan(empty.setup_s)
