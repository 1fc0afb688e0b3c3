"""The single-model value+grad as a CUDA graph replay
(``waveform_ot_torch.inversion.cuda_graph``), and the host constants of the
layered forward built once.

The CPU tests hold the decision of which calls take the graph, the cache
key, the kernel nodes each graph keeps beside its parameter count (and
the benchmark's readers of it), that a call after the first copies no
host data and reads nothing back (what a capture needs), and that the
layered seismograms are the same bit for bit as before the constants were
hoisted: the benchmark's frozen copy of the f-k forward
(``otbench/reference/layered.py``, the port's module at commit 8a4dc96) is
that "before". The tests marked ``cuda`` replay on the card, for the
location and the joint location + moment-tensor layout, and skip without
one. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graph.py
"""

import numpy as np
import pytest
import torch

from otbench import harness, trace
from otbench.reference import layered as frozen
from waveform_ot_torch.entry import _build_layered_problem, _build_problem
from waveform_ot_torch.inversion import (
    InvOptions, LocCMTObjective, TraceConfig, cuda_graph, loc_cmt_value_and_grad,
)
from waveform_ot_torch.inversion.loc_cmt import _value_and_grad
from waveform_ot_torch.models import cuda_surface, seismo
from waveform_ot_torch.models import layered as TL
from waveform_ot_torch.models.seismo import StationSet, upper_from_mxyz
from waveform_ot_torch.ops import cuda_distance

CPU = torch.device("cpu")
OPTS = InvOptions()
DM = (3.0, -2.0, 1.5)          # a model off the true source
TABLE = [(0.1, 3.2, 2.0, 2.1), (1.9, 5.15, 2.85, 2.5), (3.0, 5.5, 3.2, 2.6),
         (13.0, 6.0, 3.46, 2.7), (14.0, 6.7, 3.87, 2.8), (float("inf"), 7.7, 4.3, 3.3)]
# a string condition is evaluated when each test runs, not at import
on_card = pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")


# --- which calls take the graph ------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, for the decision alone."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("shape, capturing, inference, takes", [
    ((3,), False, False, True), ((1, 3), False, False, True), ((2, 3), False, False, False),
    ((1764, 3), False, False, False), ((3,), True, False, False), ((3,), False, True, False),
], ids=["model", "batch_of_1", "batch_of_2", "scan", "capturing", "inference_mode"])
def test_only_a_single_model_outside_capture_and_inference_engages(monkeypatch, shape,
                                                                   capturing, inference, takes):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    ms = torch.zeros(shape).as_subclass(_OnCard)
    with torch.inference_mode(inference):
        assert cuda_graph.engages(ms) is takes


@pytest.fixture
def no_held_graphs():
    """No graph left by an earlier test in the process (the card tests of
    tests/test_torch_cuda.py capture some), so the test holds in any order."""
    cuda_graph.clear()


@pytest.mark.usefixtures("no_held_graphs")
@pytest.mark.parametrize("shape", [(3,), (1, 3), (2, 3)])
def test_cpu_calls_never_reach_the_graph_path(monkeypatch, shape):
    loc, cfg, prob = _build_problem(3, torch.float64, CPU)

    def refuse(*a, **k):
        raise AssertionError("a CPU call reached the graph path")

    monkeypatch.setattr(cuda_graph, "value_and_grad", refuse)
    calls = dict(cuda_graph.CALLS)
    ms = (loc + torch.tensor(DM, dtype=torch.float64)).expand(shape).clone()
    v, g = loc_cmt_value_and_grad(ms, prob, OPTS, cfg)
    assert v.shape == shape[:-1] and g.shape == shape
    assert cuda_graph.CALLS == calls and not cuda_graph._GRAPHS


# --- the cache key -------------------------------------------------------------------

@pytest.fixture(scope="module")
def far():
    loc, cfg, prob = _build_problem(3, torch.float64, CPU)
    return loc, cfg, prob


CHANGES = {
    "the model's values": (lambda m, p, o, c, f: (m + 1.0, p, o, c, f), True),
    "the problem rebuilt over its buffers": (
        lambda m, p, o, c, f: (m, LocCMTObjective(p, o, c).tree(), o, c, f), True),
    "a problem tensor moved": (
        lambda m, p, o, c, f: (m, p._replace(mscal=p.mscal.clone()), o, c, f), False),
    "a window tensor moved": (
        lambda m, p, o, c, f: (m, p._replace(windows=p.windows._replace(
            u0=p.windows.u0.clone())), o, c, f), False),
    "another forward": (lambda m, p, o, c, f: (m, p, o, c, lambda *a: None), False),
    "other options": (lambda m, p, o, c, f: (m, p, InvOptions(zmin=0.5), c, f), False),
    "another configuration": (
        lambda m, p, o, c, f: (m, p, o, TraceConfig(nu=c.nu, ntg=c.ntg, lambdav=0.05), f),
        False),
    "a batch of one": (lambda m, p, o, c, f: (m[None], p, o, c, f), False),
    "another dtype": (lambda m, p, o, c, f: (m.float(), p, o, c, f), False),
}


@pytest.mark.parametrize("change", list(CHANGES))
def test_key_changes_with_what_the_graph_reads(far, change):
    loc, cfg, prob = far
    base = (loc + torch.tensor(DM, dtype=loc.dtype), prob, OPTS, cfg, None)
    edit, same = CHANGES[change]
    assert (cuda_graph.key(*base) == cuda_graph.key(*edit(*base))) is same


def test_key_holds_a_module_forwards_state(far):
    loc, cfg, prob = far
    fwd = torch.nn.Linear(3, 3)
    k0 = cuda_graph.key(loc, prob, OPTS, cfg, fwd)
    with torch.no_grad():
        fwd.weight.add_(1.0)                 # in place: the graph reads the new values
    assert cuda_graph.key(loc, prob, OPTS, cfg, fwd) == k0
    fwd.weight = torch.nn.Parameter(fwd.weight.detach().clone())
    assert cuda_graph.key(loc, prob, OPTS, cfg, fwd) != k0


# --- what a graph holds: its kernel nodes beside its parameter count ----------------

class _FakeDriver:
    """cuGraphGetNodes and cuGraphNodeGetType over a table of graphs, each a
    list of node types (0: a kernel node), called as the CUDA driver is."""

    def __init__(self, table):
        self.table = table

    def cuGraphGetNodes(self, graph, nodes, count):
        types = self.table[graph.value]
        if nodes is not None:
            for i in range(count._obj.value):
                nodes[i] = (graph.value << 8) + i
        count._obj.value = len(types)
        return 0

    def cuGraphNodeGetType(self, node, kind):
        kind._obj.value = self.table[node >> 8][node & 0xFF]
        return 0


class _FakeGraph:
    """A CUDAGraph that refuses what a kept, instantiated graph refuses."""

    made = 0

    def __init__(self, keep_graph=False):
        assert keep_graph, "the graph has to be kept to count its nodes"
        _FakeGraph.made += 1
        self.raw, self.instantiated = _FakeGraph.made, False

    def raw_cuda_graph(self):
        assert not self.instantiated
        return self.raw

    def instantiate(self):
        self.instantiated = True

    def replay(self):
        assert self.instantiated


def _fake_card(monkeypatch, table):
    """The capture and replay machinery of torch.cuda made inert, so that a
    CPU call runs the graph path's bookkeeping: the capture runs the call,
    a replay returns the captured outputs."""
    import contextlib

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda d=None: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", lambda g, stream=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda t, s: None)
    monkeypatch.setattr(cuda_graph, "_STREAMS", {})
    monkeypatch.setattr(cuda_graph, "_driver", lambda: _FakeDriver(table))
    _FakeGraph.made = 0


def test_each_graph_keeps_its_kernel_nodes_beside_its_parameter_count(monkeypatch, fresh):
    """A location graph and a joint one, each captured and replayed once:
    each is held with its own parameter count (3, 9) and the kernel nodes
    of the graph its capture recorded (other nodes not counted), and
    ``CALLS`` keeps its keys and counts."""
    loc, cfg, prob = _build_problem(3, torch.float64, CPU)
    _fake_card(monkeypatch, {1: [0, 0, 1, 0, 2], 2: [0, 3, 0, 0, 0, 0, 10, 0]})
    calls = dict(cuda_graph.CALLS)
    for layout in LAYOUTS:
        opts, p, ms = _layout(layout, loc, prob)
        first = cuda_graph.value_and_grad(_value_and_grad, ms[0], p, opts, cfg, None)
        again = cuda_graph.value_and_grad(_value_and_grad, ms[1], p, opts, cfg, None)
        assert all(torch.equal(a, b) for a, b in zip(first, again))   # the captured outputs
    assert cuda_graph.graphs() == [{"params": 3, "kernels": 3, "replays": 1},
                                   {"params": 9, "kernels": 6, "replays": 1}]
    assert set(cuda_graph.CALLS) == {"captures", "replays", "eager"}
    assert {k: cuda_graph.CALLS[k] - calls[k] for k in calls} == {
        "captures": 2, "replays": 2, "eager": 2}


def test_a_driver_error_while_counting_nodes_raises(monkeypatch):
    graph = _FakeGraph(keep_graph=True)
    drv = _FakeDriver({graph.raw: [0, 0]})
    drv.cuGraphNodeGetType = lambda node, kind: 400        # CUDA_ERROR_INVALID_HANDLE
    monkeypatch.setattr(cuda_graph, "_driver", lambda: drv)
    with pytest.raises(RuntimeError, match="cuGraphNodeGetType failed with CUresult 400"):
        cuda_graph.kernel_nodes(graph)


def _read(metric, **run):
    summary = run.pop("summary", None)
    r = harness.Run(cell=None, seed=1, summary=summary and trace.Summary(*summary), **run)
    return harness.reader(metric)(r)


def test_the_benchmark_reads_the_replayed_graphs_kernel_nodes(monkeypatch):
    """graph_kernels.calls: the kernel nodes of the graphs replayed, weighted
    by their replays, read from the loaded module; nothing where no graph
    was replayed or the module keeps no such count (before it did)."""
    held = [{"params": 3, "kernels": 2400, "replays": 0},
            {"params": 9, "kernels": 2700, "replays": 3},
            {"params": 9, "kernels": 2900, "replays": 1}]
    monkeypatch.setattr(cuda_graph, "graphs", lambda: held)
    assert _read("graph_kernels.calls") == (3 * 2700 + 2900) / 4
    monkeypatch.setattr(cuda_graph, "graphs", lambda: held[:1])
    assert _read("graph_kernels.calls") is None
    monkeypatch.delattr(cuda_graph, "graphs")
    assert _read("graph_kernels.calls") is None


def test_the_benchmark_reads_device_time_per_call():
    """device_ms_per_call.calls: the traced window's busy time over its calls."""
    summary = (2.0, 0.75, {}, 0, {})
    assert _read("device_ms_per_call.calls", latencies_s=[0.01] * 125,
                 summary=summary) == pytest.approx(6.0)
    assert _read("device_ms_per_call.calls", latencies_s=[0.01] * 125) is None
    assert _read("device_ms_per_call.calls", summary=summary) is None


# --- what a capture needs: no host data in, nothing read back ------------------------

def _guard(monkeypatch):
    """Make every copy of host data to a tensor and every read of a tensor's
    value on the host raise."""
    def refuse(what):
        def fn(*a, **k):
            raise AssertionError(f"{what} inside the call")
        return fn

    real_as_tensor, real_getitem = torch.as_tensor, torch.Tensor.__getitem__

    def as_tensor(data, *a, **k):
        if not isinstance(data, torch.Tensor):
            raise AssertionError(f"as_tensor of host data {type(data)} inside the call")
        return real_as_tensor(data, *a, **k)

    def getitem(self, idx):
        for i in idx if isinstance(idx, tuple) else (idx,):
            if isinstance(i, (list, np.ndarray, range)):
                raise AssertionError(f"indexing by host data {i!r} inside the call")
        return real_getitem(self, idx)

    monkeypatch.setattr(torch, "tensor", refuse("torch.tensor"))
    monkeypatch.setattr(torch, "from_numpy", refuse("torch.from_numpy"))
    monkeypatch.setattr(torch, "as_tensor", as_tensor)
    monkeypatch.setattr(torch.Tensor, "__getitem__", getitem)
    for name in ("item", "tolist", "numpy", "__bool__", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))


@pytest.mark.parametrize("physics", ["farfield", "layered", "layered_default_model"])
def test_a_call_after_the_first_copies_no_host_data(monkeypatch, physics):
    """What a CUDA graph capture needs: after one call, a value+grad call
    of one model creates no tensor from host data and reads no tensor's
    value back; the layered forward built its grids, source spectrum and
    Bessel tables at the first call."""
    if physics == "farfield":
        loc, cfg, prob = _build_problem(3, torch.float32, CPU)
        fwd = None
    else:
        loc, cfg, prob, fwd = _build_layered_problem(3, nk=32, dtype=torch.float32, device=CPU)
        if physics == "layered_default_model":
            fwd = TL.make_layered_forward(prob.stations, nt=61, nk=32, kmax=2.0)
    m = loc + torch.tensor(DM)
    first = _value_and_grad(m, prob, OPTS, cfg, fwd)
    _guard(monkeypatch)
    again = _value_and_grad(m, prob, OPTS, cfg, fwd)
    monkeypatch.undo()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


# --- the hoisted constants: bit for bit as before ------------------------------------

def _sources(dtype):
    st = StationSet(torch.tensor([30.0, -20.0, 5.0], dtype=dtype),
                    torch.tensor([10.0, 25.0, -40.0], dtype=dtype))
    mxyz = torch.tensor([[1.0, 0.2, 0.3], [0.2, -0.5, 0.1], [0.3, 0.1, -0.5]], dtype=dtype)
    xyz = [torch.tensor(v, dtype=dtype) for v in ([2.0, 3.0], [-1.5, 0.5], [12.0, 1.5])]
    return st, mxyz, xyz


ROUTES = {
    "layered_seismograms": lambda st, m, x, y, z, kw: TL.layered_seismograms(
        x, y, z, m, st, model=TL.fukuoka_model(device=CPU), **kw)[1],
    "forward": lambda st, m, x, y, z, kw: TL.make_layered_forward(
        st, model=TL.fukuoka_model(device=CPU), **kw)(x, y, z, m),
    "forward_plain_autograd": lambda st, m, x, y, z, kw: TL.make_layered_forward(
        st, model=TL.fukuoka_model(device=CPU), structured_vjp=False, **kw)(x, y, z, m),
    "forward_default_model": lambda st, m, x, y, z, kw: TL.make_layered_forward(st, **kw)(
        x, y, z, m),
    "stages": lambda st, m, x, y, z, kw: _staged(st, m, x, y, z, kw),
}


def _staged(st, m, x, y, z, kw):
    stage_a, stage_b, _ = TL.make_layered_stages(model=TL.fukuoka_model(device=CPU), **kw)
    return stage_b(stage_a(z), x, y, z, TL._moment_coeffs(m), st)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_hoisted_constants_give_the_seismograms_of_before(route, dtype):
    """Twice through one forward (the second call on the kept constants),
    equal bit for bit to the frozen copy of the module from before."""
    st, mxyz, (x, y, z) = _sources(dtype)
    kw = dict(nt=33, nk=64, kmax=1.5)
    before = frozen.make_layered_forward(st, frozen.layered_model_from_table(TABLE, device=CPU),
                                         **kw)(x, y, z, mxyz)
    fn = ROUTES[route]
    for _ in range(2):
        with torch.no_grad():
            assert torch.equal(fn(st, mxyz, x, y, z, kw), before)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_moment_coefficients_and_medium_defaults_of_before(dtype):
    """The z-down signs written out equal the product with the flip pattern,
    and the default medium and the symmetric index are the values of
    before, bit for bit."""
    m = torch.randn(4, 3, 3, dtype=dtype, generator=torch.Generator().manual_seed(3))
    flip = torch.tensor([[1.0, 1.0, -1.0], [1.0, 1.0, -1.0], [-1.0, -1.0, 1.0]], dtype=dtype)
    assert all(torch.equal(a, b) for a, b in zip(TL._moment_coeffs(m),
                                                 frozen._moment_coeffs(m)))
    assert torch.equal(torch.stack(TL._moment_coeffs(m)),
                       torch.stack(frozen._moment_coeffs(m * flip * flip)))
    med = seismo.MediumConfig.default(dtype, CPU)
    for got, v in zip(med, (6.0, 3.46, 2.7)):
        want = torch.tensor(v, dtype=dtype)
        assert got.dtype == want.dtype and torch.equal(got, want)
    u = torch.arange(6.0, dtype=dtype)
    assert torch.equal(seismo.mxyz_from_upper(u), u[torch.tensor(seismo._SYM_INDEX)])


# --- on the card ---------------------------------------------------------------------

def _card_problem(physics, dtype):
    from chip_smoke import build_layered_problem, build_loc64_problem

    dev = torch.device("cuda")
    if physics == "farfield":
        loc, cfg, prob = build_loc64_problem(11, dtype, dev)
        return loc, cfg, prob, None
    loc, cfg, prob, fwd, _ = build_layered_problem(dtype, dev)
    return loc, cfg, prob, fwd


def _models(loc):
    steps = torch.tensor([[3.0, -2.0, 1.5], [-4.0, 1.0, -2.0], [1.0, 5.0, 3.0]])
    return [loc + s.to(loc) for s in steps]


LAYOUTS = ["loc", "loc_cmt"]
JOINT = InvOptions(cmt=True, precon=True)
MT_STEPS = ((0.2, -0.1, 0.25, -0.3, 0.05, 0.15), (-0.25, 0.3, -0.05, 0.1, -0.2, 0.0),
            (0.1, 0.1, -0.3, 0.2, 0.3, -0.15))


def _layout(layout, loc, prob):
    """(options, problem, models) of ``layout``: the location alone, or the
    joint location + moment tensor preconditioned as the benchmark's
    ``fukuoka11cmt`` (60 km for the location, max |M| of the true tensor
    for its six components), each component of the true tensor moved by
    up to 30%."""
    if layout == "loc":
        return OPTS, prob, _models(loc)
    mt = upper_from_mxyz(prob.mxyz_fixed)
    mscal = torch.cat([torch.full_like(loc, 60.0), mt.abs().max().expand(6)])
    ms = [torch.cat([m, mt * (1.0 + torch.tensor(d).to(mt))]) / mscal
          for m, d in zip(_models(loc), MT_STEPS)]
    return JOINT, prob._replace(mscal=mscal), ms


# The moment-tensor block of the layered float64 gradient between two eager
# calls: up to 3,364 ulps of the largest entry (replay against eager 4,832;
# six calls of each, measured on an H100). Its entries are sums over the f-k
# response with much cancellation, which magnifies the atomics' reordering
# ~1,000-fold; the location block and every float32 or far-field block stay
# within 5 ulps.
MT_ULPS = {("layered", torch.float64): 2 ** 14}


def _assert_as_eager(got, want, exact: bool, mt_ulps: int = 64):
    """The value bit for bit; the gradient bit for bit when ``exact`` (with
    deterministic algorithms), else within the eager path's own spread from
    run to run: the envelope and W2 backwards sum by scatter_add_, whose
    atomics add in varying order (1-4 ulps of the largest entry between two
    eager calls, measured on an H100), so 64 ulps; the moment-tensor block
    of a joint gradient within ``mt_ulps`` (:data:`MT_ULPS`)."""
    assert torch.equal(got[0], want[0])
    if exact:
        assert torch.equal(got[1], want[1])
    else:
        unit = torch.finfo(want[1].dtype).eps * want[1].abs().max().item()
        for block, ulps in ((slice(0, 3), 64), (slice(3, None), mt_ulps)):
            torch.testing.assert_close(got[1][block], want[1][block], rtol=0, atol=ulps * unit)


@pytest.fixture
def fresh():
    cuda_graph.clear()
    yield
    cuda_graph.clear()


@pytest.fixture(params=[False, True], ids=["default", "deterministic"])
def deterministic(request):
    """Run with torch's deterministic algorithms (warn only: cuBLAS would
    need an environment variable set before start) or without them."""
    was, warn = torch.are_deterministic_algorithms_enabled(), \
        torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(request.param, warn_only=True)
    yield request.param
    torch.use_deterministic_algorithms(was, warn_only=warn)


@pytest.mark.cuda
@on_card
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("physics", ["farfield", "layered"])
def test_replay_equals_eager(fresh, deterministic, physics, dtype, layout):
    """Three models in a row (a capture, then replays) against eager calls
    (:func:`_assert_as_eager`). Each call's outputs keep their values after
    the next call, the launch counter advances by one per call, and the
    graph is held with its parameter count and its kernel nodes. The
    layered forward's stage A is its kernel: one launch in each eager call
    (the first call and the three references) and one the capture records."""
    loc, cfg, prob, fwd = _card_problem(physics, dtype)
    opts, prob, ms = _layout(layout, loc, prob)
    nm = ms[0].shape[0]
    kept = []
    calls = dict(cuda_graph.CALLS)
    surface = cuda_surface.LAUNCHES
    for m in ms:
        before = cuda_distance.LAUNCHES
        got = loc_cmt_value_and_grad(m, prob, opts, cfg, forward=fwd)
        torch.cuda.synchronize()
        assert cuda_distance.LAUNCHES - before == 1
        assert got[0].shape == () and got[1].shape == (nm,)
        _assert_as_eager(got, _value_and_grad(m, prob, opts, cfg, fwd), deterministic,
                         MT_ULPS.get((physics, dtype), 64))
        kept.append((got, [t.clone() for t in got]))
    assert all(torch.equal(a, b) for got, snap in kept for a, b in zip(got, snap))
    assert {k: cuda_graph.CALLS[k] - calls[k] for k in calls} == {
        "captures": 1, "replays": 2, "eager": 1}
    assert cuda_surface.LAUNCHES - surface == (5 if physics == "layered" else 0)
    (held,) = cuda_graph.graphs()
    assert held["params"] == nm and held["replays"] == 2 and held["kernels"] > 100


@pytest.mark.cuda
@on_card
@pytest.mark.parametrize("layout", LAYOUTS)
def test_rebuilt_problem_replays_and_a_moved_one_captures(fresh, layout):
    """LocCMTObjective rebuilds its problem on every call over the same
    buffers: one capture, then replays. The objective moved to new buffers
    (a copy of each) captures anew, at its first call, since the first
    graph has been replayed."""
    loc, cfg, prob, fwd = _card_problem("layered", torch.float32)
    opts, prob, (m0, m1, m2) = _layout(layout, loc, prob)
    obj = LocCMTObjective(prob, opts, cfg, forward=fwd)
    calls = dict(cuda_graph.CALLS)
    delta = lambda: {k: cuda_graph.CALLS[k] - calls[k] for k in calls}
    obj.value_and_grad(m0)
    obj.value_and_grad(m1)
    assert delta() == {"captures": 1, "replays": 1, "eager": 1}
    moved = LocCMTObjective(prob, opts, cfg, forward=fwd)
    for name, buf in list(moved.named_buffers()):
        setattr(moved, name, buf.clone())
    got = moved.value_and_grad(m2)
    assert delta() == {"captures": 2, "replays": 1, "eager": 2}
    _assert_as_eager(got, _value_and_grad(m2, obj.tree(), opts, cfg, fwd), exact=False)
    moved.value_and_grad(m0)
    assert delta() == {"captures": 2, "replays": 2, "eager": 2}


@pytest.mark.cuda
@on_card
def test_batch_of_models_never_captures(fresh):
    """(k, 3) models with k > 1 stay eager: no capture, no replay, no eager
    single-model count; one launch per call."""
    loc, cfg, prob, fwd = _card_problem("layered", torch.float32)
    ms = torch.stack(_models(loc))
    calls = dict(cuda_graph.CALLS)
    for k in (2, 3, 2):
        before = cuda_distance.LAUNCHES
        v, g = loc_cmt_value_and_grad(ms[:k], prob, OPTS, cfg, forward=fwd)
        torch.cuda.synchronize()
        assert cuda_distance.LAUNCHES - before == 1 and v.shape == (k,)
    assert cuda_graph.CALLS == calls and not cuda_graph._GRAPHS
