"""The port's benchmark program (waveform_ot_torch.bench) against bench.py.

On the CPU. ``_emit`` and ``main`` are held string for string against
bench.py's on the same results, statuses and stage fakes. Each stage's
problem is held against bench.py's own function where it returns its
numbers, else against its lines rebuilt step for step. bench.py runs with
JAX's x64 off (float32 everywhere); this process has x64 on, so the float32
stages' JAX side runs under ``jax.enable_x64(False)``, the mode bench.py runs
in. The node and start arrays are taken from bench.py's own functions, run up
to their ``_time`` call. Each test states its tolerance.

JAX's layered builder (``bench._build_layered_problem``) runs double-float32
in float32 (87 s to compile at nt 16 on a CPU host), so its numbers are read
from the arguments it passes to ``make_layered_forward`` and the layered
physics is not run on the JAX side here (tests/test_torch_entry.py holds the
builder in float64).
"""

import itertools
import json
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
import bench
import chip_smoke
import waveform_ot_tpu.models as jm
from waveform_ot_torch import bench as B
from waveform_ot_torch import entry as E
from waveform_ot_torch import inversion as ti
from waveform_ot_torch.models import fukuoka_model, make_layered_stages
from waveform_ot_torch.ops import cuda_distance
from waveform_ot_tpu import inversion as ji

CPU, F32, F64 = torch.device("cpu"), torch.float32, torch.float64
BASELINE = json.loads((B.REPO / "bench_baseline.json").read_text())
JAX_LOC = (2.0, -1.5, 12.0)        # __graft_entry__.py:47 and bench.py:228


class _Reached(Exception):
    """Raised by a fake to stop a bench.py function where it was reached."""


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    before = cuda_distance.LAUNCHES
    yield
    assert cuda_distance.LAUNCHES == before


def _results():
    """Raw stage numbers of every stage, as run_stage returns them."""
    return {
        "loc64": {"per": 0.0061234567}, "ricker": {"per": 0.0123456789},
        "bigfp": {"per": 0.0301234}, "loc1024": {"per": 0.0072127},
        "scan": {"per": 0.0214405, "n_nodes": 1764},
        "multistart": {"per": 0.538385, "n_starts": 64},
        "f32dev": {"dv": 2.6021e-07, "dg": 4.13571e-05},
        "layered": {"per": 0.0519819}, "layered_scan": {"per": 0.1440871, "n_nodes": 1764},
        "layered_ms": {"per": 4.3490268, "n_starts": 64}}


def _emitted(capsys, emit, results, status):
    capsys.readouterr()
    emit(results, BASELINE, status)
    return capsys.readouterr().out


@pytest.mark.parametrize("case", ["all", "missing", "failed"])
def test_emit_matches_bench(capsys, case):
    """The same results, statuses and baseline give bench._emit's line,
    character for character: every stage present, the last four missing
    (skipped for the budget, nulls), and one failed stage. chip_smoke.py's
    phase 18 holds the card's line to the metric strings printed here."""
    results, status = _results(), {name: "ok" for name in B.STAGES}
    if case == "missing":
        for name in B.STAGES[-4:]:
            del results[name]
            status[name] = "skipped:budget"
    elif case == "failed":
        del results["scan"]
        status["scan"] = "failed:RuntimeError"
    got = _emitted(capsys, B._emit, results, status)
    want = _emitted(capsys, bench._emit, results, status)
    assert got == want
    line = json.loads(got)
    assert line["stages"] == status and line["metric"] == chip_smoke.BENCH_HEADLINE
    assert [r["metric"] for r in line["extra"]] == chip_smoke.BENCH_METRICS


def test_main_matches_bench(capsys, monkeypatch):
    """main() of both programs with the same stage fake (ricker fails) and
    the same clock (140 s per reading against the 1,200 s budget, so the last
    two stages are skipped) prints the same lines; the port exits 1, bench.py
    0."""
    def fake_stage(name, timeout, *device):
        if name == "ricker":
            raise RuntimeError("bench stage ricker failed")
        return _results()[name]

    outs = {}
    for mod, run in ((bench, bench.main), (B, lambda: B.main(["--device", "cpu"]))):
        monkeypatch.setattr(mod, "_run_stage_subprocess", fake_stage)
        monkeypatch.setattr(mod, "_BUDGET_S", 1200.0)
        clock = itertools.count(0.0, 140.0)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=lambda clock=clock: next(clock), strftime=time.strftime))
        capsys.readouterr()
        rc = run()
        outs[mod.__name__] = (rc, capsys.readouterr().out.splitlines())
    rc_jax, jax_lines = outs["bench"]
    rc_port, port_lines = outs["waveform_ot_torch.bench"]
    # a skipped stage prints no line of its own (bench.py:584-587)
    assert port_lines == jax_lines and len(port_lines) == len(B.STAGES) - 2
    stages = json.loads(port_lines[-1])["stages"]
    assert list(stages) == B.STAGES[:-2] and stages["ricker"] == "failed:RuntimeError"
    assert rc_jax is None and rc_port == 1


def test_loc_stage_matches_bench():
    """bench_loc_cmt(4, 1, "cpu") against bench.bench_loc_cmt(4, "jnp", 1),
    both float32: value within 1e-5 relative and gradient within 1e-3 of
    max |g| (measured 9.3e-07 and 1.1e-06 here)."""
    with jax.enable_x64(False):
        _, v_j, g_j = bench.bench_loc_cmt(4, "jnp", 1)
    per, v, g, counts = B.bench_loc_cmt(4, 1, CPU)
    assert g.dtype == np.float32 and g_j.dtype == np.float32 and per > 0
    assert abs(v - v_j) <= 1e-5 * abs(v_j)
    assert np.abs(g - g_j).max() <= 1e-3 * np.abs(g_j).max()
    assert counts == {"launches_per_call": 0.0}


def test_f64_oracle_matches_bench():
    """The f32dev stage's float64 CPU half at 4 stations against
    bench._F64_ORACLE_CODE's computation (jitted here), within 1e-10
    relative (measured 4.3e-15 and 1.3e-15 of max |g|)."""
    loc, cfg, prob = G._build_problem(nr=4, impl="jnp", dtype=jnp.float64)
    opts = ji.InvOptions(loc=True, cmt=False, mistype="OT")
    m = loc + jnp.asarray([4.0, -3.0, 2.0], jnp.float64)
    v_j, g_j = jax.jit(lambda mm, pp: ji.loc_cmt_value_and_grad(
        mm, pp, opts, cfg, impl="jnp"))(m, prob)
    v, g = B.f64_oracle(4)
    np.testing.assert_allclose(v, float(v_j), rtol=1e-10)
    assert np.abs(g - np.asarray(g_j)).max() <= 1e-10 * np.abs(np.asarray(g_j)).max()


def test_ricker_stage_matches_bench():
    """The ricker stage's problem against bench_ricker's lines (bench.py:
    110-125) rebuilt step for step with x64 off: value and gradient at
    (0.7, 1.1, 1.3), float32 both, within 1e-5 relative and 1e-4 of max |g|
    (two float32 pipelines summing 80x512 grid points in their own orders;
    measured 2.8e-07 and 1.0e-06 here)."""
    from waveform_ot_tpu.inversion.pipeline import grid6_to_window
    from waveform_ot_tpu.models import ricker_wavelet

    with jax.enable_x64(False):
        trange = (-2.0, 7.0)
        tobs, wobs = ricker_wavelet(0.0, 1.6, 1.0, trange=trange)
        tobs, wobs = tobs.astype(jnp.float32), wobs.astype(jnp.float32)
        rng = np.random.default_rng(42)
        wobs = wobs + 0.005 * float(jnp.max(jnp.abs(wobs))) * jnp.asarray(
            rng.standard_normal(wobs.shape), jnp.float32)
        grid6 = (-2.0, 7.0, -2.0, 2.6, 80, 512)
        win, _ = grid6_to_window(grid6)
        cfg = ji.TraceConfig(nu=80, ntg=512, lambdav=0.03, q=None, p=2, transform=True)
        targets = ji.build_target(tobs, wobs, win, cfg, impl="jnp")
        prob_j, _ = ji.make_ricker_problem(targets, grid6, trange=trange, alpha=0.5,
                                           lambdav=0.03)
        m_j = jnp.array([0.7, 1.1, 1.3], jnp.float32)
        v_j, g_j = jax.jit(lambda mm: ji.ricker_value_and_grad(mm, prob_j, cfg, impl="jnp"))(m_j)
        v_j, g_j = float(v_j), np.asarray(g_j)
    prob, cfg_t, m = B.ricker_problem(CPU)
    v, g = ti.ricker_value_and_grad(m, prob, cfg_t)
    assert m.dtype == g.dtype == F32
    assert abs(v.item() - v_j) <= 1e-5 * abs(v_j)
    assert np.abs(g.numpy() - g_j).max() <= 1e-4 * np.abs(g_j).max()


def test_bigfp_density_matches_jax(monkeypatch):
    """The bigfp stage's density of the 626-sample demo waveform against
    JAX's fingerprint_density(impl="jnp") on bench.py:338-345's inputs, at
    an 80x60 grid in float64, within 1e-12."""
    from waveform_ot_tpu.ops.fingerprint import (
        FingerprintSpec, fingerprint_density, make_window,
    )

    monkeypatch.setattr(B, "BIGFP_GRID", (80, 60))
    fn, w = B.big_fingerprint(F64, CPU)
    pdf = fn(w)
    t = jnp.asarray(np.linspace(0.0, 1.0, 626), jnp.float64)
    wj = 2 * jnp.sin(t * 6 * np.pi) - 3 * jnp.cos((2 * t + 0.30) * 2 * np.pi)
    du = float(wj.max() - wj.min())
    win = make_window(float(t[0]), float(t[-1]),
                      float(wj.min()) - 0.15 * du, float(wj.max()) + 0.15 * du)
    ref = fingerprint_density(t, wj, win, FingerprintSpec(nu=80, ntg=60), lambdav=0.04,
                              impl="jnp")[0]
    assert pdf.shape == (80, 60)
    np.testing.assert_allclose(w[0].numpy(), np.asarray(wj), rtol=0, atol=1e-14)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)


def _reached_time(monkeypatch, fn, *args):
    """bench.py's stage function run up to its _time call: the arguments it
    times."""
    def stop(f, a, n):
        raise _Reached(a)

    monkeypatch.setattr(bench, "_time", stop)
    with pytest.raises(_Reached) as hit:
        fn(*args)
    return hit.value.args[0]


def test_nodes_and_starts_match_bench(monkeypatch):
    """The scan nodes, both studies' starts and the layered scan's depths
    and (x, y) nodes equal the arrays bench.py's stage functions time, bit
    for bit (float32); the layered scan's stages take bench.py's nt, dt, nk
    and kmax."""
    f32 = lambda a: np.asarray(a, np.float32)
    loc = jnp.asarray(JAX_LOC, jnp.float32)
    monkeypatch.setattr(G, "_build_problem", lambda **kw: (loc, None, None))
    monkeypatch.setattr(bench, "_build_layered_problem",
                        lambda impl: (loc, None, None, None, None, None))
    stage_kw = {}
    monkeypatch.setattr(jm, "make_layered_stages", lambda **kw: stage_kw.update(kw))
    with jax.enable_x64(False):
        ms, _ = _reached_time(monkeypatch, bench.bench_grid_scan, "jnp", 1)
        (starts,) = _reached_time(monkeypatch, bench.bench_multi_start, "jnp", 1)
        (lstarts,) = _reached_time(monkeypatch, bench.bench_layered_multistart, "jnp", 1)
        zs, xy, _ = _reached_time(monkeypatch, bench.bench_layered_scan, "jnp", 1)
    assert tuple(E.LOC) == JAX_LOC
    port_starts = B.study_starts(torch.tensor(E.LOC, dtype=F32)).numpy()
    np.testing.assert_array_equal(B.scan_nodes(F32, CPU).numpy(), f32(ms))
    np.testing.assert_array_equal(port_starts, f32(starts))
    np.testing.assert_array_equal(port_starts, f32(lstarts))
    pzs, pxy = B.layered_scan_axes(F32, CPU)
    np.testing.assert_array_equal(pzs.numpy(), f32(zs))
    np.testing.assert_array_equal(pxy.numpy(), f32(xy))

    got = {}

    def stages_stop(**kw):
        got.update(kw)
        raise _Reached

    monkeypatch.setattr(B, "_build_layered_problem", lambda device: (None,) * 4)
    monkeypatch.setattr(B, "make_layered_stages", stages_stop)
    with pytest.raises(_Reached):
        B.bench_layered_scan(1, CPU)
    keys = ("nt", "dt", "nk", "kmax")
    assert {k: got[k] for k in keys} == {k: stage_kw[k] for k in keys}


def test_layered_problem_numbers_match_bench(monkeypatch):
    """bench._build_layered_problem's stations, nt, dt, nk and kmax (read
    from its make_layered_forward call) are the ones the port passes to
    entry._build_layered_problem: 11 stations, nt 61, nk 512, kmax 2.0."""
    seen = {}

    def forward_stop(stations, **kw):
        seen.update(kw, nr=int(stations.x.shape[0]))
        raise _Reached

    monkeypatch.setattr(jm, "make_layered_forward", forward_stop)
    with jax.enable_x64(False), pytest.raises(_Reached):
        bench._build_layered_problem("jnp")
    got = {}
    monkeypatch.setattr(E, "_build_layered_problem",
                        lambda nr, **kw: got.update(kw, nr=nr))
    B._build_layered_problem(CPU)
    assert {k: got[k] for k in ("nr", "nt", "nk", "kmax")} == \
        {k: seen[k] for k in ("nr", "nt", "nk", "kmax")} == \
        {"nr": 11, "nt": 61, "nk": 512, "kmax": 2.0}
    assert seen["dt"] == 1.0 and got["dtype"] == F32


@pytest.fixture(scope="module")
def small_layered():
    """A 2-station layered problem (nt 16, nk 24, kmax 1), float64 on the
    CPU: (loc, cfg, prob, forward, stages)."""
    kw = dict(nt=16, nk=24, kmax=1.0)
    model = fukuoka_model(device=CPU)
    return (*E._build_layered_problem(2, model=model, dtype=F64, device=CPU, **kw),
            make_layered_stages(model=model, dt=1.0, **kw))


def test_layered_scan_chunks_change_nothing(small_layered):
    """layered_misfit_grid with xy_chunk (bench.py's v5e chunking, dropped by
    the port's bench) equals the unchunked call: 2 depths x 4 (x, y) nodes in
    chunks of 3, values and gradients within 1e-12 relative."""
    _, cfg, prob, _, stages = small_layered
    zs = torch.tensor([8.0, 14.0], dtype=F64)
    xy = torch.tensor([[-6.0, 3.0], [0.0, 0.0], [4.0, -5.0], [9.0, 7.0]], dtype=F64)
    v, g = ti.layered_misfit_grid(zs, xy, prob, E.LOC_ONLY, cfg, stages)
    vc, gc = ti.layered_misfit_grid(zs, xy, prob, E.LOC_ONLY, cfg, stages, xy_chunk=3)
    assert v.shape == (2, 4) and g.shape == (2, 4, 3)
    torch.testing.assert_close(vc, v, rtol=1e-12, atol=0)
    torch.testing.assert_close(gc, g, rtol=1e-12, atol=1e-12 * g.abs().max().item())


def test_layered_study_chunks_change_nothing(small_layered):
    """minimize_lbfgs_batched_host with eval_chunk (bench.py's v5e chunking,
    dropped by the port's bench) equals the unchunked solve: 4 starts in
    chunks of 3 (one padded), 3 iterations, the same end points within
    1e-10 relative and the same iteration counts."""
    loc, cfg, prob, forward, _ = small_layered
    fobj = lambda ms: ti.loc_cmt_misfit(ms, prob, E.LOC_ONLY, cfg, forward=forward)
    starts = loc + torch.tensor([[2.0, -1.0, 1.5], [-3.0, 2.0, -1.0], [1.0, 3.0, 2.0],
                                 [-2.0, -2.0, 1.0]], dtype=F64)
    kw = dict(max_iter=3, tol=1e-4, ls_max=8)
    res = ti.minimize_lbfgs_batched_host(fobj, starts, **kw)
    resc = ti.minimize_lbfgs_batched_host(fobj, starts, eval_chunk=3, **kw)
    torch.testing.assert_close(resc.x, res.x, rtol=1e-10, atol=0)
    torch.testing.assert_close(resc.fun, res.fun, rtol=1e-10, atol=0)
    assert torch.equal(resc.n_iter, res.n_iter) and int(res.n_iter.max()) > 0


def test_no_card_raises_and_cpu_runs(monkeypatch):
    """Without a card the bench raises, naming --device cpu (run_stage and
    main); with device "cpu" the loc64 stage runs (timed calls cut to 1)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        B.run_stage("loc64")
    with pytest.raises(RuntimeError, match="--device cpu"):
        B.main([])
    monkeypatch.setitem(B.CPU_REPEATS, "loc64", 1)
    out = B.run_stage("loc64", device="cpu")
    assert out["per"] > 0 and out["launches"] == 0 and out["launches_per_call"] == 0


@pytest.mark.parametrize("radius", [float("inf"), 0.0])
def test_multistart_bar_raises(monkeypatch, radius):
    """bench_multi_start holds every start to STUDY_RADIUS_KM: at 3 stations
    and 4 starts (2 iterations, for time) it passes with an infinite radius
    and raises AssertionError at 0."""
    real = B.minimize_multi_start
    monkeypatch.setattr(B, "NR_STUDY", 3)
    monkeypatch.setattr(B, "N_STARTS", 4)
    monkeypatch.setattr(B, "STUDY_RADIUS_KM", radius)
    monkeypatch.setattr(B, "minimize_multi_start",
                        lambda f, x, max_iter, tol: real(f, x, max_iter=2, tol=tol))
    if radius == 0.0:
        with pytest.raises(AssertionError, match="multi-start did not converge"):
            B.bench_multi_start(1, CPU)
    else:
        per, n_starts, counts = B.bench_multi_start(1, CPU)
        assert n_starts == 4 and counts["evaluations"] > 0
        assert counts["launches_per_evaluation"] == 0
