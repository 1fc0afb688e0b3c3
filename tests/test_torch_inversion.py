"""The port's inversion layer against the JAX package (CPU, float64): batched
loc/CMT evaluation, the misfit-surface scan, the batched L-BFGS solvers, the
scipy bridge and the small modules. Problems are built in JAX at 3 stations
on a 15x21 grid and carried over by ``waveform_ot_torch.convert``; each test
states its tolerance.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from waveform_ot_torch import convert
from waveform_ot_torch import inversion as ti
from waveform_ot_torch import models as tm
from waveform_ot_torch.ops import cuda_distance
from waveform_ot_tpu import inversion as ji
from waveform_ot_tpu import models as jm
from waveform_ot_tpu.inversion import lbfgs as jlbfgs

NR = 3
LOC = np.array([2.0, -1.5, 12.0])
OPTS = {"OT_Wavg": dict(), "L2": dict(mistype="L2"), "cmt": dict(cmt=True)}


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    """On the CPU the port takes the plain versions: no kernel launches."""
    before = cuda_distance.LAUNCHES
    yield
    assert cuda_distance.LAUNCHES == before


@pytest.fixture(scope="module")
def problem():
    """The bench's loc/CMT problem at NR stations on a 15x21 grid, built by
    JAX, and the port's copy: (JAX cfg, JAX problem, port cfg, port problem)."""
    ang = np.linspace(0, 2 * np.pi, NR, endpoint=False)
    stations = jm.StationSet(x=jnp.asarray(60.0 * np.cos(ang)),
                             y=jnp.asarray(60.0 * np.sin(ang)))
    mxyz = jm.moment_tensor_from_sdr(30.0, 60.0, 45.0, m0=5.0e6)
    t, s = jm.synthetic_seismograms(*LOC, mxyz, stations, nt=61, dt=1.0)
    rng = np.random.default_rng(0)
    obs = s + 0.002 * float(jnp.max(jnp.abs(s))) * rng.standard_normal(s.shape)
    cfg = ji.TraceConfig(nu=15, ntg=21, lambdav=0.04, q=None, p=2)
    prob = jax.jit(lambda tt, oo: ji.build_loc_cmt_problem(tt, oo, stations, cfg,
                                                           mxyz_fixed=mxyz, impl="jnp"))(t, obs)
    tcfg = ti.TraceConfig(nu=15, ntg=21, lambdav=0.04, q=None, p=2)
    return cfg, prob, tcfg, convert.loc_cmt_problem(prob, device="cpu")


def _models(prob, opts: dict, k: int = 3, seed: int = 3) -> np.ndarray:
    """k models near the source: locations, and the moment tensor with 10%
    noise when ``opts`` inverts for it."""
    rng = np.random.default_rng(seed)
    ms = LOC + rng.uniform(-6.0, 6.0, (k, 3))
    if opts.get("cmt"):
        upper = np.asarray(prob.mxyz_fixed)[np.triu_indices(3)]
        ms = np.concatenate([ms, upper * (1 + 0.1 * rng.standard_normal((k, 6)))], 1)
    return ms


def _assert_value_grad(v, g, ref_v, ref_g):
    """Per lane: value rtol 1e-10; gradient within 1e-8 of the lane's max |g|."""
    np.testing.assert_allclose(np.asarray(v), ref_v, rtol=1e-10)
    for gl, rl in zip(np.asarray(g), np.asarray(ref_g)):
        np.testing.assert_allclose(gl, rl, rtol=0, atol=1e-8 * np.abs(rl).max())


@pytest.mark.parametrize("name", list(OPTS))
def test_batched_loc_cmt_matches_jax_vmap(problem, name):
    """k = 3 models through one batched call against jax.vmap of the
    per-model value_and_grad."""
    cfg, prob, tcfg, tprob = problem
    ms = _models(prob, OPTS[name])
    jo = ji.InvOptions(**OPTS[name])
    ref_v, ref_g = jax.jit(jax.vmap(
        lambda m: ji.loc_cmt_value_and_grad(m, prob, jo, cfg, impl="jnp")))(jnp.asarray(ms))
    v, g = ti.loc_cmt_value_and_grad(torch.tensor(ms), tprob, ti.InvOptions(**OPTS[name]),
                                     tcfg)
    assert v.shape == (3,) and g.shape == ms.shape
    _assert_value_grad(v, g, np.asarray(ref_v), np.asarray(ref_g))


@pytest.mark.parametrize("name", list(OPTS))
def test_batched_equals_single_calls(problem, name):
    """Lane j of a batched call equals model j evaluated alone, rtol 1e-12,
    and the module's forward takes the batch too."""
    cfg, prob, tcfg, tprob = problem
    ms = torch.tensor(_models(prob, OPTS[name], k=4, seed=7))
    opts = ti.InvOptions(**OPTS[name])
    v, g = ti.loc_cmt_value_and_grad(ms, tprob, opts, tcfg)
    for j in range(ms.shape[0]):
        v1, g1 = ti.loc_cmt_value_and_grad(ms[j], tprob, opts, tcfg)
        assert v1.dim() == 0
        np.testing.assert_allclose(v[j].item(), v1.item(), rtol=1e-12)
        np.testing.assert_allclose(g[j].numpy(), g1.numpy(), rtol=0,
                                   atol=1e-12 * g1.abs().max().item())
    obj = ti.LocCMTObjective(tprob, opts, tcfg)
    np.testing.assert_allclose(obj(ms).numpy(), v.numpy(), rtol=1e-12)


def test_misfit_grid_matches_jax(problem):
    """The scan on a (z, x, y) grid of 2x2x2 nodes, rtol 1e-10."""
    cfg, prob, tcfg, tprob = problem
    z, x, y = np.meshgrid([6.0, 14.0], [-4.0, 5.0], [-3.0, 8.0], indexing="ij")
    ms = np.stack([x.ravel(), y.ravel(), z.ravel()], 1)
    ref = jax.jit(lambda mm: ji.misfit_grid(mm, prob, ji.InvOptions(), cfg, impl="jnp"))(
        jnp.asarray(ms))
    got = ti.misfit_grid(torch.tensor(ms), tprob, ti.InvOptions(), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10)


def test_batched_seismograms_and_moment_tensor_ls(problem):
    """Sources (k,) give (k, nr, 3, nt) equal to k single calls (1e-14 of
    the peak); moment_tensor_ls matches JAX and recovers the tensor from
    noiseless data at rtol 1e-8; upper_from_mxyz inverts mxyz_from_upper."""
    _, prob, _, tprob = problem
    rng = np.random.default_rng(4)
    xyz = LOC + rng.uniform(-5, 5, (3, 3))
    mx = tm.mxyz_from_upper(torch.tensor(rng.standard_normal((3, 6))))
    assert torch.equal(tm.upper_from_mxyz(mx), mx[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]])
    for m_src in (mx, tprob.mxyz_fixed):
        _, u = tm.synthetic_seismograms(*torch.tensor(xyz).T, m_src, tprob.stations)
        assert u.shape == (3, NR, 3, 61)
        for j in range(3):
            _, u1 = tm.synthetic_seismograms(*torch.tensor(xyz[j]),
                                             m_src[j] if m_src.dim() == 3 else m_src,
                                             tprob.stations)
            np.testing.assert_allclose(u[j].numpy(), u1.numpy(), rtol=0,
                                       atol=1e-14 * u1.abs().max().item())
    _, s = jm.synthetic_seismograms(*LOC, prob.mxyz_fixed, prob.stations, nt=61, dt=1.0)
    ref = jax.jit(lambda xyz, ss: jm.moment_tensor_ls(xyz, prob.stations, ss, nt=61, dt=1.0))(
        jnp.asarray(LOC), s)
    got = tm.moment_tensor_ls(torch.tensor(LOC), tprob.stations, torch.tensor(np.asarray(s)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-8)
    np.testing.assert_allclose(got.numpy(), tm.upper_from_mxyz(tprob.mxyz_fixed).numpy(),
                               rtol=1e-8)


# ---------------------------------------------------------------------------
# the solvers, on the same functions written in torch and in jnp
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(0)
QUAD_C = RNG.uniform(0.5, 3.0, 5)
QUAD_T = RNG.uniform(-1.0, 1.0, 5)
X0 = RNG.uniform(-2, 2, (8, 5))


def _quad_j(x):
    return jnp.sum(QUAD_C * (x - QUAD_T) ** 2)


def _quad_t(xs):
    return (torch.tensor(QUAD_C) * (xs - torch.tensor(QUAD_T)) ** 2).sum(-1)


def _rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def _rosen_t(xs):
    return (100.0 * (xs[:, 1:] - xs[:, :-1] ** 2) ** 2 + (1 - xs[:, :-1]) ** 2).sum(-1)


def _nan_j(x):
    # a bowl, NaN for x[0] > 2: the lane starting there can never accept
    return jnp.where(x[0] > 2.0, jnp.nan, jnp.sum((x - 1.0) ** 2))


def _nan_t(xs):
    return torch.where(xs[:, 0] > 2.0, torch.nan, ((xs - 1.0) ** 2).sum(-1))


SOLVERS = {
    "batched": (jlbfgs.minimize_lbfgs_batched, ti.minimize_lbfgs_batched),
    "host": (jlbfgs.minimize_lbfgs_batched_host, ti.minimize_lbfgs_batched_host),
    "zoom": (functools.partial(jlbfgs.minimize_multi_start, method="zoom"),
             functools.partial(ti.minimize_multi_start, method="zoom")),
}


def _solve_both(solver: str, fj, ft, x0, **kw):
    """JAX's solver (jitted, but for the host form) and the port's on the
    same starts; JAX's result as NumPy."""
    jsolve, tsolve = SOLVERS[solver]
    if solver == "host":
        ref = jsolve(fj, jnp.asarray(x0), **kw)
    else:
        ref = jax.jit(lambda xs: jsolve(fj, xs, **kw))(jnp.asarray(x0))
    return jax.tree_util.tree_map(np.asarray, ref), tsolve(ft, torch.tensor(x0), **kw)


def _assert_same_flags(got, ref):
    """ls_failed as JAX's: equal, or None in both (the zoom's)."""
    if ref.ls_failed is None:
        assert got.ls_failed is None
    else:
        np.testing.assert_array_equal(got.ls_failed.numpy(), ref.ls_failed)


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_solver_quadratic_matches_jax(solver):
    """Convex quadratic, 8 lanes: x within 1e-10 of JAX's solver and of the
    minimizer; the host form with eval_chunk=3 equals it unchunked (1e-12)."""
    ref, got = _solve_both(solver, _quad_j, _quad_t, X0, max_iter=100, tol=1e-10)
    np.testing.assert_allclose(got.x.numpy(), ref.x, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.x.numpy(), np.broadcast_to(QUAD_T, X0.shape), atol=1e-8)
    np.testing.assert_array_equal(got.n_iter.numpy(), ref.n_iter)
    if solver == "host":
        chunked = ti.minimize_lbfgs_batched_host(_quad_t, torch.tensor(X0), max_iter=100,
                                                 tol=1e-10, eval_chunk=3)
        np.testing.assert_allclose(chunked.x.numpy(), got.x.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_solver_rosenbrock_matches_jax(solver):
    """Rosenbrock in 4 dimensions, 8 lanes: per lane the same x (1e-8), the
    same iteration count and the same ls_failed flag as JAX's solver. The
    tolerance 1e-6 ends every lane above the noise floor of the gradient,
    where an Armijo test decided by rounding could freeze one side only."""
    ref, got = _solve_both(solver, _rosen_j, _rosen_t, X0[:, :4], max_iter=400, tol=1e-6)
    np.testing.assert_allclose(got.x.numpy(), ref.x, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got.n_iter.numpy(), ref.n_iter)
    _assert_same_flags(got, ref)


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_solver_flags_nan_lane_like_jax(solver):
    """A lane starting where the objective is NaN stays at its start; the
    healthy lane converges; ls_failed equals JAX's: the batched solvers fail
    the NaN lane, the zoom (whose search fails and takes the zero safe step)
    leaves ls_failed None and stops that lane after one iteration, as JAX's
    vmapped zoom does."""
    x0 = np.array([[0.0, 0.0], [5.0, 0.0]])
    ref, got = _solve_both(solver, _nan_j, _nan_t, x0, max_iter=50, tol=1e-8)
    _assert_same_flags(got, ref)
    if solver == "zoom":
        np.testing.assert_array_equal(got.n_iter.numpy(), ref.n_iter)
        assert got.n_iter[1] == 1 and np.isnan(got.fun[1].item())
    else:
        assert got.ls_failed.tolist() == [False, True]
    np.testing.assert_allclose(got.x[0].numpy(), [1.0, 1.0], atol=1e-6)
    np.testing.assert_array_equal(got.x[1].numpy(), x0[1])


def test_minimize_lbfgs_single_start_matches_jax():
    """minimize_lbfgs from one start of the quadratic (the port's batched
    objective called with k = 1) against JAX's: the same iterations, x within
    1e-10, and fields without a lane axis."""
    ref = jax.jit(lambda x: jlbfgs.minimize_lbfgs(_quad_j, x, max_iter=100, tol=1e-10))(
        jnp.asarray(X0[3]))
    got = ti.minimize_lbfgs(_quad_t, torch.tensor(X0[3]), max_iter=100, tol=1e-10)
    assert got.x.shape == (5,) and got.fun.dim() == 0 and got.ls_failed is None
    assert int(got.n_iter) == int(ref.n_iter)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.grad_norm.item(), float(ref.grad_norm), rtol=1e-6,
                               atol=1e-14)


@pytest.mark.parametrize("solver", ["multi_start", "host", "zoom"])
def test_loc_l2_multistart_matches_jax_host(problem, solver):
    """Three starts of the loc L2 inversion, the port's batched objective
    through each port solver against JAX's host solver (the zoom against
    JAX's vmapped zoom): x within 1e-6, the same iteration counts, every lane
    at the source (0.5 km)."""
    cfg, prob, tcfg, tprob = problem
    starts = LOC + np.array([[5.0, 4.0, -3.0], [-6.0, 2.0, 5.0], [3.0, -8.0, 2.0]])
    l2 = ji.InvOptions(mistype="L2")
    jfun = lambda m: ji.loc_cmt_misfit(m, prob, l2, cfg)
    if solver == "zoom":
        ref = jax.jit(lambda xs: jlbfgs.minimize_multi_start(jfun, xs, max_iter=60,
                                                             method="zoom"))(jnp.asarray(starts))
    else:
        ref = jlbfgs.minimize_lbfgs_batched_host(jfun, jnp.asarray(starts), max_iter=60)
    tfun = lambda ms: ti.loc_cmt_misfit(ms, tprob, ti.InvOptions(mistype="L2"), tcfg)
    tsolve = {"multi_start": ti.minimize_multi_start,
              "host": ti.minimize_lbfgs_batched_host,
              "zoom": SOLVERS["zoom"][1]}[solver]
    got = tsolve(tfun, torch.tensor(starts), max_iter=60)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(ref.n_iter))
    assert np.linalg.norm(got.x.numpy() - LOC, axis=1).max() < 0.5


def test_minimize_scipy_and_trace_match_jax(problem):
    """scipy L-BFGS-B on the loc L2 objective: the port's minimize_scipy
    ends within 1e-6 of JAX's; InversionTrace records the same models,
    misfits and iterates (1e-8), and misfit_per_iterate agrees."""
    cfg, prob, tcfg, tprob = problem
    m0 = LOC + np.array([8.0, -6.0, 4.0])
    l2 = ji.InvOptions(mistype="L2")
    jtrace, ttrace = ji.InversionTrace(), ti.InversionTrace()
    ref = ji.minimize_scipy(
        jtrace.wrap_objective(lambda m: ji.loc_cmt_value_and_grad(m, prob, l2, cfg)),
        m0, jit_objective=False, callback=jtrace.scipy_callback())
    got = ti.minimize_scipy(
        ttrace.wrap_objective(lambda m: ti.loc_cmt_value_and_grad(
            m, tprob, ti.InvOptions(mistype="L2"), tcfg)),
        torch.tensor(m0), callback=ttrace.scipy_callback())
    np.testing.assert_allclose(got.x, ref.x, rtol=0, atol=1e-6)
    assert got.nit == ref.nit and len(ttrace.models) == len(jtrace.models)
    for name in ("models", "grads", "iterates"):
        np.testing.assert_allclose(np.stack(getattr(ttrace, name)),
                                   np.stack(getattr(jtrace, name)), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(ttrace.misfits, jtrace.misfits, rtol=1e-8)
    np.testing.assert_allclose(ttrace.misfit_per_iterate(), jtrace.misfit_per_iterate(),
                               rtol=1e-8)
    assert len(ttrace.misfit_per_iterate()) == got.nit


def test_analysis_matches_jax():
    """check_convergence and solution_report on tensors equal JAX's on arrays."""
    rng = np.random.default_rng(2)
    starts = rng.uniform(-80, 80, (6, 9))
    starts[1, 0] = 80.0
    finals = np.concatenate([LOC + rng.normal(0, 0.8, (6, 3)), rng.normal(1, 0.1, (6, 6))], 1)
    truth = np.concatenate([LOC, np.ones(6)])
    for a, b in zip(ti.check_convergence(torch.tensor(starts), torch.tensor(finals),
                                         torch.tensor(truth)),
                    ji.check_convergence(starts, finals, truth)):
        np.testing.assert_array_equal(a, b)
    got = ti.solution_report(torch.tensor(finals[0]), truth, torch.tensor(2.0), 0.5, 0.1)
    ref = ji.solution_report(finals[0], truth, 2.0, 0.5, 0.1)
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])


def test_ls_misfit_and_window_union_match_jax():
    """Two waveforms on overlapping windows, zero outside each support:
    rtol 1e-12 against JAX, with the default and a given nt."""
    tref = np.linspace(-1.0, 3.0, 81)
    t = np.linspace(0.5, 5.2, 95)
    wref, w = np.sin(2 * tref), np.cos(3 * t) * np.exp(-0.1 * t)
    for nt in (None, 137):
        ref = ji.window_union(jnp.asarray(tref), jnp.asarray(wref), jnp.asarray(t),
                              jnp.asarray(w), nt=nt)
        got = ti.window_union(*(torch.tensor(a) for a in (tref, wref, t, w)), nt=nt)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-15)
        assert (got[0][got[2] < t[0]] == 0).all() and (got[1][got[2] > tref[-1]] == 0).all()
        np.testing.assert_allclose(
            ti.ls_misfit(*(torch.tensor(a) for a in (tref, wref, t, w)), nt=nt).item(),
            float(ji.ls_misfit(jnp.asarray(tref), jnp.asarray(wref), jnp.asarray(t),
                               jnp.asarray(w), nt=nt)), rtol=1e-12)


# ---------------------------------------------------------------------------
# the reference-chain Ricker wrappers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ricker(golden):
    """The golden Ricker problem, JAX's and the port's."""
    gd = golden["ricker_full"]
    win, spec = ji.grid6_to_window(gd["grid"])
    cfg = ji.TraceConfig(nu=spec.nu, ntg=spec.ntg, lambdav=gd["lambdav"], q=None, p=2,
                         transform=True)
    targets = jax.jit(lambda tt, ww: ji.build_target(tt, ww, win, cfg, impl="jnp"))(
        jnp.array(gd["tobs"]), jnp.array(gd["wobs"]))
    prob, cfg = ji.make_ricker_problem(targets, gd["grid"], trange=(-2.0, 7.0), alpha=0.5,
                                       lambdav=gd["lambdav"])
    tprob, tcfg = chip_smoke.build_ricker_problem(golden, torch.float64,
                                                  torch.device("cpu"))
    return gd, prob, cfg, tprob, tcfg


def test_build_fingerprint_matches_jax(ricker):
    """build_fingerprint (transform, then the fingerprint density) of the
    golden observed waveform on the problem's window at 80x512: the density
    and its two grid axes within 1e-12 of JAX's, relative to their largest
    entry."""
    gd, prob, cfg, tprob, tcfg = ricker
    tw = lambda k: torch.tensor(gd[k], dtype=torch.float64)
    pdf, (tg, ug) = ti.build_fingerprint(tw("tobs"), tw("wobs")[None], tprob.window, tcfg)
    jpdf, (jtg, jug) = jax.jit(lambda tt, ww: ji.build_fingerprint(
        tt, ww, prob.window, cfg, impl="jnp"))(jnp.array(gd["tobs"]), jnp.array(gd["wobs"]))
    assert pdf.shape == (1, *jpdf.shape) == (1, cfg.spec.nu, cfg.spec.ntg)
    for got, ref in ((pdf[0], jpdf), (tg.reshape(-1), jtg), (ug.reshape(-1), jug)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def test_calc_wasser_waveform_matches_golden_and_jax(golden, ricker):
    """Marginal W, their waveform derivatives and dg on the golden predicted
    waveform: within 1e-8 of the golden values (the JAX package's bars) and
    of JAX's calc_wasser_waveform; the deriv=False forms agree."""
    gd, prob, cfg, tprob, tcfg = ricker
    ref = golden["ricker"]
    tw = lambda k: torch.tensor(gd[k], dtype=torch.float64)
    un, win01 = ti.apply_transform(tw("wpred")[None], tprob.window, tcfg)
    cfg_fp = dataclasses.replace(tcfg, transform=False)
    (wt, wu), (drt, dru), (dgt, dgu) = ti.calc_wasser_waveform(
        tw("tpred"), un, win01, tprob.targets, cfg_fp, deriv=True)
    for got, want in ((wt, ref["Wt"]), (wu, ref["Wu"]), (dgt, ref["dgt"])):
        assert abs(got.item() - want) <= 1e-8
    assert dgu.item() == 0.0
    np.testing.assert_allclose(drt[0].numpy(), ref["drt"], atol=1e-8)
    np.testing.assert_allclose(dru[0].numpy(), ref["dru"], atol=1e-8)
    jun, jwin01 = ji.apply_transform(jnp.array(gd["wpred"]), prob.window, cfg)
    jref = jax.jit(lambda tt, uu: ji.calc_wasser_waveform(
        tt, uu, jwin01, prob.targets, dataclasses.replace(cfg, transform=False), deriv=True,
        returnmarg=False, impl="jnp"))(jnp.array(gd["tpred"]), jun)
    got = ti.calc_wasser_waveform(tw("tpred"), un, win01, tprob.targets, cfg_fp,
                                  deriv=True, returnmarg=False)
    for a, b in zip(got, jref):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=0, atol=1e-8)
    wavg = ti.calc_wasser_waveform(tw("tpred"), un, win01, tprob.targets, cfg_fp,
                                   returnmarg=False)
    np.testing.assert_allclose(wavg.numpy(), got[0].numpy(), rtol=1e-14)
    assert ti.dg_scale(tprob.window, tcfg).item() == float(ji.dg_scale(prob.window, cfg))


def test_ricker_objective_matches_golden_and_jax(golden, ricker):
    """The reference's explicit gradient assembly: w2 and deriv within 1e-8
    of the golden values and of JAX's ricker_objective; the wavelet's
    analytic jacobian within 1e-12 of JAX's and 1e-10 of the golden one."""
    gd, prob, cfg, tprob, tcfg = ricker
    m = np.array([0.5, 1.2, 1.1])
    w2, deriv = ti.ricker_objective(torch.tensor(m), tprob, tcfg)
    ref = golden["ricker_obj"]
    assert abs(w2.item() - ref["w2"]) <= 1e-8
    np.testing.assert_allclose(deriv.numpy(), ref["deriv"], atol=1e-8)
    jw2, jderiv = jax.jit(lambda mm: ji.ricker_objective(mm, prob, cfg, impl="jnp"))(
        jnp.asarray(m))
    assert abs(w2.item() - float(jw2)) <= 1e-8
    np.testing.assert_allclose(deriv.numpy(), np.asarray(jderiv), atol=1e-8)
    t, w, dudm = tm.ricker_wavelet_with_jacobian(*torch.tensor(m), trange=(-2.0, 7.0))
    jt, jw, jdudm = jm.ricker_wavelet_with_jacobian(*m, trange=(-2.0, 7.0))
    for a, b in ((t, jt), (w, jw), (dudm, jdudm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12 * np.abs(np.asarray(b)).max())
    np.testing.assert_allclose(dudm.numpy(), gd["dwm"], atol=1e-10)


def test_ricker_batched_and_grid_helpers(ricker):
    """The Ricker objective on 3 models at once equals 3 single calls
    (rtol 1e-12); auto_grid6 and default_grid_dims equal JAX's."""
    gd, prob, cfg, tprob, tcfg = ricker
    ms = torch.tensor([[0.5, 1.2, 1.1], [0.0, 1.6, 1.0], [0.7, 1.1, 1.3]], dtype=torch.float64)
    v, g = ti.ricker_value_and_grad(ms, tprob, tcfg)
    for j in range(3):
        v1, g1 = ti.ricker_value_and_grad(ms[j], tprob, tcfg)
        np.testing.assert_allclose(v[j].item(), v1.item(), rtol=1e-12)
        np.testing.assert_allclose(g[j].numpy(), g1.numpy(), rtol=1e-12, atol=1e-15)
    t, w = np.asarray(gd["tobs"]), np.asarray(gd["wobs"])
    assert ti.auto_grid6(torch.tensor(t), torch.tensor(w)) == ji.auto_grid6(t, w)
    assert ti.default_grid_dims(61) == ji.default_grid_dims(61)


@pytest.mark.parametrize("kw", [dict(u0=-3.0, u1=3.0), dict(tantheta=2.0),
                                dict(u0=np.linspace(-2.0, -1.0, 6).reshape(2, 3), u1=2.5,
                                     tantheta=0.5)],
                         ids=["fixed", "tantheta", "array_limits"])
def test_build_windows_fixed_limits_and_tantheta_match_jax(kw):
    """build_windows with fixed u0/u1 (scalars or per-trace arrays)
    broadcast over the (2, 3) batch, and with a tantheta other than 1:
    every field equal to the JAX package's, in shape, dtype and value."""
    rng = np.random.default_rng(11)
    t, wave = np.linspace(0.0, 15.0, 16), rng.normal(size=(2, 3, 16))
    want = ji.build_windows(jnp.asarray(t), jnp.asarray(wave), **kw)
    got = ti.build_windows(torch.tensor(t), torch.tensor(wave), **kw)
    for name in got._fields:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == torch.float64 and tuple(a.shape) == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("tant_in_dg", [True, False], ids=["ricker", "loc_cmt"])
def test_calc_wasser_waveform_origin_time_conventions_match_jax(tant_in_dg):
    """calc_wasser_waveform on a window with tantheta 2 under both origin-time
    conventions (TraceConfig.include_tant_in_dg: 1/(tantheta (t1 - t0)) for
    the Ricker driver, 1/(t1 - t0) for the loc/CMT one): both return forms
    within 1e-10 of the JAX package's, and dg_scale equal to JAX's."""
    t = np.linspace(0.0, 10.0, 41)
    wo, wp = np.sin(0.9 * t) * np.exp(-0.1 * t), np.sin(0.9 * t - 0.4) * np.exp(-0.1 * t)
    from waveform_ot_torch.ops import make_window as tmake_window
    from waveform_ot_tpu.ops import make_window as jmake_window

    cfg = ji.TraceConfig(nu=15, ntg=21, include_tant_in_dg=tant_in_dg)
    tcfg = ti.TraceConfig(nu=15, ntg=21, include_tant_in_dg=tant_in_dg)
    jwin = jmake_window(0.0, 10.0, -1.5, 1.5, tantheta=2.0)
    twin = tmake_window(0.0, 10.0, -1.5, 1.5, tantheta=2.0, device="cpu")
    jt = ji.build_target(jnp.asarray(t), jnp.asarray(wo), jwin, cfg, impl="jnp")
    tt = convert.targets(jt, device="cpu")
    assert ti.dg_scale(twin, tcfg).item() == float(ji.dg_scale(jwin, cfg))
    (wt, wu), (drt, dru), (dgt, dgu) = jax.jit(lambda tj, wj: ji.calc_wasser_waveform(
        tj, wj, jwin, jt, cfg, deriv=True, impl="jnp"))(jnp.asarray(t), jnp.asarray(wp))
    # returnmarg=False is JAX's average of the two marginals (pipeline.py:165)
    wants = {True: [wt, wu, drt, dru, dgt, dgu],
             False: [(wt + wu) / 2.0, (drt + dru) / 2.0, dgt / 2.0]}
    for marg, want in wants.items():
        got = ti.calc_wasser_waveform(torch.tensor(t), torch.tensor(wp)[None], twin, tt, tcfg,
                                      deriv=True, returnmarg=marg)
        for a, b in zip(jax.tree_util.tree_leaves(got), want):
            np.testing.assert_allclose(a.numpy().reshape(np.shape(b)), np.asarray(b),
                                       rtol=0, atol=1e-10)
