"""The port's example scripts (examples/torch_*.py) against the JAX package
(CPU, float64).

Each script's ``run`` (or its inner functions, at a smaller grid than the
script's own) runs on the CPU, its own assertions hold, and its key numbers
are held against the JAX package's functions on the same seeded inputs:
objective values within 1e-10 relative and gradients within 1e-10 of max |g|
at the script's start point, scipy iteration counts equal and end points
within 1e-6 where an inversion runs, the point masses' values and plan, the
receiver function's field statistics and the central-difference errors of
the derivative walkthrough (below 1e-6 on both sides). Where a JAX function
reaches the Pallas kernel it runs a CPU implementation: "jnp", or "xla" for
the loc/CMT objectives (half the CPU time of "jnp" there). The JAX
scripts themselves are not imported: they change JAX's global
configuration.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import example
from waveform_ot_torch.inversion import loc_cmt_misfit, loc_cmt_value_and_grad
from waveform_ot_torch.ops import cuda_distance
from waveform_ot_tpu import compat as jc
from waveform_ot_tpu import inversion as ji
from waveform_ot_tpu import models as jm
from waveform_ot_tpu import ops as jo
from waveform_ot_tpu.inversion.pipeline import grid6_to_window, trace_misfit
from waveform_ot_tpu.ops import fmm as jfmm

CPU = "cpu"
RTOL = 1e-10                           # values; gradients: of max |g|
X_TOL = 1e-6                           # scipy end points
RICKER_GRID = (-2.0, 7.0, -2.0, 2.6, 40, 128)   # the Ricker scripts' 80x512, cut
SMALL_GRID = (-2.0, 7.0, -2.0, 2.6, 20, 64)
TRANGE = (-2.0, 7.0)


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    """On the CPU the port takes the plain versions: no kernel launches."""
    before = cuda_distance.LAUNCHES
    yield
    assert cuda_distance.LAUNCHES == before


def assert_vg(v, g, ref_v, ref_g):
    """Values rtol RTOL; gradients within RTOL of each row's max |g|."""
    np.testing.assert_allclose(np.asarray(v), np.asarray(ref_v), rtol=RTOL)
    g, ref_g = np.atleast_2d(np.asarray(g)), np.atleast_2d(np.asarray(ref_g))
    for gl, rl in zip(g, ref_g):
        np.testing.assert_allclose(gl, rl, rtol=0, atol=RTOL * np.abs(rl).max())


def jax_ricker(grid6, seed: int, noise: float):
    """The Ricker scripts' problem in JAX: (tobs, wobs, prob, cfg)."""
    tobs, wobs = jm.ricker_wavelet(0.0, 1.6, 1.0, trange=TRANGE)
    rng = np.random.default_rng(seed)
    wobs = wobs + noise * float(jnp.max(jnp.abs(wobs))) * jnp.asarray(
        rng.standard_normal(wobs.shape))
    win, spec = grid6_to_window(grid6)
    cfg = ji.TraceConfig(nu=spec.nu, ntg=spec.ntg, lambdav=0.03, q=None, p=2, transform=True)
    targets = jax.jit(lambda tt, ww: ji.build_target(tt, ww, win, cfg, impl="jnp"))(tobs, wobs)
    prob, _ = ji.make_ricker_problem(targets, grid6, trange=TRANGE, alpha=0.5, lambdav=0.03)
    return tobs, wobs, prob, cfg


# ---------------------------------------------------------------------------
# 1-2. the point masses and the reference-migration self-test
# ---------------------------------------------------------------------------


def test_point_mass_demo_matches_jax():
    """Fig 5's W1 = 4.11 and W2^2 = 18.09, the oracles, the plan and the
    barycentric path against the JAX package."""
    mod = example("point_mass_demo")
    r = mod.run(CPU)
    f, fx, g, gx = (jnp.asarray(a) for a in (mod.F, mod.FX, mod.G, mod.GX))
    for p, key in ((1, "w1"), (2, "w2")):
        np.testing.assert_allclose(r[key], float(jo.wasserstein_1d(f, fx, g, gx, p)), rtol=RTOL)
    np.testing.assert_allclose([r["w1"], r["w2"]], [4.11, 18.09], rtol=1e-12)
    np.testing.assert_allclose(r["plan"], np.asarray(jo.transport_plan_1d(f, fx, g, gx)),
                               rtol=0, atol=1e-15)
    pos, mass = jo.barycenter.barycenter_pointmass(jo.make_density_1d(f, fx),
                                                   jo.make_density_1d(g, gx),
                                                   jnp.linspace(0, 1, 5))
    np.testing.assert_allclose(r["path_pos"], np.asarray(pos), rtol=RTOL)
    np.testing.assert_allclose(r["path_mass"], np.asarray(mass), rtol=RTOL)
    assert r["plan_rows_ok"]
    assert abs(r["w2_linprog"] - r["w2"]) < 1e-8
    assert abs(r["w1_numint"] - r["w1"]) < 1e-3 and abs(r["w2_numint"] - r["w2"]) < 1e-2


def test_reference_migration_matches_jax():
    """The script's asserted self-test on the CPU, and its W1, W2 and plan
    against the JAX package's compat (the fingerprint pass's calcpdf and
    MargWasserstein are held against JAX by tests/test_torch_compat.py)."""
    r = example("reference_migration").run(CPU)
    rng = np.random.default_rng(61254557)
    f, g = rng.random(10), rng.random(10)
    x = np.linspace(0.0, 1.0, 10)
    src, tgt = jc.OTpdf((f, x)), jc.OTpdf((g, x))
    np.testing.assert_allclose([r["w1"], r["w2"]], jc.wasser(src, tgt, "W12"), rtol=RTOL)
    np.testing.assert_allclose(r["plan"], jc.wasser(src, tgt, "W2", returnplan=True)[-1],
                               rtol=0, atol=1e-15)
    assert r["dw_shape"] == (40, 120) and min(r["marg_w"]) > 0 and r["sliced"] > 0


# ---------------------------------------------------------------------------
# 3-5. the Ricker scripts: inversion, misfit surfaces, derivative walkthrough
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ricker_pair():
    """The Ricker inversion's problem at RICKER_GRID on both sides."""
    mod = example("ricker_inversion")
    return mod, mod.build_problem(CPU, grid6=RICKER_GRID), jax_ricker(RICKER_GRID, 42, 0.005)


def test_ricker_inversion_scipy_matches_jax(ricker_pair):
    """The objective at m0 within 1e-10; scipy L-BFGS-B as the script runs
    it (InversionTrace) in as many iterations as JAX's minimize_scipy,
    within 1e-6 of its end point, and within 0.05 of the truth."""
    mod, (prob, cfg, m0), (_, _, jprob, jcfg) = ricker_pair
    vg = jax.jit(lambda m: ji.ricker_value_and_grad(m, jprob, jcfg, impl="jnp"))
    assert_vg(*mod.ricker_value_and_grad(m0, prob, cfg), *vg(jnp.asarray(mod.M0)))
    r = mod.invert(prob, cfg, m0)
    ref = ji.minimize_scipy(vg, jnp.asarray(mod.M0), jit_objective=False)
    assert r["nit"] == ref.nit and r["evaluations"] == ref.nfev == len(r["misfits"])
    np.testing.assert_allclose(r["x"], ref.x, rtol=0, atol=X_TOL)
    assert np.abs(r["x"] - np.asarray(mod.MTRUE)).max() < 0.05


def test_ricker_inversion_zoom(ricker_pair):
    """--zoom: minimize_lbfgs (20 of the script's 100 iterations here) ends
    within 0.05 of the truth, one value+grad call per zoom trial."""
    mod, (prob, cfg, m0), _ = ricker_pair
    r = mod.invert(prob, cfg, m0, zoom=True, max_iter=20)
    assert r["nit"] == 20 and r["evaluations"] > r["nit"]
    assert np.abs(r["x"] - np.asarray(mod.MTRUE)).max() < 0.05


def union_grid_ties(ms, tobs, nt: int) -> np.ndarray:
    """Per model (shift, amp, f): whether an inner node of the L2 misfit's
    union grid falls on an end of either waveform's support. There the
    port's and XLA's linspace part by an ulp, so the node falls inside one
    support and outside the other's zero fill: the two L2 values differ by
    that node's residual (the grids' ulp: ROADMAP Queue 3, platform facts)."""
    out = []
    for s in ms[:, 0]:
        tp = np.linspace(*TRANGE, nt) + s
        ends = np.array([tobs[0], tobs[-1], tp[0], tp[-1]])
        grid = np.linspace(min(tobs[0], tp[0]), max(tobs[-1], tp[-1]), nt)[1:-1]
        out.append(np.abs(grid[:, None] - ends[None]).min() < 1e-9)
    return np.array(out)


def test_ricker_misfit_surfaces_match_jax():
    """The 41-point profiles (with the script's assertion on local minima)
    and a 3x3 surface at a 20x64 grid: W1 and W2, one batched call each,
    against JAX's ricker_misfit, and L2 against its ls_misfit wherever the
    union grid has no node on a support's end (union_grid_ties: 4 of the 50
    models here)."""
    mod = example("ricker_misfit_surfaces")
    p = mod.build_problem(CPU, grid6=SMALL_GRID)
    prof = mod.profiles(p, 41)
    surf = mod.surfaces(p, 3)
    tobs, wobs, jprob, jcfg = jax_ricker(SMALL_GRID, 0, 0.01)
    jcfg1 = dataclasses.replace(jcfg, p=1)
    shifts = prof["shifts"]
    ms = np.concatenate([np.stack([shifts, np.full_like(shifts, 1.6), np.ones_like(shifts)], 1),
                         surf["models"]])
    got = {k: np.concatenate([prof["profiles"][k], surf["surfaces"][k]]) for k in ("w1", "w2", "l2")}

    def l2_of(m):
        t, w = jm.ricker_wavelet(m[0], m[1], m[2], trange=TRANGE)
        return ji.l2.ls_misfit(tobs, wobs, t, w, nt=wobs.shape[0])

    batch = lambda fn: np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(ms)))
    np.testing.assert_allclose(got["w1"], batch(lambda m: ji.ricker_misfit(m, jprob, jcfg1,
                                                                           impl="jnp")), rtol=RTOL)
    np.testing.assert_allclose(got["w2"], batch(lambda m: ji.ricker_misfit(m, jprob, jcfg,
                                                                           impl="jnp")), rtol=RTOL)
    ties = union_grid_ties(ms, np.asarray(tobs), wobs.shape[0])
    assert ties.sum() <= len(ms) // 10
    np.testing.assert_allclose(got["l2"][~ties], batch(l2_of)[~ties], rtol=RTOL)
    assert surf["first_s"] > 0 and surf["steady_s"] > 0


def test_derivative_walkthrough_matches_jax():
    """The three stages at a 40x128 grid: every central-difference error
    below 1e-6 on both sides, and the port's autograd derivatives, W2 and
    dW/dm against JAX's."""
    mod = example("derivative_walkthrough")
    r = mod.walkthrough(CPU, grid6=RICKER_GRID)

    def fd(fn, x, idxs, eps=1e-6):
        out = []
        for i in idxs:
            out.append((float(fn(x.at[i].add(eps))) - float(fn(x.at[i].add(-eps)))) / (2 * eps))
        return np.array(out)

    rng = np.random.default_rng(1)
    t = jnp.asarray(np.linspace(-2.0, 2.0, 40))
    w = jnp.asarray(np.sin(3 * np.linspace(-2.0, 2.0, 40)) + 0.05 * rng.standard_normal(40))
    win = jo.make_window(-2.0, 2.0, float(w.min()) - 0.3, float(w.max()) + 0.3)
    spec = jo.FingerprintSpec(nu=24, ntg=40)

    def dsum(w_):
        tg, ug = jo.grid_axes(t, win, spec)
        return jnp.sum(jnp.sin(jo.distance_field_diff(jo.normalize_vertices(t, w_, win), tg, ug,
                                                      "jnp")))

    idx1 = [0, 5, 17, 33]
    g1 = np.asarray(jax.jit(jax.grad(dsum))(w))[idx1]
    jerr1 = np.abs(g1 - fd(jax.jit(dsum), w, idx1))

    tobs, wobs = jm.ricker_wavelet(0.0, 1.6, 1.0, trange=TRANGE)
    wobs = wobs + 0.01 * jnp.max(jnp.abs(wobs)) * jnp.asarray(rng.standard_normal(wobs.shape))
    win2, _ = grid6_to_window(RICKER_GRID)
    cfg = ji.TraceConfig(nu=40, ntg=128, lambdav=0.03, q=None, p=2, transform=True)
    targets = jax.jit(lambda tt, ww: ji.build_target(tt, ww, win2, cfg, impl="jnp"))(tobs, wobs)
    tp, wp = jm.ricker_wavelet(0.4, 1.2, 1.1, trange=TRANGE)

    def wsum(w_):
        wt, wu = trace_misfit(tp, w_, win2, targets, cfg, impl="jnp")
        return 0.5 * (wt + wu)

    idx2 = [90, 128, 180]
    g2 = np.asarray(jax.jit(jax.grad(wsum))(wp))[idx2]
    jerr2 = np.abs(g2 - fd(jax.jit(wsum), wp, idx2))
    prob, _ = ji.make_ricker_problem(targets, RICKER_GRID, trange=TRANGE, alpha=0.5,
                                     lambdav=0.03)
    m = jnp.array([0.4, 1.2, 1.1])
    w2, dm = jax.jit(lambda mm: ji.ricker_value_and_grad(mm, prob, cfg, impl="jnp"))(m)
    jerr3 = np.abs(np.asarray(dm) - fd(jax.jit(lambda mm: ji.ricker_misfit(mm, prob, cfg,
                                                                           impl="jnp")),
                                       m, range(3)))
    for k, jerr, g in (("1", jerr1, g1), ("2", jerr2, g2), ("3", jerr3, dm)):
        assert r[f"err{k}"].max() < 1e-6 and jerr.max() < 1e-6, k
        np.testing.assert_allclose(r[f"grad{k}"], np.asarray(g), rtol=0,
                                   atol=RTOL * np.abs(np.asarray(g)).max(), err_msg=k)
    assert_vg(r["w2"], r["dm"], w2, dm)


# ---------------------------------------------------------------------------
# 6. the receiver-function demo
# ---------------------------------------------------------------------------


def test_receiver_function_demo_small_matches_jax(tmp_path):
    """--small (63 samples, 80x60): the exact field's statistics and the
    FMM-vs-exact band errors against JAX's compat and fmm modules; the four
    figures are written where asked."""
    mod = example("receiver_function_demo")
    r = mod.run(CPU, small=True)
    t = np.linspace(0.0, 1.0, 63)
    rf = 2 * np.sin(t * 6 * np.pi) - 3 * np.cos((2 * t + 0.30) * 2 * np.pi)
    du = rf.max() - rf.min()
    u0, u1 = rf.min() - 0.15 * du, rf.max() + 0.15 * du
    wf = jc.waveformFP(t, rf, (t[0], t[-1], u0, u1, 80, 60))
    wf.calcpdf(lambdav=0.04, method="Enumerate")
    d, pdf = np.asarray(wf.dfield), np.asarray(wf.pdf)
    np.testing.assert_allclose(r["figures"]["d_exact"], d, rtol=0, atol=1e-14)
    np.testing.assert_allclose([r["dmin"], r["dmax"], r["pdfmin"], r["pdfmax"]],
                               [d.min(), d.max(), pdf.min(), pdf.max()], rtol=RTOL, atol=1e-16)
    d_fmm = jfmm.distance_field_fmm((t - t[0]) / (t[-1] - t[0]), (rf - u0) / (u1 - u0),
                                    np.linspace(0, 1, 60), np.linspace(0, 1, 80))
    err = np.abs(d_fmm - d)[d > 2.0 / 80]
    np.testing.assert_allclose([r["band_median"], r["band_max"]], [np.median(err), err.max()],
                               rtol=RTOL)
    mod.draw(r["figures"], tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "rf_dfield.png", "rf_pdf.png", "rf_phi.png", "rf_rays.png"]


# ---------------------------------------------------------------------------
# 7-8. the loc/CMT scripts: the two inversions and the scan; the studies
# ---------------------------------------------------------------------------


def jax_farfield(stations_xy, loc, sdrm, seed: int, noise: float):
    """A far-field loc/CMT problem in JAX as the scripts build it."""
    stations = jm.StationSet(x=jnp.asarray(stations_xy[0]), y=jnp.asarray(stations_xy[1]))
    mxyz = jm.moment_tensor_from_sdr(*sdrm[:3], m0=sdrm[3])
    t, s = jm.synthetic_seismograms(*jnp.asarray(loc), mxyz, stations, nt=61, dt=1.0)
    rng = np.random.default_rng(seed)
    obs = s + noise * float(jnp.max(jnp.abs(s))) * jnp.asarray(rng.standard_normal(s.shape))
    cfg = ji.TraceConfig(nu=79, ntg=61, lambdav=0.04, q=None, p=2)
    prob = jax.jit(lambda tt, oo: ji.build_loc_cmt_problem(tt, oo, stations, cfg, mxyz_fixed=mxyz,
                                                           impl="xla"))(t, obs)
    return cfg, prob, obs


def test_loc_cmt_inversion_farfield_matches_jax():
    """--physics farfield --grid 2: both scipy inversions in as many
    iterations as JAX's and within 1e-6 of their end points, each objective
    at the start within 1e-10, the scan's 12 misfits against JAX's
    misfit_grid, and the script's two assertions."""
    mod = example("loc_cmt_inversion")
    r = mod.run(CPU, physics="farfield", grid=2)
    ang = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    cfg, prob, _ = jax_farfield((60.0 * np.cos(ang) + 5.0, 60.0 * np.sin(ang) - 3.0),
                                [2.0, -1.5, 12.0], (30.0, 60.0, 45.0, 5.0e6), 7, 0.01)
    m0 = jnp.asarray(r["m0"])
    p = r["problem"]
    for mistype in ("OT", "L2"):
        opts = ji.InvOptions(loc=True, cmt=False, mistype=mistype)
        vg = jax.jit(lambda m: ji.loc_cmt_value_and_grad(m, prob, opts, cfg, impl="xla"))
        assert_vg(*loc_cmt_value_and_grad(p["m0"], p["prob"], mod.InvOptions(mistype=mistype),
                                          p["cfg"]), *vg(m0))
        ref = ji.minimize_scipy(vg, m0, jit_objective=False)
        got = r["inversions"][mistype]
        assert got["nit"] == ref.nit, mistype
        np.testing.assert_allclose(got["x"], ref.x, rtol=0, atol=X_TOL, err_msg=mistype)
    assert r["inversions"]["OT"]["err"] < 2.0
    vals = jax.jit(lambda ms: ji.misfit_grid(ms, prob, ji.InvOptions(), cfg, impl="xla"))(
        jnp.asarray(r["scan"]["models"]))
    np.testing.assert_allclose(r["scan"]["values"], np.asarray(vals), rtol=RTOL)


def test_loc_cmt_layered_scan_orders_nodes_as_its_models():
    """The layered branch at nk 32 on a 2x2 grid: each value of the
    depth-amortized scan (ordered (z, x, y)) equals the layered misfit of
    its own node (x, y, z) evaluated alone."""
    mod = example("loc_cmt_inversion")
    p = mod.build_problem(CPU, physics="layered", nk=32)
    sc = mod.scan(p, 2)
    assert sc["models"].shape == (8, 3) and sorted(set(sc["models"][:, 2])) == [10.0, 20.0]
    with torch.no_grad():
        alone = loc_cmt_misfit(torch.as_tensor(sc["models"]), p["prob"], mod.InvOptions(),
                               p["cfg"], forward=p["forward"])
    np.testing.assert_allclose(sc["values"], alone.numpy(), rtol=1e-9)


@pytest.mark.parametrize("cmt,held", [(False, "L2"), (True, "OT")], ids=["loc", "cmt"])
def test_multi_start_basins_farfield_matches_jax(cmt, held):
    """--physics farfield --nstarts 4 --nr 4 (and --cmt): the batched
    objective of the ``held`` misfit at every start within 1e-10 of JAX's
    (in the joint mode with its per-start least-squares tensors, also held,
    and preconditioning), and both studies cut to 3 iterations: at least
    one objective call per iteration."""
    mod = example("multi_start_basins")
    st = mod.build_study(CPU, nstarts=4, nr=4, cmt=cmt, physics="farfield")
    ang = np.linspace(0, 2 * np.pi, 4, endpoint=False)
    cfg, prob, obs = jax_farfield((60.0 * np.cos(ang), 60.0 * np.sin(ang)), [2.0, -1.5, 12.0],
                                  (30.0, 60.0, 45.0, 5.0e6), 3, 0.005)
    starts = jnp.asarray(st["starts"].numpy())
    if cmt:
        stations = jm.StationSet(x=jnp.asarray(60.0 * np.cos(ang)),
                                 y=jnp.asarray(60.0 * np.sin(ang)))
        mscal = jnp.asarray(st["mscal"].numpy())
        m6 = jax.jit(jax.vmap(lambda l: jm.moment_tensor_ls(l, stations, obs, nt=61, dt=1.0)))(
            starts[:, :3] * mscal[:3])
        np.testing.assert_allclose(st["starts"].numpy()[:, 3:], np.asarray(m6 / mscal[3:]),
                                   rtol=RTOL)
        prob = prob._replace(mscal=mscal)
    opts = ji.InvOptions(loc=True, cmt=cmt, mistype=held, precon=cmt)
    ref = jax.jit(jax.vmap(lambda m: ji.loc_cmt_value_and_grad(m, prob, opts, cfg, impl="xla")))(
        starts)
    got = loc_cmt_value_and_grad(st["starts"], st["prob"],
                                 mod.InvOptions(mistype=held, cmt=cmt, precon=cmt), st["cfg"])
    assert_vg(*(a.numpy() for a in got), *ref)
    for mistype in ("OT", "L2"):
        out = mod.solve(st, mistype, max_iter=3)
        assert out["evaluations"] >= int(out["n_iter"].max()) + 1
        assert out["x"].shape == (4, 9 if cmt else 3) and 0.0 <= out["frac"] <= 1.0


def test_multi_start_layered_ls_block_recovers_the_tensor():
    """The joint mode's least-squares block through the layered forward at
    the source (nk 32): the true moment tensor within 2% of its largest
    entry (the data carry 0.5% noise)."""
    mod = example("multi_start_basins")
    st = mod.build_study(CPU, nstarts=1, nr=4, cmt=False, physics="layered", nk=32)
    loc = torch.as_tensor(st["m_true"])
    m6 = mod.ls_block(loc, st["stations"], st["obs"], st["forward"])
    true6 = mod.upper_from_mxyz(st["prob"].mxyz_fixed)
    assert ((m6 - true6).abs().max() / true6.abs().max()).item() < 0.02


# ---------------------------------------------------------------------------
# 9. the scaling study
# ---------------------------------------------------------------------------


def test_scaling_study_functions():
    """The timing function at 16 stations and 2 calls, in float64 to hold
    its value and gradient within 1e-10 against the bench problem of
    __graft_entry__._build_problem (built here by jax_farfield), and the
    inversion function at k 4 (4 stations, 5 of the script's 50
    iterations, float32 as in the script)."""
    mod = example("scaling_study")
    r = mod.time_value_and_grad(16, CPU, n_iter=2, dtype=torch.float64)
    assert r["traces"] == 48 and r["seconds"] > 0 and r["traces_per_s"] > 0
    ang = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    loc = [2.0, -1.5, 12.0]
    cfg, prob, _ = jax_farfield((60.0 * np.cos(ang), 60.0 * np.sin(ang)), loc,
                                (30.0, 60.0, 45.0, 5.0e6), 0, 0.002)
    ref = jax.jit(lambda m: ji.loc_cmt_value_and_grad(m, prob, ji.InvOptions(), cfg, impl="xla"))(
        jnp.asarray(loc) + jnp.asarray([4.0, -3.0, 2.0]))
    assert_vg(r["value"], r["grad"], *ref)
    inv = mod.inversions(4, CPU, nr=4, max_iter=5)
    assert inv["k"] == 4 and inv["seconds"] > 0 and 0.0 <= inv["converged"] <= 1.0
    assert inv["evaluations"] >= 2 * (inv["median_iters"] + 1)
