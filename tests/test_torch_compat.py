"""Parity of the port's reference-API surface (``waveform_ot_torch.compat``)
with the JAX package's ``compat`` (CPU, float64).

Both take the same NumPy inputs; the port's objects are built with
``device="cpu"``. Bars: values, gradients, plans, fields and attributes
1e-10 relative to the largest reference entry (segment indices equal);
the Sinkhorns 1e-9.
"""

import ast
import importlib
import inspect
import os

import jax
import numpy as np
import pytest
import torch

from waveform_ot_torch import compat as tc
from waveform_ot_torch.ops import cuda_distance
from waveform_ot_torch.ops import errors as terr
from waveform_ot_torch.ops import fingerprint as tfp
from waveform_ot_tpu import compat as jc
from waveform_ot_tpu.ops import marginal as jmarg
from waveform_ot_tpu.ops import sliced as jsl

jw = importlib.import_module("waveform_ot_tpu.ops.wasser")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
CLOSED = 1e-10


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    before = cuda_distance.LAUNCHES
    yield
    assert cuda_distance.LAUNCHES == before


def J(fn, nums=(), names=()):
    """``fn`` jitted with the given static arguments."""
    return jax.jit(fn, static_argnums=nums, static_argnames=names)


def assert_rel(got, ref, tol=CLOSED, what=""):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(np.abs(ref).max(initial=0.0), 1e-300)
    err = np.abs(got - ref).max(initial=0.0)
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} * {scale:.3e}"


def assert_nested(got, ref, tol=CLOSED):
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert_nested(a, b, tol)
    else:
        assert_rel(got, ref, tol)


def _wave(seed=0, nt=25):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 2.0, nt)
    return t, 0.6 * np.sin(3 * t) + 0.05 * rng.standard_normal(nt)


GRID = (0.0, 2.0, -1.0, 1.0, 18, 20)


def _fps(seed=0, **kw):
    t, w = _wave(seed)
    return jc.waveformFP(t, w, GRID, **kw), tc.waveformFP(t, w, GRID, device=CPU, **kw)


def _pair_1d(seed, n=10):
    rng = np.random.default_rng(seed)
    f, g = rng.random(n) + 0.05, rng.random(n) + 0.05
    x = np.linspace(0.0, 1.0, n)
    return ((jc.OTpdf((f, x)), jc.OTpdf((g, x))),
            (tc.OTpdf((f, x), CPU), tc.OTpdf((g, x), CPU)))


def _pair_fp(lam=0.04, q=None):
    """Two fingerprint OTpdfs (a waveform and a shifted copy), both packages."""
    out = []
    for seed, shift in ((1, 0.0), (1, 0.12)):
        t, w = _wave(seed)
        w = np.interp(t - shift, t, w)
        jf, tf = jc.waveformFP(t, w, GRID), tc.waveformFP(t, w, GRID, device=CPU)
        jf.calcpdf(lambdav=lam, q=q)
        tf.calcpdf(lambdav=lam, q=q)
        out.append((jc.OTpdf((jf.pdf, jf.pos)), tc.OTpdf((tf.pdf, tf.pos), CPU)))
    return (out[0][0], out[1][0]), (out[0][1], out[1][1])


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------


def _reference_names():
    """Top-level public names of the JAX compat (its plot wrappers
    included) and its two FD harnesses, minus what is not ported yet."""
    path = os.path.join(REPO, "waveform_ot_tpu", "compat.py")
    names = {"_checkderivSliced", "_checkderivMarg"}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in ast.walk(node) if isinstance(t, ast.Name)
                         and isinstance(t.ctx, ast.Store))
    return sorted(n for n in names if not n.startswith("_") or n.startswith("_check"))


def test_every_compat_name_resolves():
    names = _reference_names()
    assert len(names) >= 40 and "waveformFP" in names and "filter" in names
    missing = [n for n in names if not hasattr(tc, n)]
    assert not missing, missing
    for method in ("calcpdf", "wdistderiv", "PDFderiv", "PDFderivMarg"):
        assert callable(getattr(tc.waveformFP, method))
    assert "plotPDFsurface" in names and "trim_axs" in names
    assert {"wasserPOT", "sinkhornPOT", "calcFMM_dist_deriv"} <= set(names)


def test_exception_spellings_are_the_same_classes():
    for name in dir(jc):
        obj = getattr(jc, name)
        if inspect.isclass(obj) and issubclass(obj, Exception):
            port = getattr(tc, name)
            assert port is getattr(terr, obj.__name__), name
    assert tc.WaveformPFderivError is terr.WaveformFPderivError
    assert tc.FMMlibraryError is terr.FMMLibraryError
    assert tc.POTlibraryError is terr.POTLibraryError
    assert tc.Error is terr.OTError


def test_entry_points_default_to_the_card():
    for fn in (tc.OTpdf.__init__, tc.waveformFP.__init__, tc.SinkhornAB, tc.filter):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# OTpdf and the OT entry points
# ---------------------------------------------------------------------------


def test_otpdf_attributes_match_jax():
    (js, _), (ts, _) = _pair_1d(2)
    for name in ("amp", "pdf", "x", "cdf"):
        assert_rel(getattr(ts, name), getattr(js, name), what=name)
    assert (ts.n, ts.ndim, ts.type) == (js.n, js.ndim, js.type) == (10, 1, "1D")
    assert ts.density.pdf.device.type == CPU
    (j2, _), (t2, _) = _pair_fp()
    assert (t2.nx, t2.ny, t2.n, t2.type) == (j2.nx, j2.ny, j2.n, j2.type)
    for name in ("amp", "pdf", "x"):
        assert_rel(getattr(t2, name), getattr(j2, name), what=name)
    j2.setMarginals()
    t2.setMarginals()
    for jm, tm in zip(j2.marg, t2.marg):
        for name in ("amp", "pdf", "x", "cdf"):
            assert_rel(getattr(tm, name), getattr(jm, name), what=name)
    j2.setSliced(4, (0.5, 0.5))
    t2.setSliced(4, (0.5, 0.5))
    np.testing.assert_array_equal(t2.psorted, j2.psorted)
    assert_rel(t2.angles, j2.angles, 1e-15)
    for jp, tp in zip(j2.proj, t2.proj):
        assert_rel(tp.pdf, jp.pdf)
        assert_rel(tp.x, jp.x, 1e-14)
    with pytest.raises(terr.TargetSource2DShapeError):
        ts.setMarginals()


@pytest.mark.parametrize("f,err", [(np.array([0.3, -0.2, 0.4]), "PDFSignError"),
                                   (np.ones(4), "PDFShapeError")])
def test_otpdf_errors(f, err):
    with pytest.raises(getattr(tc, err)):
        tc.OTpdf((f, np.linspace(0, 1, 3)), CPU)
    with pytest.raises(getattr(jc, err)):
        jc.OTpdf((f, np.linspace(0, 1, 3)))


@pytest.mark.parametrize("distfunc,derivatives,returnplan", [
    ("W12", True, True), ("W2", False, True), ("W1", True, False), ("W12", False, False)])
def test_wasser_matches_jax(distfunc, derivatives, returnplan):
    """Against the JAX compat's composition of wasser, the plan and its
    Jacobian, each jitted."""
    (js, jt), (ts, tt) = _pair_1d(3)
    got = tc.wasser(ts, tt, distfunc, derivatives=derivatives, returnplan=returnplan)
    ref = list(J(jw.wasser, names=("distfunc", "derivatives"))(
        js.density, jt.density, distfunc=distfunc, derivatives=derivatives))
    args = (js.density.pdf * js.density.amp, js.density.x, jt.density.pdf * jt.density.amp,
            jt.density.x)
    if returnplan:
        ref.append(J(jw.transport_plan_1d)(*args))
        if derivatives:
            ref.append(J(jw.transport_plan_jacobian)(*args))
    assert_nested(got, [np.asarray(v) for v in ref])


def test_wasser_tie_raises_unless_ignored():
    x = np.linspace(0.0, 1.0, 3)
    f, g = np.array([1.0, 1.0, 2.0]), np.array([2.0, 1.0, 1.0])   # CDFs share 1/4
    js, jt = jc.OTpdf((f, x)), jc.OTpdf((g, x))
    ts, tt = tc.OTpdf((f, x), CPU), tc.OTpdf((g, x), CPU)
    with pytest.raises(jc.TargetSourceCDFError):
        jc.wasser(js, jt, "W2", derivatives=True)
    with pytest.raises(tc.TargetSourceCDFError):
        tc.wasser(ts, tt, "W2", derivatives=True)
    with pytest.raises(tc.TargetSourceCDFError):
        tc.wasser(ts, tt, "W2", checkCommonCDF=True)
    ref = J(jw.wasser, names=("distfunc", "derivatives"))(js.density, jt.density,
                                                          distfunc="W2", derivatives=True)
    assert_nested(tc.wasser(ts, tt, "W2", derivatives=True, ignoreCommonCDFerror=True),
                  [np.asarray(v) for v in ref])


@pytest.mark.parametrize("returnmargW", [False, True])
def test_marg_and_sliced_wasserstein_match_jax(returnmargW):
    """Against the JAX functions that the JAX compat wraps, jitted (eager
    mode compiles each operation apart, ~10 s here)."""
    (js, jt), (ts, tt) = _pair_fp()
    kw = dict(distfunc="W2", derivatives=True, returnmargW=returnmargW)
    ref = J(jmarg.marg_wasserstein, names=tuple(kw))(js.density, jt.density, **kw)
    assert_nested(tc.MargWasserstein(ts, tt, **kw), ref)
    kw = dict(distfunc="W1")
    ref = J(jmarg.marg_wasserstein, names=tuple(kw))(js.density, jt.density, **kw)
    assert_nested(tc.MargWasserstein(ts, tt, **kw), ref)
    with pytest.raises(tc.MarginalWassersteinError):
        tc.MargWasserstein(ts, tt, "W12")
    kw = dict(derivatives=True, origin=(0.4, 0.5)) if returnmargW else {}
    ref = J(jsl.sliced_wasserstein, nums=(2,), names=tuple(kw))(js.density, jt.density, 5, **kw)
    assert_nested(tc.SlicedWasserstein(ts, tt, 5, **kw), ref)


def test_fd_harnesses(capsys):
    """The harnesses' central differences against the analytic gradients
    (1e-6 relative), at the index and in the structure the reference
    returns: the first amplitude above the floor, or the one given."""
    rng = np.random.default_rng(4)
    pos = np.dstack(np.meshgrid(np.linspace(0, 1, 3), np.linspace(0, 1, 3)))
    f, g = rng.random((3, 3)) + 0.1, rng.random((3, 3)) + 0.1
    ts, tt = tc.OTpdf((f, pos), CPU), tc.OTpdf((g, pos), CPU)
    _, dw, _ = tc.MargWasserstein(ts, tt, derivatives=True)
    _, dws, _ = tc.MargWasserstein(ts, tt, derivatives=True, returnmargW=True)
    assert tc._checkderivMarg(ts, tt, 1e-6) == pytest.approx(dw.flat[0], rel=1e-6)
    assert tc._checkderivMarg(ts, tt, 1e-4, ind=[2], percent=True) == pytest.approx(
        dw.flat[2], rel=1e-6)
    assert_nested(tc._checkderivMarg(ts, tt, 1e-6, returnmargW=True),
                  [dws[0].flat[0], dws[1].flat[0]], 1e-6)
    assert tc._checkderivMarg(ts, tt, 1e-6, dffloor=10.0) == (None, None)
    assert tc._checkderivSliced(ts, tt, 1e-6, Nproj=3) is None
    printed = capsys.readouterr().out
    assert "Sliced Wasserstein" in printed and printed.count(" :    plan ") == 9


def test_oracles_match_jax():
    (js, jt), (ts, tt) = _pair_1d(5, 6)
    assert tc.wasserNumInt(ts, tt) == jc.wasserNumInt(js, jt)
    w, h = tc.Wasser_LinProg(ts, tt, "W2")
    jw, jh = jc.Wasser_LinProg(js, jt, "W2")
    assert w == jw
    np.testing.assert_array_equal(h, jh)
    ok, plan = tc.wasser_find_optplan(ts, tt, w)
    jok, jplan = jc.wasser_find_optplan(js, jt, w)
    assert ok == jok
    np.testing.assert_array_equal(plan, jplan)
    for spec in ("W2", "W1", lambda i, j, a: abs(i - j) * a):
        for a, b in zip(tc.BuildLinProg(ts, tt, spec, 0.5), jc.BuildLinProg(js, jt, spec, 0.5)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(tc.UnknownOTDistanceTypeError):
        tc.BuildLinProg(ts, tt, "W3")
    A = np.arange(36.0).reshape(6, 6)
    np.testing.assert_array_equal(tc.distfunction([0, 2], [1, 3], A),
                                  jc.distfunction([0, 2], [1, 3], A))
    a = np.array([0.0, 0.5, 2.0])
    np.testing.assert_array_equal(tc.powv(a, 2), jc.powv(a, 2))
    np.testing.assert_array_equal(tc.maxv(a, 1.0), jc.maxv(a, 1.0))
    np.testing.assert_array_equal(tc.logv(a), jc.logv(a))


def test_sinkhorns_and_filter_match_jax():
    (js, jt), (ts, tt) = _pair_1d(6, 12)
    assert_nested(tc.Sinkhorn_MS(ts, tt, gamma=2e-3, maxiters=300),
                  jc.Sinkhorn_MS(js, jt, gamma=2e-3, maxiters=300), 1e-9)
    rng = np.random.default_rng(6)
    mu0, mu1 = rng.random((7, 8)) + 0.1, rng.random((7, 8)) + 0.1
    mu0, mu1 = mu0 / mu0.sum(), mu1 / mu1.sum()
    pos = np.dstack(np.meshgrid(np.linspace(0, 1, 8), np.linspace(0, 1, 7)))
    s2, t2 = jc.OTpdf((mu0, pos)), jc.OTpdf((mu1, pos))
    ps2, pt2 = tc.OTpdf((mu0, pos), CPU), tc.OTpdf((mu1, pos), CPU)
    assert_nested(tc.Sinkhorn(ps2, pt2, gamma=0.8, iter=100),
                  jc.Sinkhorn(s2, t2, gamma=0.8, iter=100), 1e-9)
    assert_nested(tc.Sinkhorn(ps2, pt2), jc.Sinkhorn(s2, t2), 1e-9)   # radius 0
    assert_rel(tc.filter(mu0, 1.3, device=CPU), jc.filter(mu0, 1.3), 1e-12)


def test_sinkhorn_ab_matches_jax():
    """5001 steps on a 4 x 5 grid, as the reference fixes them."""
    rng = np.random.default_rng(7)
    mu = [rng.random((4, 5)) + 0.1 for _ in range(2)]
    mu = [m / m.sum() for m in mu]
    assert_nested(tc.SinkhornAB(mu, 0.9, device=CPU), jc.SinkhornAB(mu, 0.9), 1e-9)


def test_barypaths_match_jax():
    (js, jt), (ts, tt) = _pair_1d(8)
    weights = np.linspace(0.0, 1.0, 5)
    assert_nested(tc.barypath_pointmass(ts, tt, weights), jc.barypath_pointmass(js, jt, weights))
    assert_rel(tc.barypath(ts, tt, weights, pointmass=True),
               jc.barypath(js, jt, weights, pointmass=True))
    assert_nested(tc.barypath(ts, tt, weights, npoints=3001, returntaxis=True),
                  jc.barypath(js, jt, weights, npoints=3001, returntaxis=True))


# ---------------------------------------------------------------------------
# waveformFP and the FingerprintLib utilities
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"tantheta": 0.7},
                                {"fpgrid": (0.2, 1.7, -0.8, 0.9, 18, 20)}])
def test_waveformfp_attributes_match_jax(kw):
    jf, tf = _fps(2, **kw)
    for name in ("nt", "ntg", "nug", "tlim", "ulim", "tlimn", "ulimn", "tlimfp", "ulimfp",
                 "tlimnfp", "ulimnfp", "dcalc", "drcalc"):
        assert getattr(tf, name) == getattr(jf, name), name
    assert tf.tant == pytest.approx(jf.tant, rel=1e-15)
    for name in ("p", "pn", "delta_n", "lsq_n", "x0", "delgrid"):
        assert_rel(getattr(tf, name), getattr(jf, name), 1e-15, name)


@pytest.mark.parametrize("method,q", [("Enumerate", None), ("Enumerate", 2),
                                      ("NNsearch", None)])
@pytest.mark.parametrize("fpgrid", [None, (0.2, 1.7, -0.8, 0.9, 18, 20)])
def test_calcpdf_and_chain_match_jax(method, q, fpgrid):
    """Fields, density, rays, dddy and the PDFderiv/PDFderivMarg chains.

    The exact field multiplies by 1/|c|^2 where the JAX one divides
    (ops/fingerprint.py), and the two grids may part by an ulp, so a grid
    point equidistant from two segments may take the other one. Here that
    happens only where both segments end at the same vertex: the segments
    are neighbours, and the nearest point (xrays) and every chain agree."""
    jf, tf = _fps(3, fpgrid=fpgrid)
    for f in (jf, tf):
        f.calcpdf(q=q, lambdav=0.05, deriv=True, method=method)
    assert tf.type == jf.type
    assert tf.irays.dtype == jf.irays.dtype
    flips = tf.irays != jf.irays
    assert flips.sum() <= 2
    assert np.all(np.abs(tf.irays - jf.irays)[flips] == 1)
    for name in ("dfield", "pdf", "xrays", "pos"):
        assert_rel(getattr(tf, name), getattr(jf, name), what=name)
    for name in ("lrays", "dddy"):
        assert_rel(getattr(tf, name)[~flips], getattr(jf, name)[~flips], what=name)
    rng = np.random.default_rng(3)
    chain = [rng.standard_normal((18, 20)) for _ in range(2)]
    assert_rel(tf.PDFderiv(), jf.PDFderiv())
    assert_rel(tf.PDFderiv(chain[0]), jf.PDFderiv(chain[0]))
    assert_nested(tf.PDFderivMarg(chain), jf.PDFderivMarg(chain))
    assert_rel(tf.pdfdMarg[1], jf.pdfdMarg[1])


def test_calcpdf_errors():
    jf, tf = _fps(4)
    with pytest.raises(tc.WaveformFPderivError):
        tf.wdistderiv()
    with pytest.raises(tc.FingerprintMethodError):
        tf.calcpdf(method="Pallas")
    tf.calcpdf(lambdav=0.05)
    with pytest.raises(tc.WaveformPFderivError):
        tf.PDFderiv()


def test_pdfderivmarg_matches_autograd():
    """The reference's analytic chain against autograd through the port's
    fingerprint_density, 1e-8 relative (as the JAX package's own test)."""
    t, w = _wave(5)
    tf = tc.waveformFP(t, w, GRID, device=CPU)
    tf.calcpdf(lambdav=0.05, deriv=True)
    rng = np.random.default_rng(5)
    chain = [rng.standard_normal((18, 20)) for _ in range(2)]
    rows = tf.PDFderivMarg(chain)
    spec = tfp.FingerprintSpec(nu=18, ntg=20)
    wt = torch.tensor(w, dtype=torch.float64, requires_grad=True)
    pdf, _ = tfp.fingerprint_density(torch.tensor(t), wt[None], tf._win, spec, lambdav=0.05)
    for cm, row in zip(chain, rows):
        (g,) = torch.autograd.grad((pdf[0] * torch.tensor(cm)).sum(), wt, retain_graph=True)
        assert_rel(row, g.numpy(), 1e-8)


def test_wavedist_and_wavederiv_match_jax():
    jf, tf = _fps(6)
    pts = jc._grid_points_n(jf)
    np.testing.assert_array_equal(tc._grid_points_n(tf), pts)
    jout, tout = jc.wavedistv(pts, jf), tc.wavedistv(pts, tf)
    np.testing.assert_array_equal(tout[1], jout[1])
    for a, b in zip(tout, jout):
        assert_rel(a, b)
    d, i, xc = tc.wavedist(np.array([0.5, 0.7]), tf)
    jd, ji, jxc = jc.wavedist(np.array([0.5, 0.7]), jf)
    assert i == ji and d == pytest.approx(jd, rel=1e-14)
    assert_rel(xc, jxc)
    args = (jout[0], jout[1], jout[2], jout[3], pts)
    assert_nested(tc.wavederiv(*args, tf, verbose=True), jc.wavederiv(*args, jf, verbose=True))
    chain = np.random.default_rng(6).standard_normal((18, 20))
    jf.calcpdf(lambdav=0.05)
    tf.calcpdf(lambdav=0.05)
    dddy = jc.wavederiv(*args, jf)
    assert_rel(tc.wPDFderiv(tf.pdf, dddy, 0.05, jout[1], tf, chain),
               jc.wPDFderiv(jf.pdf, dddy, 0.05, jout[1], jf, chain))


@pytest.mark.parametrize("ni", [0, 2])
def test_nnsearch_matches_jax(ni):
    jf, tf = _fps(7)
    got, ref = tc.NNsearch(tf, ni=ni), jc.NNsearch(jf, ni=ni)
    np.testing.assert_array_equal(got[1], ref[1])
    for a, b in zip(got, ref):
        assert_rel(a, b)


def test_fd_checks_match_jax():
    jf, tf = _fps(8)
    for f in (jf, tf):
        f.calcpdf(lambdav=0.05)
    for k in (7, 120):
        assert_nested(tc.check_FDderiv(tf, k, du=1e-5), jc.check_FDderiv(jf, k, du=1e-5), 1e-6)
    t, w = _wave(8, nt=6)
    grid = (0.0, 2.0, -1.0, 1.0, 5, 6)
    small = [jc.waveformFP(t, w, grid), tc.waveformFP(t, w, grid, device=CPU)]
    assert tc.check_FDchain(small[1], 0.05) == pytest.approx(jc.check_FDchain(small[0], 0.05),
                                                             rel=1e-6)


def test_reference_migration_flow_on_the_port():
    """examples/reference_migration.py's n = 10 problem and assertions,
    through the port's compat on the CPU."""
    from waveform_ot_torch.ops.validate import monge_1d

    rng = np.random.default_rng(61254557)
    n = 10
    f, g = rng.random(n), rng.random(n)
    x = np.linspace(0.0, 1.0, n)
    source, target = tc.OTpdf((f, x), CPU), tc.OTpdf((g, x), CPU)
    w1, dw1, dt1, w2, dw2, dt2 = tc.wasser(source, target, "W12", derivatives=True)
    w1n, w2n = tc.wasserNumInt(source, target)
    wlp, _ = tc.Wasser_LinProg(source, target, distfunc="W2")
    _, c = monge_1d(f, g)
    ws, _ = tc.Sinkhorn_MS(source, target, gamma=2e-3, maxiters=800)
    assert abs(wlp - c) < 1e-8
    assert abs(w1n - w1) < 5e-4 and abs(w2n - w2) < 5e-4
    assert abs(wlp - w2) < 1e-8 and abs(c - w2) < 1e-8
    assert abs(ws - w2) < 5e-3
    hp = tc.wasser(source, target, "W2", returnplan=True)[-1]
    assert np.abs(hp.sum(1) - source.pdf).max() < 1e-12
    assert np.abs(hp.sum(0) - target.pdf).max() < 1e-12
