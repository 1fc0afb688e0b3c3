"""The port's native slice against the JAX package (CPU, float64): the exact
EMD and the fast-marching solver of ``waveform_ot_torch.native`` (the port's
own copy of the C++ source, built with g++ into ``waveform_ot_torch/_build``),
``ops.fmm``, ``ops.pot_bridge`` and compat's ``calcpdf(method="FMM")``,
``calcFMM_dist_deriv``, ``wasserPOT`` and ``sinkhornPOT``.

The models are ``tests/test_native.py`` and the POT/FMM cases of
``tests/test_ot_extras.py``; here each case runs the JAX function and the
port's on the same seed-made inputs. Bars: the EMD value within 1e-12 and its
plan equal (the same C++ solver); the FMM field bit for bit; the FMM pdf
within 1e-12; the ray end points equal; the POT bridges within 1e-10
(relative); the "pot"/"skfmm" raises as JAX's. Grids are at most 48x64 and
EMDs at most 100 points.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveform_ot_torch import _build, convert
from waveform_ot_torch import compat as tc
from waveform_ot_torch import native as tn
from waveform_ot_torch.ops import cuda_distance
from waveform_ot_torch.ops import errors as terr
from waveform_ot_torch.ops import fmm as tfmm
from waveform_ot_torch.ops import pot_bridge as tpot
from waveform_ot_torch.ops.fingerprint import distance_field_torch
from waveform_ot_torch.ops.wasser import transport_plan_1d, wasserstein_1d
from waveform_ot_tpu import compat as jc
from waveform_ot_tpu import native as jn
from waveform_ot_tpu.ops import errors as jerr
from waveform_ot_tpu.ops import fmm as jfmm
from waveform_ot_tpu.ops import make_density_1d, make_density_2d
from waveform_ot_tpu.ops import pot_bridge as jpot

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    before = cuda_distance.LAUNCHES
    yield
    assert cuda_distance.LAUNCHES == before


def _masses(rng, n, floor=1e-3):
    a = rng.random(n) + floor
    return a / a.sum()


def _linprog_value(a, b, cost):
    """The transportation LP's optimum by scipy's HiGHS."""
    from scipy.optimize import linprog

    n, m = len(a), len(b)
    a_eq = np.zeros((n + m, n * m))
    for i in range(n):
        a_eq[i, i * m:(i + 1) * m] = 1.0
    for j in range(m):
        a_eq[n + j, j::m] = 1.0
    res = linprog(cost.ravel(), A_eq=a_eq, b_eq=np.concatenate([a, b]), bounds=(0, None),
                  method="highs")
    assert res.success
    return res.fun


def _emd_both(*args, **kw):
    """The port's and JAX's native EMD on the same inputs: the values within
    1e-12 and the plans equal."""
    v, plan = tn.emd(*args, **kw)
    jv, jplan = jn.emd(*args, **kw)
    assert abs(v - jv) <= 1e-12
    np.testing.assert_array_equal(plan, jplan)
    return v, plan


# ---------------------------------------------------------------------------
# the library and its build
# ---------------------------------------------------------------------------


def test_source_is_the_jax_packages_but_for_comments():
    """The port keeps its own copy of wotnative.cpp: the same code, line for
    line, once comments are stripped."""
    def code(path):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        return [line.rstrip() for line in text.splitlines() if line.strip()]

    assert code(tn._SRC) == code(REPO / "waveform_ot_tpu" / "native" / "src" / "wotnative.cpp")


def test_library_builds_into_the_ports_build_dir():
    assert tn.available()
    so = Path(tn._load()._name)
    assert so.parent == _build._BUILD_DIR and so.name.startswith("wotnative-")
    assert so == _build.cached_path(tn._SRC, _build.GXX_FLAGS)
    assert _build.GXX_FLAGS == ("-O3", "-std=c++17", "-shared", "-fPIC")


def test_missing_gxx_raises_native_build_error(monkeypatch, tmp_path):
    """With no g++ on PATH the build raises NativeBuildError (a
    KernelBuildError), builds nothing, and nothing substitutes a solver."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    tn._load.cache_clear()
    try:
        assert not tn.available()
        with pytest.raises(tn.NativeBuildError, match="g\\+\\+ not found"):
            tn.emd([1.0], [1.0], [[1.0]])
        assert issubclass(tn.NativeBuildError, _build.KernelBuildError)
        assert not (tmp_path / "build").exists()
    finally:
        tn._load.cache_clear()


# ---------------------------------------------------------------------------
# exact EMD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_emd_matches_jax_and_linprog(seed):
    rng = np.random.default_rng(seed)
    n, m = (int(k) for k in rng.integers(3, 14, 2))
    a, b, cost = _masses(rng, n), _masses(rng, m), rng.random((n, m))
    v, plan = _emd_both(a, b, cost)
    assert abs(v - _linprog_value(a, b, cost)) < 1e-10
    np.testing.assert_allclose(plan.sum(1), a, atol=1e-12)
    np.testing.assert_allclose(plan.sum(0), b, atol=1e-12)


@pytest.mark.parametrize("p", [1, 2])
def test_emd_matches_the_ports_closed_form_1d(p):
    rng = np.random.default_rng(p)
    n, m = 100, 80
    x, y = np.sort(rng.random(n)), np.sort(rng.random(m))
    f, g = _masses(rng, n), _masses(rng, m)
    v, _ = _emd_both(f, g, np.abs(x[:, None] - y[None, :]) ** p)
    w = wasserstein_1d(*(torch.tensor(a)[None] for a in (f, x, g, y)), p)
    assert abs(v - w.item()) < 1e-12


def test_emd_plan_is_the_ports_1d_scatter_plan():
    """The 1-D W2 plan is unique for generic data: the LP optimum equals the
    merged-CDF plan of ops.wasser.transport_plan_1d."""
    rng = np.random.default_rng(25)
    n = 25
    x, y = np.sort(rng.random(n)), np.sort(rng.random(n)) + 0.1
    f, g = _masses(rng, n, 1e-2), _masses(rng, n, 1e-2)
    _, plan = _emd_both(f, g, (x[:, None] - y[None, :]) ** 2)
    h = transport_plan_1d(*(torch.tensor(a) for a in (f, x, g, y)))
    np.testing.assert_allclose(plan, h.numpy(), atol=1e-12)


def test_emd_point_mass_and_zero_rows():
    v, plan = _emd_both([1.0], [1.0], [[2.5]])
    assert v == 2.5 and plan[0, 0] == 1.0
    v, plan = _emd_both([0.5, 0.0, 0.5], [1.0], [[1.0], [9.0], [3.0]])
    assert abs(v - 2.0) < 1e-14 and plan[1, 0] == 0.0


@pytest.mark.parametrize("a,b,cost", [
    ([0.6, 0.4], [1.0], np.zeros((3, 1))),     # bad shape
    ([0.7, 0.7], [1.0], np.zeros((2, 1))),     # unbalanced
    ([0.0, 0.0], [0.0], np.zeros((2, 1))),     # no mass
], ids=["shape", "unbalanced", "empty"])
def test_emd_input_validation_like_jax(a, b, cost):
    for emd in (tn.emd, jn.emd):
        with pytest.raises(ValueError):
            emd(a, b, cost)


def test_emd_max_iter_honored_like_jax():
    rng = np.random.default_rng(30)
    a, b, cost = _masses(rng, 30, 0.01), _masses(rng, 30, 0.01), rng.random((30, 30))
    for emd in (tn.emd, jn.emd):
        with pytest.raises(RuntimeError):
            emd(a, b, cost, max_iter=2)      # far too few augmentations
    v, _ = _emd_both(a, b, cost)
    assert np.isfinite(v)


# ---------------------------------------------------------------------------
# fast marching
# ---------------------------------------------------------------------------


def _circle(nu=48, ntg=64, r=0.7):
    ug = np.linspace(-1.2, 1.2, nu)
    tg = np.linspace(-1.3, 1.3, ntg)
    u, t = np.meshgrid(ug, tg, indexing="ij")
    return ug, tg, np.sqrt(u * u + t * t) - r


@pytest.mark.parametrize("order", [1, 2])
def test_fmm_distance_matches_jax_on_a_circle(order):
    """Bit for bit JAX's field; first order within half a cell of the exact
    distance near the circle; the sign of phi kept."""
    ug, tg, phi = _circle()
    dx = (ug[1] - ug[0], tg[1] - tg[0])
    d = tn.fmm_distance(phi, dx, order=order)
    np.testing.assert_array_equal(d, jn.fmm_distance(phi, dx, order=order))
    assert np.all(d[phi > 0] > 0) and np.all(d[phi < 0] < 0)
    if order == 1:
        assert np.abs(d - phi)[np.abs(phi) < 0.4].max() < 0.5 * dx[0]


def test_fmm_no_contour_raises_like_jax():
    for fmm in (tn.fmm_distance, jn.fmm_distance):
        with pytest.raises(ValueError):
            fmm(np.ones((6, 6)), (0.1, 0.1))


def _rf_like(nt=40):
    t = np.linspace(0.0, 1.0, nt)
    return t, 0.45 + 0.25 * np.sin(2 * np.pi * t)


@pytest.mark.parametrize("backend,order", [("auto", None), ("native", 2)])
def test_distance_field_fmm_matches_jax_and_the_exact_field(backend, order):
    """distance_field_fmm bit for bit JAX's (tensors in for the port, arrays
    for JAX); with the default first order, within 1.5/nu (median) and 6/nu
    (max) of the port's exact polyline field outside the interface band."""
    nu, ntg = 48, 64
    t, w = _rf_like()
    tg, ug = np.linspace(0.0, 1.0, ntg), np.linspace(0.0, 1.0, nu)
    d = tfmm.distance_field_fmm(torch.tensor(t), torch.tensor(w), torch.tensor(tg),
                                torch.tensor(ug), backend=backend, order=order)
    np.testing.assert_array_equal(d, jfmm.distance_field_fmm(t, w, tg, ug, backend=backend,
                                                             order=order))
    if order is None:
        exact = distance_field_torch(torch.tensor(np.stack([t, w], 1))[None],
                                     torch.tensor(tg)[None], torch.tensor(ug)[None]).d[0]
        band = exact.numpy() > 2.0 / nu
        err = np.abs(d - exact.numpy())[band]
        assert np.median(err) < 1.5 / nu and err.max() < 6.0 / nu


def test_fmm_backends_raise_like_jax():
    t = np.linspace(0, 1, 10)
    args = (t, np.sin(t), t, np.linspace(-1, 2, 8))
    assert tfmm.HAVE_SKFMM == jfmm.HAVE_SKFMM
    if not tfmm.HAVE_SKFMM:
        with pytest.raises(terr.FMMLibraryError):
            tfmm.distance_field_fmm(*args, backend="skfmm")
        with pytest.raises(jerr.FMMLibraryError):
            jfmm.distance_field_fmm(*args, backend="skfmm")
    for fn in (tfmm.distance_field_fmm, jfmm.distance_field_fmm):
        with pytest.raises(ValueError, match="unknown FMM backend"):
            fn(*args, backend="gpu")


def test_fmm_ray_endpoints_match_jax():
    """Rays from the field of the line u = 0.5 land on it and keep their
    time; the port's end points equal JAX's."""
    nu, ntg = 48, 40
    ug, tg = np.linspace(0.0, 1.0, nu), np.linspace(0.0, 1.0, ntg)
    d = np.abs(ug[:, None] - 0.5) * np.ones((1, ntg))
    dx = (ug[1] - ug[0], tg[1] - tg[0])
    xw, yw = tfmm.fmm_ray_endpoints(torch.tensor(d), dx)
    jxw, jyw = jfmm.fmm_ray_endpoints(d, dx)
    np.testing.assert_array_equal(xw, jxw)
    np.testing.assert_array_equal(yw, jyw)
    inner = (slice(5, -5), slice(5, -5))
    assert np.abs(yw[inner] - 0.5).max() < 0.02


def _fp_pair(method, q=None):
    t = np.linspace(0.0, 1.0, 60)
    w = 0.3 * np.sin(4 * np.pi * t)
    grid = (0.0, 1.0, -0.6, 0.6, 48, 64)
    tf, jf = tc.waveformFP(t, w, grid, device=CPU), jc.waveformFP(t, w, grid)
    tf.calcpdf(lambdav=0.04, method=method, q=q)
    jf.calcpdf(lambdav=0.04, method=method, q=q)
    return tf, jf


@pytest.mark.parametrize("q", [None, 2])
def test_calcpdf_fmm_matches_jax(q):
    """calcpdf(method="FMM"): the field bit for bit, the pdf within 1e-12,
    type "FMM"; the density near the exact one away from the interface."""
    tf, jf = _fp_pair("FMM", q)
    assert tf.type == jf.type == "FMM"
    np.testing.assert_array_equal(tf.dfield, jf.dfield)
    np.testing.assert_allclose(tf.pdf, jf.pdf, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tf.pos, jf.pos, rtol=0, atol=1e-15)
    exact, _ = _fp_pair("Enumerate", q)
    assert np.median(np.abs(tf.pdf - exact.pdf)) < 0.05


def test_calcfmm_dist_deriv_matches_jax():
    tf, jf = _fp_pair("FMM")
    got = tc.calcFMM_dist_deriv(tf.dfield, tf.delgrid)
    ref = jc.calcFMM_dist_deriv(jf.dfield, jf.delgrid)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the POT bridges
# ---------------------------------------------------------------------------


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _pair_2d(seed, n=3, zero=False):
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n))
    pos = np.stack([gx, gy], axis=-1)
    f, g = rng.random((n, n)) + 0.1, rng.random((n, n)) + 0.1
    if zero:
        f[0, 0] = g[1, 2] = 0.0
    js, jt = (make_density_2d(jnp.asarray(a), jnp.asarray(pos)) for a in (f, g))
    return js, jt, convert.density_2d(js, device=CPU), convert.density_2d(jt, device=CPU)


def _pair_1d(seed, n=8):
    rng = np.random.default_rng(seed)
    x = jnp.linspace(0, 1, n)
    js, jt = (make_density_1d(jnp.asarray(rng.random(n) + 0.1), x) for _ in range(2))
    to = lambda d: convert.density_1d(d, device=CPU)
    return js, jt, to(js), to(jt)


@pytest.mark.parametrize("distfunc", ["W2", "W1", "matrix"])
def test_wasser_pot_matches_jax_and_linprog(distfunc):
    """The 3x3 point clouds: cost and plan within 1e-10 of JAX's; the cost
    the LP optimum within 1e-10."""
    js, jt, ts, tt = _pair_2d(1)
    dist = distfunc
    if distfunc == "matrix":
        dist = np.random.default_rng(2).random((9, 9))
    got = tpot.wasser_pot(ts, tt, dist, returnplan=True, returndist=True, backend="native")
    ref = jpot.wasser_pot(js, jt, dist, returnplan=True, returndist=True, backend="native")
    for a, b in zip(got, ref):
        assert _rel(a, b) <= 1e-10
    w, _, cost = got
    assert abs(w - _linprog_value(np.asarray(ts.pdf).ravel(), np.asarray(tt.pdf).ravel(),
                                  cost)) < 1e-10


def test_wasser_pot_sub_eps_fingerprint_tails_like_jax():
    """Normalized densities with exp tails below 1e-14 (the solver once
    stranded them): finite, marginals within 1e-11, equal to JAX's."""
    n = 12
    gx, gy = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n))
    pos = np.stack([gx, gy], axis=-1)
    js, jt = (make_density_2d(jnp.asarray(np.exp(-((gx - cx) ** 2 + (gy - cy) ** 2) / 0.02)),
                              jnp.asarray(pos)) for cx, cy in ((0.3, 0.4), (0.6, 0.5)))
    ts, tt = (convert.density_2d(d, device=CPU) for d in (js, jt))
    assert float(ts.pdf.min()) < 1e-14
    w, plan = tpot.wasser_pot(ts, tt, "W2", returnplan=True, backend="native")
    jw, jplan = jpot.wasser_pot(js, jt, "W2", returnplan=True, backend="native")
    assert np.isfinite(w) and w > 0 and _rel(w, jw) <= 1e-10 and _rel(plan, jplan) <= 1e-10
    np.testing.assert_allclose(plan.sum(1), ts.pdf.numpy().ravel(), atol=1e-11)
    np.testing.assert_allclose(plan.sum(0), tt.pdf.numpy().ravel(), atol=1e-11)


@pytest.mark.parametrize("zero,gammas", [(False, (3e-2, 1e-2, 3e-3)), (True, (3e-2,))],
                         ids=["positive", "zero_amplitudes"])
def test_sinkhorn_pot_matches_jax(zero, gammas):
    """Value and plan within 1e-10 of JAX's at each gamma, and on positive
    densities the gap to the EMD falling with gamma; zero amplitudes are
    replaced by the smallest non-zero one, as the reference does."""
    js, jt, ts, tt = _pair_2d(3, zero=zero)
    w_exact = tpot.wasser_pot(ts, tt, "W2", backend="native")[0]
    gaps = []
    for gamma in gammas:
        got = tpot.sinkhorn_pot(ts, tt, "W2", returnplan=True, returndist=True, gamma=gamma,
                                backend="native")
        ref = jpot.sinkhorn_pot(js, jt, "W2", returnplan=True, returndist=True, gamma=gamma,
                                backend="native")
        for a, b in zip(got, ref):
            assert _rel(a, b) <= 1e-10
        gaps.append(abs(got[0] - w_exact))
    assert gaps == sorted(gaps, reverse=True) or zero


@pytest.mark.parametrize("bridge", ["wasser_pot", "sinkhorn_pot"])
def test_pot_backend_and_distfunc_raise_like_jax(bridge):
    js, jt, ts, tt = _pair_1d(4, n=5)
    tfn, jfn = getattr(tpot, bridge), getattr(jpot, bridge)
    assert tpot.HAVE_POT == jpot.HAVE_POT
    if not tpot.HAVE_POT:
        with pytest.raises(terr.POTLibraryError):
            tfn(ts, ts, "W2", backend="pot")
        with pytest.raises(jerr.POTLibraryError):
            jfn(js, js, "W2", backend="pot")
    with pytest.raises(terr.UnknownOTDistanceTypeError):
        tfn(ts, tt, "W12", backend="native")
    with pytest.raises(jerr.UnknownOTDistanceTypeError):
        jfn(js, jt, "W12", backend="native")


def test_default_backend_runs_like_jax():
    """The 'auto' backend (native here) on 1-D densities: W2 of a density
    with itself is 0 and its plan keeps the marginal; the Sinkhorn plan's
    rows too (1e-6)."""
    js, jt, ts, tt = _pair_1d(5, n=6)
    w, plan = tpot.wasser_pot(ts, ts, "W2", returnplan=True)
    assert abs(w) < 1e-10 and _rel(w, jpot.wasser_pot(js, js, "W2")[0]) <= 1e-10
    np.testing.assert_allclose(plan.sum(1), ts.pdf.numpy(), atol=1e-12)
    w, plan = tpot.sinkhorn_pot(ts, tt, "W2", returnplan=True, gamma=1e-2)
    jw = jpot.sinkhorn_pot(js, jt, "W2", gamma=1e-2)[0]
    assert np.isfinite(w) and w >= 0 and _rel(w, jw) <= 1e-10
    np.testing.assert_allclose(plan.sum(1), ts.pdf.numpy(), atol=1e-6)


def test_compat_pot_bridges_match_jax():
    """wasserPOT and sinkhornPOT on OTpdf objects, 1-D and 2-D, within 1e-10
    of the JAX compat's (cost, plan, distance matrix)."""
    rng = np.random.default_rng(6)
    x = np.linspace(0.0, 1.0, 10)
    f, g = rng.random(10) + 0.1, rng.random(10) + 0.1
    gx, gy = np.meshgrid(np.linspace(0, 1, 4), np.linspace(0, 1, 3))
    pos = np.stack([gx, gy], -1)
    f2, g2 = rng.random((3, 4)) + 0.1, rng.random((3, 4)) + 0.1
    for a, b, xs in ((f, g, x), (f2, g2, pos)):
        ts, tt = tc.OTpdf((a, xs), CPU), tc.OTpdf((b, xs), CPU)
        js, jt = jc.OTpdf((a, xs)), jc.OTpdf((b, xs))
        for name, kw in (("wasserPOT", {}), ("sinkhornPOT", {"gamma": 1e-2})):
            got = getattr(tc, name)(ts, tt, "W2", returnplan=True, returndist=True, **kw)
            ref = getattr(jc, name)(js, jt, "W2", returnplan=True, returndist=True, **kw)
            for u, v in zip(got, ref):
                assert _rel(u, v) <= 1e-10, name
