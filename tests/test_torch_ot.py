"""Parity of the port's OT toolbox with the JAX package (CPU, float64):
2-D densities, the reference-style ``wasser`` and plans, marginal and
sliced Wasserstein, the point queries and vertex-NN field, Sinkhorn,
barycenters, the validation oracles and GP noise.

Inputs come from numpy with a seed and go through the JAX function and its
port counterpart on the CPU. The JAX side is jitted (``J``): one small XLA
program per configuration costs far less to compile than eager mode's one
per operation. Bars: closed-form values, gradients,
plans and Jacobians 1e-10 relative to the largest reference entry;
``gaussian_filter`` 1e-12; the Sinkhorns (n <= 16, <= 300 steps) 1e-9;
GP curves from the same normals 1e-10.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveform_ot_torch import convert
from waveform_ot_torch.models import gp_noise as tgp
from waveform_ot_torch.ops import barycenter as tbar
from waveform_ot_torch.ops import cuda_distance
from waveform_ot_torch.ops import errors as terr
from waveform_ot_torch.ops import fingerprint as tfp
from waveform_ot_torch.ops import marginal as tmarg
from waveform_ot_torch.ops import otpdf as tot
from waveform_ot_torch.ops import sinkhorn as tsk
from waveform_ot_torch.ops import sliced as tsl
from waveform_ot_torch.ops import validate as tval
from waveform_ot_tpu.models import gp_noise as jgp
from waveform_ot_tpu.ops import barycenter as jbar
from waveform_ot_tpu.ops import errors as jerr
from waveform_ot_tpu.ops import fingerprint as jfp
from waveform_ot_tpu.ops import marginal as jmarg
from waveform_ot_tpu.ops import otpdf as jot
from waveform_ot_tpu.ops import sinkhorn as jsk
from waveform_ot_tpu.ops import sliced as jsl
from waveform_ot_tpu.ops import validate as jval

# both packages' ops/__init__ bind the name ``wasser`` to the function
jw = importlib.import_module("waveform_ot_tpu.ops.wasser")
tw = importlib.import_module("waveform_ot_torch.ops.wasser")

T = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64).copy())
CLOSED = 1e-10


def J(fn, nums=(), names=()):
    """``fn`` jitted with the given static arguments."""
    return jax.jit(fn, static_argnums=nums, static_argnames=names)


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    """On the CPU the port takes the plain versions: no kernel launches."""
    before = cuda_distance.LAUNCHES
    yield
    assert cuda_distance.LAUNCHES == before


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_rel(got, ref, tol=CLOSED, what=""):
    """max |got - ref| <= tol * max |ref| (elementwise, same shape)."""
    got, ref = np.asarray(_np(got), dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(np.abs(ref).max(initial=0.0), 1e-300)
    err = np.abs(got - ref).max(initial=0.0)
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} * {scale:.3e}"


def assert_lists(got, ref, tol=CLOSED):
    assert len(got) == len(ref)
    for k, (a, b) in enumerate(zip(got, ref)):
        if isinstance(b, list):
            assert_lists(a, b, tol)
        else:
            assert_rel(a, b, tol, what=f"entry {k}")


def _pair_1d(seed, nf=9, ng=11):
    rng = np.random.default_rng(seed)
    f = rng.random(nf) + 0.05
    g = rng.random(ng) + 0.05
    xf = np.sort(rng.random(nf))
    xg = np.sort(rng.random(ng)) + 0.2
    return f, xf, g, xg


def _dens_1d(f, x):
    return (jot.make_density_1d(jnp.asarray(f), jnp.asarray(x)),
            tot.make_density_1d(T(f), T(x)))


def _grid(nx, ny):
    xx, yy = np.meshgrid(np.linspace(0, 1, ny), np.linspace(0, 1, nx))
    return np.dstack([xx, yy])


def _pair_2d(seed, nx=5, ny=6):
    rng = np.random.default_rng(seed)
    pos = _grid(nx, ny)
    f = rng.random((nx, ny)) + 0.05
    g = rng.random((nx, ny)) + 0.05
    js = jot.make_density_2d(jnp.asarray(f), jnp.asarray(pos))
    jt = jot.make_density_2d(jnp.asarray(g), jnp.asarray(pos))
    return js, jt, convert.density_2d(js, device="cpu"), convert.density_2d(jt, device="cpu")


# ---------------------------------------------------------------------------
# errors, densities
# ---------------------------------------------------------------------------


def test_error_spellings_and_messages():
    for name in ("Error", "POTlibraryError", "WaveformPFderivError", "FMMlibraryError"):
        assert hasattr(jerr, name) and hasattr(terr, name)
    assert terr.Error is terr.OTError
    assert terr.POTlibraryError is terr.POTLibraryError
    assert terr.WaveformPFderivError is terr.WaveformFPderivError
    assert terr.FMMlibraryError is terr.FMMLibraryError
    assert str(terr.FingerprintMethodError("x")) == str(jerr.FingerprintMethodError("x"))


def test_density_2d_and_marginals_match_jax():
    js, jt, ts, tt = _pair_2d(1)
    rng = np.random.default_rng(1)
    f = rng.random((5, 6)) + 0.05
    pos = _grid(5, 6)
    jd = jot.make_density(jnp.asarray(f), jnp.asarray(pos))
    td = tot.make_density(T(f), T(pos))
    assert isinstance(td, tot.Density2D) and (td.nx, td.ny, td.n) == (5, 6, 30)
    for name in ("amp", "pdf", "x"):
        assert_rel(getattr(td, name), getattr(jd, name), 1e-15, name)
    for jm, tm in zip(jot.marginals(jd), tot.marginals(td)):
        for name in ("amp", "pdf", "x", "cdf"):
            assert_rel(getattr(tm, name), getattr(jm, name), 1e-15, name)
    assert isinstance(tot.make_density(T(f[0]), T(pos[0, :, 0])), tot.Density1D)


@pytest.mark.parametrize("f,x,err", [
    (np.array([0.2, -0.1, 0.5]), np.arange(3.0), "PDFSignError"),
    (np.ones(3), np.arange(4.0), "PDFShapeError"),
    (np.ones((3, 4)), np.zeros((3, 5, 2)), "PDFShapeError"),
])
def test_validate_density_raises_like_jax(f, x, err):
    with pytest.raises(getattr(jerr, err)):
        jot.validate_density(f, x)
    with pytest.raises(getattr(terr, err)):
        tot.validate_density(T(f), T(x))


# ---------------------------------------------------------------------------
# wasser, plans, ties
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("distfunc", ["W1", "W2", "W12"])
@pytest.mark.parametrize("derivatives", [False, True])
def test_wasser_closed_forms_match_jax(distfunc, derivatives):
    f, xf, g, xg = _pair_1d(2)
    (js, ts), (jt, tt) = _dens_1d(f, xf), _dens_1d(g, xg)
    ref = J(jw.wasser, names=("distfunc", "derivatives"))(js, jt, distfunc=distfunc,
                                                          derivatives=derivatives)
    assert_lists(tw.wasser(ts, tt, distfunc, derivatives=derivatives), ref)


@pytest.mark.parametrize("form", ["array", "callable", "tuple"])
@pytest.mark.parametrize("derivatives", [False, True])
def test_wasser_user_cost_forms_match_jax(form, derivatives):
    f, xf, g, xg = _pair_1d(3)
    (js, ts), (jt, tt) = _dens_1d(f, xf), _dens_1d(g, xg)
    cost = np.abs(xf[:, None] - xg[None, :]) ** 1.5
    spec = {"array": cost, "callable": lambda i, j: cost[i, j],
            "tuple": (None, None, cost)}[form]
    ref = jw.wasser(js, jt, spec, derivatives=derivatives)
    got = tw.wasser(ts, tt, spec, derivatives=derivatives)
    assert_lists(got, ref)
    if derivatives:
        assert got[2] == 0.0 == ref[2]


def test_wasser_errors_match_jax():
    f, xf, g, xg = _pair_1d(4)
    (js, ts), (jt, tt) = _dens_1d(f, xf), _dens_1d(g, xg)
    for jexc, texc, spec in ((jerr.DistfuncShapeError, terr.DistfuncShapeError, np.zeros((3, 4))),
                             (jerr.UnknownOTDistanceTypeError,
                              terr.UnknownOTDistanceTypeError, "W3")):
        with pytest.raises(jexc):
            jw.wasser(js, jt, spec)
        with pytest.raises(texc):
            tw.wasser(ts, tt, spec)


@pytest.mark.parametrize("p", [1, 2])
def test_autodiff_and_cost_forms_match_jax(p):
    """Value and amplitude gradient of the plain-autograd oracle and of the
    user-cost form (a batch of two rows against two JAX calls)."""
    rows = [_pair_1d(10 + k) for k in range(2)]
    tf, txf, tg, txg = (torch.stack([T(r[i]) for r in rows]) for i in range(4))
    tf.requires_grad_()
    got = tw.wasserstein_1d_autodiff(tf, txf, tg, txg, p)
    (gf,) = torch.autograd.grad(got.sum(), tf)
    cost = np.abs(rows[0][1][:, None] - rows[0][3][None, :]) ** p
    tf2 = T(rows[0][0]).requires_grad_()
    wc = tw.wasserstein_1d_cost(tf2, T(rows[0][2]), T(cost))
    (gc,) = torch.autograd.grad(wc, tf2)
    for b, (f, xf, g, xg) in enumerate(rows):
        fn = lambda ff: jw.wasserstein_1d_autodiff(ff, jnp.asarray(xf), jnp.asarray(g),
                                                    jnp.asarray(xg), p)
        jv, jg = J(jax.value_and_grad(fn))(jnp.asarray(f))
        assert_rel(got[b], jv)
        assert_rel(gf[b], jg)
    jv, jg = J(jax.value_and_grad(lambda ff: jw.wasserstein_1d_cost(
        ff, jnp.asarray(rows[0][2]), jnp.asarray(cost))))(jnp.asarray(rows[0][0]))
    assert_rel(wc, jv)
    assert_rel(gc, jg)


@pytest.mark.parametrize("nf,ng", [(7, 7), (6, 9), (10, 4)])
def test_transport_plan_and_jacobian_match_jax(nf, ng):
    """Plans and plan Jacobians, unbatched and as rows of one batch."""
    rows = [_pair_1d(20 + k, nf, ng) for k in range(2)]
    batch = [torch.stack([T(r[i]) for r in rows]) for i in range(4)]
    plans = tw.transport_plan_1d(*batch)
    jacs = tw.transport_plan_jacobian(*batch)
    for b, r in enumerate(rows):
        jargs = [jnp.asarray(a) for a in r]
        jh = J(jw.transport_plan_1d)(*jargs)
        jj = J(jw.transport_plan_jacobian)(*jargs)
        assert_rel(tw.transport_plan_1d(*(T(a) for a in r)), jh)
        assert_rel(tw.transport_plan_jacobian(*(T(a) for a in r)), jj)
        assert_rel(plans[b], jh)
        assert_rel(jacs[b], jj)


def test_common_cdf_tie_raises_in_both():
    """CDFs (1/4, 1/2, 1) and (1/2, 1) share 1/2 exactly in any summation
    order; random amplitudes share none."""
    f, g = np.array([1.0, 1.0, 2.0]), np.array([2.0, 2.0])
    with pytest.raises(jerr.TargetSourceCDFError):
        jw.check_common_cdf(f, g)
    with pytest.raises(terr.TargetSourceCDFError):
        tw.check_common_cdf(T(f), T(g))
    np.testing.assert_array_equal(tw.common_cdf_mask(T(f), T(g)).numpy(),
                                  np.asarray(jw.common_cdf_mask(f, g)))
    a, _, b, _ = _pair_1d(5)
    tw.check_common_cdf(T(a), T(b))
    assert not tw.common_cdf_mask(T(a), T(b)).any()


# ---------------------------------------------------------------------------
# marginal Wasserstein
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("distfunc", ["W2", "W1"])
@pytest.mark.parametrize("derivatives", [False, True])
@pytest.mark.parametrize("returnmargW", [False, True])
def test_marg_wasserstein_structures_match_jax(distfunc, derivatives, returnmargW):
    js, jt, ts, tt = _pair_2d(6, 6, 8)
    kw = dict(distfunc=distfunc, derivatives=derivatives, returnmargW=returnmargW)
    ref = J(jmarg.marg_wasserstein, names=tuple(kw))(js, jt, **kw)
    assert_lists(tmarg.marg_wasserstein(ts, tt, **kw), ref)


def test_marg_wasserstein_w12_raises_in_both():
    js, jt, ts, tt = _pair_2d(7)
    with pytest.raises(jerr.MarginalWassersteinError):
        jmarg.marg_wasserstein(js, jt, "W12")
    with pytest.raises(terr.MarginalWassersteinError):
        tmarg.marg_wasserstein(ts, tt, "W12")


# ---------------------------------------------------------------------------
# fingerprint utilities
# ---------------------------------------------------------------------------


def _polyline(seed, nt=23):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, nt)
    return np.stack([t, 0.5 + 0.3 * np.sin(7 * t) + 0.03 * rng.standard_normal(nt)], 1)


def test_window_from_waveform_and_fpbox_grids_match_jax():
    rng = np.random.default_rng(8)
    t = np.linspace(-0.4, 2.1, 31)
    w = np.sin(3 * t) + 0.1 * rng.standard_normal(31)
    for pad in (0.3, 0.2):
        jwin = jfp.window_from_waveform(jnp.asarray(t), jnp.asarray(w), pad=pad)
        twin = tfp.window_from_waveform(T(t), T(w), pad=pad)
        for a, b in zip(twin, jwin):
            assert_rel(a, b, 1e-15)
    # batched rows take their own windows
    tw2 = tfp.window_from_waveform(T(t), torch.stack([T(w), 2 * T(w)]))
    row = tfp.window_from_waveform(T(t), 2 * T(w))
    assert tw2.u1.shape == (2,)
    for a, b in zip(tw2, row):
        assert float(a.reshape(-1)[-1]) == float(b)
    box = (-0.2, 1.9, float(w.min()) - 0.1, float(w.max()) + 0.2)
    spec = tfp.FingerprintSpec(nu=17, ntg=29)
    for theta in (None, 30.0):
        jwin = jfp.make_window(t[0], t[-1], -2.0, 2.0, theta=theta)
        twin = tfp.make_window(t[0], t[-1], -2.0, 2.0, theta=theta, device="cpu")
        jtg, jug = jfp.grid_axes(jnp.asarray(t), jwin, spec, fpbox=box)
        ttg, tug = tfp.grid_axes(T(t), twin, spec, fpbox=box)
        assert_rel(ttg, jtg, 1e-14)
        assert_rel(tug, jug, 1e-14)
        jpdf, _ = J(jfp.fingerprint_density, nums=(3,), names=("impl",))(
            jnp.asarray(t), jnp.asarray(w), jwin, spec, fpbox=box, impl="jnp")
        tpdf, _ = tfp.fingerprint_density(T(t), T(w)[None], twin, spec, fpbox=box)
        assert_rel(tpdf[0], jpdf, 1e-12)


def test_point_distance_matches_jax(monkeypatch):
    monkeypatch.setattr(tfp, "_PAIRS_PER_CHUNK", 200)     # many chunks of points
    verts = _polyline(9)
    pts = np.random.default_rng(9).random((57, 2))
    ref = J(jfp.point_distance)(jnp.asarray(verts), jnp.asarray(pts))
    assert_rel(tfp.point_distance(T(verts), T(pts)), ref)
    batched = tfp.point_distance(torch.stack([T(verts)] * 2), torch.stack([T(pts)] * 2))
    assert_rel(batched[1], ref)


@pytest.mark.parametrize("chunk", [None, 300])
def test_distance_field_nn_matches_jax(monkeypatch, chunk):
    """d, lam and dvec to 1e-10, the winning segment exactly equal."""
    if chunk is not None:
        monkeypatch.setattr(tfp, "_PAIRS_PER_CHUNK", chunk)
    verts = np.stack([_polyline(10), _polyline(11)])
    tg = np.linspace(0.0, 1.0, 19)
    ug = np.linspace(0.0, 1.0, 13)
    fld = tfp.distance_field_nn(T(verts), T(np.stack([tg] * 2)), T(np.stack([ug] * 2)))
    assert fld.iclose.dtype == torch.int32
    exact = tfp.distance_field_torch(T(verts), T(np.stack([tg] * 2)), T(np.stack([ug] * 2)))
    pts = T(np.stack(np.meshgrid(tg, ug), -1).reshape(-1, 2))
    for b in range(2):
        ref = J(jfp.distance_field_nn)(jnp.asarray(verts[b]), jnp.asarray(tg), jnp.asarray(ug))
        np.testing.assert_array_equal(fld.iclose[b].numpy(), np.asarray(ref.iclose))
        for name in ("d", "lam", "dvec"):
            assert_rel(getattr(fld, name)[b], getattr(ref, name), what=name)
        # it parts from the exact field only where the exact winner is not
        # one of the nearest vertex's two segments, and never undershoots it
        ivert = tfp.nearest_vertex(T(verts[b]), pts).clamp(0, verts.shape[1] - 2)
        win = exact.iclose[b].reshape(-1).long()
        adjacent = (win == ivert) | (win == (ivert - 1).clamp(min=0))
        gap = (fld.d[b] - exact.d[b]).reshape(-1)
        assert bool((gap[adjacent].abs() <= 1e-15).all()) and bool((gap >= -1e-15).all())


def test_first_minimum_at_exact_ties():
    """A rectangle's grid points on its axes of symmetry are exactly as far
    from two segments (and two vertices): both packages keep the first."""
    box = np.array([[0.0, 0.0], [0.0, 2.0], [4.0, 2.0], [4.0, 0.0], [0.0, 0.0]])
    tg, ug = np.linspace(0.0, 4.0, 9), np.linspace(0.0, 2.0, 5)
    fld = tfp.distance_field_nn(T(box)[None], T(tg)[None], T(ug)[None])
    ref = J(jfp.distance_field_nn)(jnp.asarray(box), jnp.asarray(tg), jnp.asarray(ug))
    np.testing.assert_array_equal(fld.iclose[0].numpy(), np.asarray(ref.iclose))
    assert_rel(fld.d[0], ref.d)
    pts = np.stack(np.meshgrid(tg, ug), -1).reshape(-1, 2)
    dsq, iclose, _ = tfp.nearest_segment(T(box), T(pts))
    dv = pts[:, None, :] - box[None, :-1, :]
    np.testing.assert_array_equal(tfp.nearest_vertex(T(box[:-1]), T(pts)).numpy(),
                                  np.argmin((dv * dv).sum(-1), axis=1))
    x0, c = box[:-1], box[1:] - box[:-1]
    b = pts[:, None, :] - x0[None]
    lam = np.clip((b * c).sum(-1) / (c * c).sum(-1), 0, 1)
    ds = b - c * lam[..., None]
    np.testing.assert_array_equal(iclose.numpy(), np.argmin((ds * ds).sum(-1), axis=1))


# ---------------------------------------------------------------------------
# sliced Wasserstein
# ---------------------------------------------------------------------------


def test_projections_match_jax():
    js, _, ts, _ = _pair_2d(12)
    assert_rel(tsl.projection_angles(7, device="cpu"), jsl.projection_angles(7), 1e-15)
    jp = J(jsl.project_sliced, nums=(1, 2))(js, 5, (0.5, 0.5))
    tp = tsl.project_sliced(ts, 5, (0.5, 0.5))
    np.testing.assert_array_equal(tp.psorted.numpy(), np.asarray(jp.psorted))
    for name in ("f_sorted", "x_sorted", "angles"):
        assert_rel(getattr(tp, name), getattr(jp, name), 1e-14, name)
    for jexc, fn in ((jerr.SlicedWassersteinError, jsl.projection_angles),
                     (terr.SlicedWassersteinError,
                      lambda n: tsl.projection_angles(n, device="cpu"))):
        with pytest.raises(jexc):
            fn(0)


@pytest.mark.parametrize("distfunc", ["W2", "W1"])
@pytest.mark.parametrize("derivatives,returnplan", [(False, False), (True, False),
                                                   (False, True), (True, True)])
def test_sliced_wasserstein_matches_jax(distfunc, derivatives, returnplan):
    js, jt, ts, tt = _pair_2d(13, 4, 5)
    kw = dict(distfunc=distfunc, derivatives=derivatives, returnplan=returnplan,
              origin=(0.4, 0.6))
    got = tsl.sliced_wasserstein(ts, tt, 6, **kw)
    kw["returnplan"] = False
    ref = J(jsl.sliced_wasserstein, nums=(2,), names=tuple(kw))(js, jt, 6, **kw)
    if returnplan:
        # The reference plan slice by slice in eager mode: under jax.jit on
        # the CPU the JAX package's transport_plan_1d gives other plans for
        # some of these slices (up to 0.045 off, the same marginals), while
        # its eager mode and the port agree.
        src = J(jsl.project_sliced, nums=(1, 2))(js, 6, (0.4, 0.6))
        tgt = J(jsl.project_sliced, nums=(1, 2))(jt, 6, (0.4, 0.6))
        h = np.zeros((js.n, js.n))
        for k in range(6):
            hk = jw.transport_plan_1d(src.f_sorted[k], src.x_sorted[k], tgt.f_sorted[k],
                                      tgt.x_sorted[k])
            h[np.ix_(np.asarray(src.psorted[k]), np.asarray(tgt.psorted[k]))] += np.asarray(hk)
        ref = list(ref) + [h / 6]
    assert_lists(got, ref)


def test_sliced_value_from_converted_projections():
    """The JAX package's SlicedProjections, carried over by convert, serve
    the port's value function as they serve the JAX one."""
    js, jt, ts, _ = _pair_2d(14)
    jpr = J(jsl.project_sliced, nums=(1, 2))(jt, 4, (0.5, 0.5))
    tpr = convert.sliced_projections(jpr, device="cpu")
    assert tpr.psorted.dtype == torch.int64
    u = T(np.asarray(js.pdf * js.amp)).requires_grad_()
    tv = tsl.sliced_wasserstein_value(u, ts.x, tpr, 4)
    (tg,) = torch.autograd.grad(tv, u)
    jv, jg = J(jax.value_and_grad(lambda uu: jsl.sliced_wasserstein_value(
        uu, js.x, jpr, 4)))(js.pdf * js.amp)
    assert_rel(tv, jv)
    assert_rel(tg, jg)


def test_sliced_plan_jacobian_and_plan_cost_match_jax():
    js, jt, ts, tt = _pair_2d(15, 3, 4)
    assert_rel(tsl.sliced_plan_jacobian(ts, tt, 3),
               J(jsl.sliced_plan_jacobian, nums=(2,))(js, jt, 3))
    pos = np.asarray(js.x).reshape(-1, 2)
    cost = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    assert_rel(tsl.sliced_wasserstein_plan_cost(ts, tt, 5, T(cost)),
               J(jsl.sliced_wasserstein_plan_cost, nums=(2,))(js, jt, 5, jnp.asarray(cost)))


# ---------------------------------------------------------------------------
# Sinkhorn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,sigma", [((20, 24), 1.5), ((9, 7), 0.3), ((11,), 2.0),
                                         ((6, 5), 0.005)])
def test_gaussian_filter_matches_jax(shape, sigma):
    """Within 1e-12; sigma 0.005 px (the reference's default gamma) has
    radius 0, an identity blur in both."""
    img = np.random.default_rng(16).random(shape)
    ref = J(jsk.gaussian_filter, nums=(1,))(jnp.asarray(img), sigma)
    assert_rel(tsk.gaussian_filter(T(img), sigma), ref, 1e-12)
    if sigma == 0.005:
        np.testing.assert_array_equal(tsk.gaussian_filter(T(img), sigma).numpy(), img)


def test_sinkhorn_gaussian_matches_jax():
    rng = np.random.default_rng(17)
    mu0 = rng.random((8, 9)) + 0.1
    mu1 = rng.random((8, 9)) + 0.1
    mu0, mu1 = mu0 / mu0.sum(), mu1 / mu1.sum()
    jd, jv, jw_ = J(jsk.sinkhorn_gaussian, names=("gamma", "iters"))(
        jnp.asarray(mu0), jnp.asarray(mu1), gamma=1.2, iters=120)
    td, tv, tw_ = tsk.sinkhorn_gaussian(T(mu0), T(mu1), gamma=1.2, iters=120)
    for a, b in ((td, jd), (tv, jv), (tw_, jw_)):
        assert_rel(a, b, 1e-9)


@pytest.mark.parametrize("solver,gamma,iters", [("sinkhorn_dense", 2e-3, 300),
                                                ("sinkhorn_log", 2e-3, 300),
                                                ("sinkhorn_log", 5e-4, 200)])
def test_dense_and_log_sinkhorn_match_jax(solver, gamma, iters):
    """1-D at n = 16 and 2-D on a 3 x 4 grid; plan orientation as the JAX
    package pins it."""
    f, _, g, _ = _pair_1d(18, 16, 16)
    x = np.linspace(0.0, 1.0, 16)
    (js, ts), (jt, tt) = _dens_1d(f, x), _dens_1d(g, x)
    j2s, j2t, t2s, t2t = _pair_2d(19, 3, 4)
    for (a, b), (c, d) in (((js, jt), (ts, tt)), ((j2s, j2t), (t2s, t2t))):
        jd, jpi = J(getattr(jsk, solver), names=("gamma", "iters"))(a, b, gamma=gamma,
                                                                    iters=iters)
        td, tpi = getattr(tsk, solver)(c, d, gamma=gamma, iters=iters)
        assert_rel(td, jd, 1e-9)
        assert_rel(tpi, jpi, 1e-9)


# ---------------------------------------------------------------------------
# barycenters
# ---------------------------------------------------------------------------


def test_interp_matches_jnp_interp():
    """Repeated xp (a flat CDF run), points outside both ends, exact hits."""
    xp = np.array([0.0, 0.1, 0.1, 0.35, 0.35, 0.35, 0.8, 1.0])
    fp = np.array([-1.0, 0.5, 0.7, 0.9, 1.4, 2.0, 2.5, 3.0])
    x = np.concatenate([np.linspace(-0.2, 1.2, 41), xp])
    ref = jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp))
    assert_rel(tbar.interp(T(x), T(xp), T(fp)), ref, 1e-15)


@pytest.mark.parametrize("with_zero", [False, True])
def test_barycenters_match_jax(with_zero):
    """Point-mass (both return forms) and continuous paths; ``with_zero``
    gives the source a zero amplitude, a repeated CDF value."""
    f, _, g, _ = _pair_1d(20, 12, 12)
    if with_zero:
        f[4] = 0.0
    x = np.linspace(0.0, 1.0, 12)
    (js, ts), (jt, tt) = _dens_1d(f, x), _dens_1d(g, x + 0.3)
    weights = np.linspace(0.0, 1.0, 5)
    jxs, jm = J(jbar.barycenter_pointmass)(js, jt, weights)
    txs, tm = tbar.barycenter_pointmass(ts, tt, weights)
    assert_rel(txs, jxs)
    assert_rel(tm, jm)
    for got, ref in zip(tbar.barycenter_pointmass(ts, tt, weights, include_endpoints=True),
                        J(jbar.barycenter_pointmass, names=("include_endpoints",))(
                            js, jt, weights, include_endpoints=True)):
        assert_lists(list(got), list(ref))
    jc, jt_ = J(jbar.barycenter_continuous, names=("npoints", "return_taxis"))(
        js, jt, weights, npoints=2001, return_taxis=True)
    tc, tt_ = tbar.barycenter_continuous(ts, tt, weights, npoints=2001, return_taxis=True)
    assert_rel(tt_, jt_, 1e-15)
    assert_rel(tc[:, 0], jc[:, 0])
    assert_rel(tc[:, 1], jc[:, 1])


# ---------------------------------------------------------------------------
# validation oracles, GP noise, convert
# ---------------------------------------------------------------------------


def test_validate_copy_matches_jax_package():
    f, xf, g, xg = _pair_1d(21, 6, 7)
    for name, args in (("wasserstein_numint", (f, xf, g, xg)),
                       ("cost_matrix", (xf, xg, 1)),
                       ("build_linprog", (f, xf, g, xg, 2)),
                       ("wasserstein_linprog", (f, xf, g, xg, 2)),
                       ("linprog_plan", (f, xf, g, xg, 2)),
                       ("monge_1d", (f, g))):
        ref, got = getattr(jval, name)(*args), getattr(tval, name)(*args)
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    w = tval.wasserstein_linprog(f, xf, g, xg, 2)
    ok, plan = tval.find_plan_from_w(f, xf, g, xg, w, 2)
    assert ok and np.abs(plan.sum(1) - f / f.sum()).max() < 1e-6
    fn = lambda v: float(np.sum(np.sin(v) * v))
    an, fd = tval.check_grad(fn, lambda v: np.cos(v) * v + np.sin(v), np.linspace(0, 1, 5))
    np.testing.assert_allclose(an, fd, atol=1e-7)


def test_central_difference_matches_jax():
    """ops.validate.central_difference of each package's W2 as a function of
    the source amplitudes: the port's differences of the port's W2 against
    JAX's of JAX's, 1e-8 of the largest entry (each value is the other's
    within ~1e-16, and eps 1e-6 scales that by 5e5)."""
    f, xf, g, xg = _pair_1d(12)
    tfn = lambda a: float(tw.wasserstein_1d(T(a)[None], T(xf)[None], T(g)[None], T(xg)[None],
                                            2)[0])
    jw2 = J(lambda a: jw.wasserstein_1d(a, jnp.asarray(xf), jnp.asarray(g), jnp.asarray(xg), 2))
    jfn = lambda a: float(jw2(jnp.asarray(a)))
    assert_rel(tval.central_difference(tfn, f), jval.central_difference(jfn, f), 1e-8)


@pytest.mark.parametrize("kernel", ["sqExp", "matern0", "matern1", "matern2", "periodic"])
def test_gp_covariance_matches_jax(kernel):
    xx = np.linspace(-1.0, 1.0, 17)
    ref = J(jgp.covariance, names=("kernel",))(jnp.asarray(xx), kernel=jgp.KERNELS[kernel],
                                               s1=0.3, rho=0.25)
    assert_rel(tgp.covariance(T(xx), kernel=tgp.KERNELS[kernel], s1=0.3, rho=0.25), ref)


@pytest.mark.parametrize("name", ["sq_exp", "matern0", "matern1", "matern2"])
def test_gp_kernel_functions_match_jax(name):
    """The kernel functions themselves, k(x, x') over a broadcast grid that
    holds x == x' (the Matern kernels' |x - x'| = 0), 1e-14 relative."""
    x = np.random.default_rng(8).uniform(-1.0, 1.0, 9)
    xx, xp = np.meshgrid(x, np.append(x[:4], 0.3), indexing="ij")
    ref = getattr(jgp, name)(jnp.asarray(xx), jnp.asarray(xp), 0.3, 0.25)
    assert_rel(getattr(tgp, name)(T(xx), T(xp), 0.3, 0.25), ref, 1e-14, what=name)


@pytest.mark.parametrize("kernel,nx", [("matern0", 40), ("matern2", 25), ("sqExp", 12)])
def test_gp_curve_from_same_normals_matches_jax(kernel, nx):
    """The port draws z from its generator; L z with the JAX package's own
    covariance and the same z agrees within 1e-10 (the JAX draw itself
    keys jax.random and differs for any seed)."""
    kern = tgp.KERNELS[kernel]
    x, y = tgp.create_curve(torch.Generator().manual_seed(5), nx=nx, corr=0.3, kernel=kern,
                            device="cpu")
    z = torch.randn(nx, generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    def curve(z):
        k = jgp.covariance(jnp.linspace(-1.0, 1.0, nx), kernel=jgp.KERNELS[kernel], s1=0.2,
                           rho=0.3)
        return jnp.linalg.cholesky(k + 1e-10 * jnp.eye(nx)) @ z

    assert_rel(y, J(curve)(jnp.asarray(z.numpy())))
    assert_rel(x, jnp.linspace(-3.0, 3.0, nx), 1e-15)
    noise = tgp.correlated_noise(torch.Generator().manual_seed(5), nx, 0.7, 0.3, device="cpu")
    assert float(noise.std(correction=0)) == pytest.approx(0.7, rel=1e-12)
    cx, cy = tgp.Createcurve(False, nx=nx, device="cpu")
    assert cy.shape == (nx,) and bool(torch.isfinite(cy).all())


def test_convert_densities_round_trip():
    f, xf, _, _ = _pair_1d(22)
    jd = jot.make_density_1d(jnp.asarray(f), jnp.asarray(xf))
    td = convert.density_1d(jd, device="cpu")
    assert isinstance(td, tot.Density1D) and td.pdf.shape == (len(f),)
    for name in ("amp", "pdf", "x", "cdf"):
        np.testing.assert_array_equal(getattr(td, name).numpy(), np.asarray(getattr(jd, name)))
    js, _, ts, _ = _pair_2d(23)
    assert isinstance(ts, tot.Density2D)
    np.testing.assert_array_equal(ts.x.numpy(), np.asarray(js.x))
