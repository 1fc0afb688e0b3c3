"""The port's layered f-k physics against the JAX package (CPU, float64).

Three stations, nt = 33, nk = 32, kmax 1.5: the Fukuoka six-layer model for
the seismograms, a three-layer crust for the loc/CMT objective and the
depth-amortized scan. The problem is built by the port and carried to the
JAX package as numpy arrays; every JAX reference comes from the one
module-scoped fixture, through two jitted programs. Each test states its
tolerance.

The parity tests damp at alpha = 0.1, not the production 0.023. At omega =
0 the synthesis frequency is i alpha, the P-SV eigenbasis degenerates and
the stack algebra cancels digits as 1/alpha^2 grows: at 0.023 the JAX
package's surface operator on that lane is off by 6e-8 (source at 12 km)
to 1e-4 (3 km) against a long-double solve, and the port's by the same
amounts (complex products rounded in another order), so the two part by up
to 5e-4 of the seismograms' peak there. test_omega0_lane_as_accurate_as_jax
holds that lane at 0.023; at 0.1 the rest of the chain is held at 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special

import ld_surface
from waveform_ot_torch import convert
from waveform_ot_torch import inversion as ti
from waveform_ot_torch import models as tm
from waveform_ot_torch.models import layered as TL
from waveform_ot_torch.ops import cuda_distance
from waveform_ot_tpu import inversion as ji
from waveform_ot_tpu import models as jm
from waveform_ot_tpu.inversion.pipeline import Targets as JTargets
from waveform_ot_tpu.models import layered as JL
from waveform_ot_tpu.ops.fingerprint import Window as JWindow
from waveform_ot_tpu.ops.otpdf import Density1D as JDensity1D

NT, NK, KMAX = 33, 32, 1.5
ALPHA = 0.1                  # the damping of the parity tests (module note)
CPU, F64 = torch.device("cpu"), torch.float64
ST_X, ST_Y = [10.0, 30.0, -15.0], [-75.0, -50.0, 30.0]
M_GEN = np.array([[0.3, 0.5, 1.0], [0.5, -0.2, 0.7], [1.0, 0.7, -0.1]])
SRC = (2.0, -1.5, 12.0)
THREE_LAYER = [(2.0, 5.15, 2.85, 2.5), (16.0, 6.0, 3.46, 2.7), (0.0, 7.7, 4.3, 3.3)]
LOC = np.array([2.0, -1.5, 12.0])
# loc/CMT models (x, y, z, 6 upper-triangle M entries) and the scan's nodes
CMT_MODELS = np.array([[6.0, -4.5, 14.0], [-1.0, 1.5, 9.0]])
ZS, XY = np.array([8.0, 15.0]), np.array([[-4.0, 3.0], [5.0, -2.0]])
BESSEL_X = np.linspace(0.0, 60.0, 601)
SQRT_RE, SQRT_IM = np.array([-4.0, -4.0, -1.0, 0.0, 2.5, -3.0]), np.array(
    [0.0, -0.0, -0.0, 0.0, -0.0, 1e-3])
# bars against JAX at ALPHA, with the deviations measured on the CPU
SEIS_TOL = 1e-9              # of the peak; measured 5.9e-11
VALUE_RTOL = 1e-9            # measured 4.0e-10 (scan node at 8 km), 3.5e-11
GRAD_TOL = 1e-7              # of max |g| per model; measured 2.2e-9
LANE_DEPTHS = (3.0, 8.0, 12.0)


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    before = cuda_distance.LAUNCHES
    yield
    assert cuda_distance.LAUNCHES == before


def _stations(x=ST_X, y=ST_Y):
    return tm.StationSet(x=torch.tensor(x, dtype=F64), y=torch.tensor(y, dtype=F64))


def _jax_tree(tree):
    """The JAX package's NamedTuple of the same name, from the port's."""
    classes = {c.__name__: c for c in (ji.LocCMTProblem, JWindow, JTargets, JDensity1D,
                                       jm.StationSet, jm.MediumConfig)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return classes[type(tree).__name__](*(_jax_tree(v) for v in tree))
    return jnp.asarray(tree.numpy()) if isinstance(tree, torch.Tensor) else tree


@pytest.fixture(scope="module")
def setup():
    """The port's three-layer loc/CMT problem (3 stations on a 60 km circle,
    observed data from the port's forward at LOC with 0.002 max|s| noise
    from default_rng(0), 15x33 grids, lambda 0.04, W2) and every JAX
    reference."""
    ang = np.linspace(0, 2 * np.pi, 3, endpoint=False)
    st = _stations(60.0 * np.cos(ang), 60.0 * np.sin(ang))
    mxyz = tm.moment_tensor_from_sdr(30.0, 60.0, 45.0, m0=5.0e6, device=CPU)
    model = TL.layered_model_from_table(THREE_LAYER, device=CPU)
    kw = dict(model=model, nt=NT, dt=1.0, nk=NK, kmax=KMAX, alpha_damp=ALPHA)
    fwd = TL.make_layered_forward(st, **kw)
    s = fwd(*torch.tensor(LOC), mxyz)
    rng = np.random.default_rng(0)
    obs = s + 0.002 * s.abs().max() * torch.tensor(rng.standard_normal(tuple(s.shape)))
    cfg = ti.TraceConfig(nu=15, ntg=NT, lambdav=0.04, q=None, p=2)
    prob = ti.build_loc_cmt_problem(torch.arange(NT, dtype=F64), obs, st, cfg,
                                    mxyz_fixed=mxyz)
    port = dict(st=st, model=model, kw=kw, fwd=fwd, cfg=cfg, prob=prob)

    jprob = _jax_tree(prob)
    jcfg = ji.TraceConfig(nu=15, ntg=NT, lambdav=0.04, q=None, p=2)
    jkw = dict(model=JL.layered_model_from_table(THREE_LAYER), nt=NT, dt=1.0, nk=NK,
               kmax=KMAX, alpha_damp=ALPHA)
    jfwd = JL.make_layered_forward(jprob.stations, **jkw)
    jstages = JL.make_layered_stages(**jkw)
    cmt = ji.InvOptions(loc=True, cmt=True)
    jst = jm.StationSet(x=jnp.asarray(ST_X), y=jnp.asarray(ST_Y))

    plan = TL._synth_plan(NT, 1.0, 2, ("clp_step", 0.05, 0.2), NK, KMAX, np.inf)

    @jax.jit
    def physics(x, re, im, p, zs):
        j, dj = jax.jvp(JL.bessel_j0123, (x,), (jnp.ones_like(x),))
        u = JL.layered_seismograms(p[0], p[1], p[2], jnp.asarray(M_GEN), jst,
                                   model=JL.fukuoka_model(), nt=NT, nk=NK, kmax=KMAX,
                                   alpha_damp=ALPHA)[1]
        ops = jax.vmap(lambda z: JL._band_operators(
            JL.fukuoka_model(), z, plan.k_np, plan.bands[0].om[:2], "f64", 0.023, True))(zs)
        return j, dj, JL._csqrt_pair(re, im), u, ops

    @jax.jit
    def objective(ms, zs, xy, pr):
        vg = ji.loc_cmt_value_and_grad(ms, pr, cmt, jcfg, forward=jfwd, impl="jnp")
        grid = ji.layered_misfit_grid(zs, xy, pr, ji.InvOptions(), jcfg, jstages,
                                      impl="jnp", z_loop="unroll")
        return vg, grid

    j, dj, sq, u, ops = physics(jnp.asarray(BESSEL_X), jnp.asarray(SQRT_RE),
                                jnp.asarray(SQRT_IM), jnp.asarray(SRC),
                                jnp.asarray(LANE_DEPTHS))
    (v, g), (gv, gg) = objective(jnp.asarray(_cmt_models(prob)[0]), jnp.asarray(ZS),
                                 jnp.asarray(XY), jprob)
    ref = dict(bessel=np.asarray(j), dbessel=np.asarray(dj),
               sqrt=np.asarray(sq[0]) + 1j * np.asarray(sq[1]), seis=np.asarray(u),
               value=np.asarray(v), grad=np.asarray(g), grid_value=np.asarray(gv),
               grid_grad=np.asarray(gg),
               ops={f: np.asarray(getattr(ops, f).re) + 1j * np.asarray(getattr(ops, f).im)
                    for f in TL._Reverb._fields[:4]})
    return port, ref


def _cmt_models(prob) -> np.ndarray:
    """CMT_MODELS with the moment tensor's upper triangle scaled 1.1 and 0.9."""
    upper = prob.mxyz_fixed.numpy()[np.triu_indices(3)]
    return np.concatenate([CMT_MODELS, np.stack([1.1 * upper, 0.9 * upper])], 1)


def _assert_grads(g, ref, tol):
    for gl, rl in zip(np.asarray(g), np.asarray(ref)):
        np.testing.assert_allclose(gl, rl, rtol=0, atol=tol * np.abs(rl).max())


def test_bessel_matches_jax_and_scipy(setup):
    """Values and derivatives against jitted JAX within 1e-11 (the compiled
    series differs from eager JAX by 3.2e-12 at x = 13.8, near the
    crossover, where the port equals eager JAX within 3e-17) and against
    scipy within 5e-11 (the JAX package's own bar); float32 against scipy on
    0..1500 within 2e-5."""
    _, ref = setup
    x = torch.tensor(BESSEL_X, requires_grad=True)
    j = TL.bessel_j0123(x)
    dj = torch.stack([torch.autograd.grad(j[m].sum(), x, retain_graph=True)[0]
                      for m in range(4)]).numpy()
    np.testing.assert_allclose(j.detach().numpy(), ref["bessel"], rtol=0, atol=1e-11)
    np.testing.assert_allclose(dj, ref["dbessel"], rtol=0, atol=1e-11)
    for m in range(4):
        np.testing.assert_allclose(j[m].detach().numpy(), special.jv(m, BESSEL_X), atol=5e-11)
        np.testing.assert_allclose(dj[m], special.jvp(m, BESSEL_X), atol=5e-11)
    x64 = np.linspace(0.0, 1500.0, 15001)
    j32 = TL.bessel_j0123(torch.tensor(x64, dtype=torch.float32))
    assert j32.dtype == torch.float32
    for m in range(4):
        np.testing.assert_allclose(j32[m].double().numpy(), special.jv(m, x64), atol=2e-5)


def test_csqrt_on_the_cut(setup):
    """+i sqrt(x) at (-x, +0.0) and at (-x, -0.0) (torch.sqrt gives -i sqrt(x)
    at -0.0), equal to JAX's _csqrt_pair bit for bit at every point; the
    derivative is 1/(2 sqrt z): torch.sqrt's off the cut, to 1e-15."""
    _, ref = setup
    z = torch.complex(torch.tensor(SQRT_RE), torch.tensor(SQRT_IM))
    s = TL.csqrt(z)
    assert np.array_equal(s.numpy(), ref["sqrt"])
    cut = (SQRT_RE < 0) & (SQRT_IM == 0)
    np.testing.assert_array_equal(s.numpy()[cut], 1j * np.sqrt(-SQRT_RE[cut]))
    assert (torch.sqrt(z).imag.numpy()[cut & np.signbit(SQRT_IM)] < 0).all()
    w = torch.tensor([1.5 + 0.5j, -2.0 + 0.3j, 0.2 - 1.1j], dtype=torch.complex128,
                     requires_grad=True)
    ours = torch.autograd.grad(TL.csqrt(w).abs().sum(), w)[0]
    theirs = torch.autograd.grad(torch.sqrt(w).abs().sum(), w)[0]
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=1e-15)


def test_layered_seismograms_match_jax(setup):
    """The Fukuoka model at SRC with a generic M, within SEIS_TOL of the peak."""
    _, ref = setup
    _, u = TL.layered_seismograms(*SRC, torch.tensor(M_GEN), _stations(),
                                  model=TL.fukuoka_model(device=CPU), nt=NT, nk=NK, kmax=KMAX,
                                  alpha_damp=ALPHA)
    assert u.shape == (3, 3, NT) and u.dtype == F64
    peak = np.abs(ref["seis"]).max()
    assert np.abs(u.numpy() - ref["seis"]).max() <= SEIS_TOL * peak


def test_structured_value_and_grad_match_jax(setup):
    """loc_cmt_value_and_grad with the layered forward, location and moment
    tensor (9 parameters), against the JAX package's structured VJP."""
    port, ref = setup
    m = torch.tensor(_cmt_models(port["prob"])[0])
    v, g = ti.loc_cmt_value_and_grad(m, port["prob"], ti.InvOptions(loc=True, cmt=True),
                                     port["cfg"], forward=port["fwd"])
    np.testing.assert_allclose(v.item(), ref["value"], rtol=VALUE_RTOL)
    _assert_grads(g[None], ref["grad"][None], GRAD_TOL)


def test_layered_misfit_grid_matches_jax(setup):
    """2 depths x 2 horizontal nodes, values and (x, y, z) gradients."""
    port, ref = setup
    stages = TL.make_layered_stages(**port["kw"])
    v, g = ti.layered_misfit_grid(torch.tensor(ZS), torch.tensor(XY), port["prob"],
                                  ti.InvOptions(), port["cfg"], stages)
    assert v.shape == (2, 2) and g.shape == (2, 2, 3)
    np.testing.assert_allclose(v.numpy(), ref["grid_value"], rtol=VALUE_RTOL)
    _assert_grads(g.reshape(4, 3), ref["grid_grad"].reshape(4, 3), GRAD_TOL)


@pytest.mark.parametrize("xy_chunk", [None, 1])
def test_layered_misfit_grid_equals_per_node_gradients(setup, xy_chunk):
    """Each node of the scan (chunked or not) equals loc_cmt_value_and_grad
    of the structured forward at that node alone: value rtol 1e-12,
    gradient within 1e-12 of max |g| (the amortization identity)."""
    port, _ = setup
    stages = TL.make_layered_stages(**port["kw"])
    v, g = ti.layered_misfit_grid(torch.tensor(ZS), torch.tensor(XY), port["prob"],
                                  ti.InvOptions(), port["cfg"], stages, xy_chunk=xy_chunk)
    nodes = torch.tensor([[x, y, z] for z in ZS for x, y in XY])
    v1, g1 = ti.loc_cmt_value_and_grad(nodes, port["prob"], ti.InvOptions(), port["cfg"],
                                       forward=port["fwd"])
    np.testing.assert_allclose(v.reshape(-1).numpy(), v1.numpy(), rtol=1e-12)
    _assert_grads(g.reshape(-1, 3), g1, 1e-12)


@pytest.mark.parametrize("opts", [dict(), dict(cmt=True)], ids=["loc", "loc_cmt"])
def test_structured_equals_plain_autograd(setup, opts):
    """structured_vjp=True against plain autograd through the whole
    synthesis: values bit for bit, gradients within 1e-8 of max |g| (the
    z component is ~10x smaller than x and y)."""
    port, _ = setup
    plain = TL.make_layered_forward(port["st"], structured_vjp=False, **port["kw"])
    ms = _cmt_models(port["prob"]) if opts else CMT_MODELS
    res = [ti.loc_cmt_value_and_grad(torch.tensor(ms), port["prob"], ti.InvOptions(**opts),
                                     port["cfg"], forward=f) for f in (port["fwd"], plain)]
    (v, g), (vp, gp) = res
    assert torch.equal(v, vp)
    _assert_grads(g, gp, 1e-8)


def test_batched_sources_equal_single_calls(setup):
    """Three sources with their own moment tensors in one call equal three
    single calls within 1e-14 of the peak."""
    port, _ = setup
    rng = np.random.default_rng(5)
    xyz = torch.tensor(LOC + rng.uniform(-5, 5, (3, 3)))
    mm = torch.tensor(M_GEN * (1 + 0.1 * rng.standard_normal((3, 1, 1))))
    u = port["fwd"](xyz[:, 0], xyz[:, 1], xyz[:, 2], mm)
    assert u.shape == (3, 3, 3, NT)
    for i in range(3):
        u1 = port["fwd"](xyz[i, 0], xyz[i, 1], xyz[i, 2], mm[i])
        assert (u[i] - u1).abs().max() <= 1e-14 * u1.abs().max()


def test_layer_splitting_invariance():
    """A half-space split into four identical welded layers (source in the
    third) is the same medium: within 1e-10 of the peak."""
    kw = dict(nt=NT, nk=NK, kmax=KMAX)
    _, u1 = TL.layered_seismograms(1.0, 1.0, 17.0, torch.tensor(M_GEN), _stations(),
                                   model=TL.uniform_model(nlayers=1, device=CPU), **kw)
    _, u4 = TL.layered_seismograms(1.0, 1.0, 17.0, torch.tensor(M_GEN), _stations(),
                                   model=TL.uniform_model(nlayers=4, thickness=6.0,
                                                          device=CPU), **kw)
    assert (u1 - u4).abs().max() <= 1e-10 * u1.abs().max()


@pytest.mark.parametrize("hp_below,tol", [(1e9, 0.0), (0.4, 1e-5)])
def test_complex64_stack_above_hp_below(hp_below, tol):
    """hp_below past every active frequency leaves the all-complex128 stack
    bit for bit; at 0.4 rad/s the complex64 stack above it stays within 1e-5
    of the peak (measured 7.6e-7)."""
    kw = dict(model=TL.fukuoka_model(device=CPU), nt=NT, nk=NK, kmax=KMAX)
    _, u = TL.layered_seismograms(*SRC, torch.tensor(M_GEN), _stations(), **kw)
    _, v = TL.layered_seismograms(*SRC, torch.tensor(M_GEN), _stations(), hp_below=hp_below,
                                  **kw)
    assert (u - v).abs().max() <= tol * u.abs().max()


def test_moment_linearity():
    kw = dict(model=TL.fukuoka_model(device=CPU), nt=NT, nk=NK, kmax=KMAX)
    _, ua = TL.layered_seismograms(*SRC, 2.5 * torch.tensor(M_GEN), _stations(), **kw)
    _, ub = TL.layered_seismograms(*SRC, torch.tensor(M_GEN), _stations(), **kw)
    assert (ua - 2.5 * ub).abs().max() <= 1e-10 * ua.abs().max()     # measured 8.3e-12


WHOLESPACE_M = {
    "m0": np.eye(3),
    "m1": np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 0.5], [1.0, 0.5, 0.0]]),
    "m2": np.array([[1.0, 0.7, 0.0], [0.7, -1.0, 0.0], [0.0, 0.0, 0.0]]),
    "generic": M_GEN,
}


@pytest.mark.parametrize("name", list(WHOLESPACE_M))
def test_uniform_without_free_surface_equals_wholespace(name):
    """The layered forward on a uniform model with receivers buried in an
    unbounded medium against the closed-form whole-space oracle, per
    azimuthal channel: within 5e-4 of the peak (the quadrature), at the
    JAX test's nt = 61, nk = 1024, kmax 2.5."""
    m = torch.tensor(WHOLESPACE_M[name])
    _, uo = TL.wholespace_seismograms(1.0, 1.0, 20.0, m, _stations(), stf=("gauss", 0.08))
    _, ul = TL.layered_seismograms(1.0, 1.0, 20.0, m, _stations(),
                                   model=TL.uniform_model(device=CPU), free_surface=False,
                                   stf=("gauss", 0.08), nk=1024, kmax=2.5)
    assert (ul - uo).abs().max() <= 5e-4 * uo.abs().max()


def test_float32_stations_track_float64():
    """float32 stations (complex128 stack, float32 Bessel assembly and FFT)
    on the Fukuoka model: seismograms within 1e-4 of the float64 peak, and
    the gradient of a loss in (x, y, z) has direction cosine > 0.97 and
    norm ratio in (0.5, 2) against float64 (the JAX package's f32 contract)."""
    res = {}
    for dt in (torch.float32, F64):
        st = tm.StationSet(x=torch.tensor(ST_X, dtype=dt), y=torch.tensor(ST_Y, dtype=dt))
        fwd = TL.make_layered_forward(st, model=TL.fukuoka_model(device=CPU), nt=NT, nk=NK,
                                      kmax=KMAX)
        p = torch.tensor(SRC, dtype=dt, requires_grad=True)
        u = fwd(p[0], p[1], p[2], torch.tensor(M_GEN, dtype=dt))
        (g,) = torch.autograd.grad((u * u).sum(), p)
        res[dt] = (u.detach().double(), g.double())
    (u32, g32), (u64, g64) = res[torch.float32], res[F64]
    assert (u32 - u64).abs().max() <= 1e-4 * u64.abs().max()
    cos = (g32 @ g64) / (g32.norm() * g64.norm())
    assert cos > 0.97 and 0.5 < g32.norm() / g64.norm() < 2.0


def test_convert_layered_model():
    jmodel = JL.fukuoka_model()
    model = convert.layered_model(jmodel, device="cpu")
    assert isinstance(model, TL.LayeredModel) and model.thickness.dtype == F64
    for a, b in zip(model, jmodel):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(model.interfaces().numpy(), np.asarray(jmodel.interfaces()))


# -- the omega = 0 lane against a long-double solve (ld_surface.py) -------------

@pytest.mark.parametrize("zi", range(len(LANE_DEPTHS)), ids=[f"z{z:g}" for z in LANE_DEPTHS])
def test_omega0_lane_as_accurate_as_jax(setup, zi):
    """The Fukuoka surface operator at the production damping 0.023, on the
    omega = 0 lane and the next, against the same recursion in long double:
    the port's error is within 10x of the JAX package's own, field by field
    (measured 0.4x-4x; both are ~1e-4 on lane 0 at 3 km)."""
    _, ref = setup
    z = LANE_DEPTHS[zi]
    model = TL.fukuoka_model(device=CPU)
    plan = TL._synth_plan(NT, 1.0, 2, ("clp_step", 0.05, 0.2), NK, KMAX, np.inf)
    band = plan.bands[0]._replace(om=plan.bands[0].om[:2])
    op, _ = TL._surface_operator(model, torch.tensor([z], dtype=F64),
                                 TL._band_grid(band, plan.k_np, 0.023, CPU), True, False)
    for lane in range(2):
        exact = ld_surface.surface_operator(model, np.longdouble(z),
                                            plan.k_np.astype(np.longdouble),
                                            ld_surface.LD(complex(band.om[lane], 0.023)))
        for name, want in exact.items():
            scale = float(np.abs(want).max())
            err = lambda got: float(np.abs(got - want).max()) / scale
            ours = err(getattr(op.rev, name)[0, lane].numpy())
            theirs = err(ref["ops"][name][zi, lane])
            assert ours <= 10.0 * theirs + 1e-14, (name, lane, ours, theirs)


# the compat_loc_cmt parity problem's crust and quadrature (test_torch_drivers.py)
DRIVERS_TABLE = [(3.0, 5.0, 2.9, 2.5), (0.0, 7.0, 4.0, 3.0)]
DRIVERS_NT, DRIVERS_NK, DRIVERS_KMAX = 16, 48, 1.0


@pytest.mark.parametrize("z", [4.0, 4.5], ids=["source", "model"])
def test_omega0_lane_two_layer_as_accurate_as_jax(z):
    """The two-layer crust of the compat_loc_cmt parity tests at the
    production damping 0.023, at their source depth and model depth: the
    surface operator on the omega = 0 lane and the next against the same
    recursion in long double. The port's error is within 10x of the JAX
    package's own, field by field (measured on lane 0: W2 8.4e-7 and 7.4e-7
    of its max against JAX's 7.2e-7 and 6.1e-7, RA2 1.2e-7-1.4e-7 for both;
    on lane 1 ~2e-12; RB2 and inner2 are exact, the source lying in the
    half-space). So where test_torch_drivers_damping.py finds the two
    packages apart, both are off the exact lane alike."""
    plan = TL._synth_plan(DRIVERS_NT, 1.0, 2, ("clp_step", 0.05, 0.2), DRIVERS_NK,
                          DRIVERS_KMAX, np.inf)
    band = plan.bands[0]._replace(om=plan.bands[0].om[:2])
    model = TL.layered_model_from_table(DRIVERS_TABLE, device=CPU)
    op, _ = TL._surface_operator(model, torch.tensor([z], dtype=F64),
                                 TL._band_grid(band, plan.k_np, 0.023, CPU), True, False)
    jops = jax.jit(lambda zz: JL._band_operators(JL.layered_model_from_table(DRIVERS_TABLE),
                                                 zz, plan.k_np, band.om, "f64", 0.023,
                                                 True))(jnp.asarray(z))
    for lane in range(2):
        exact = ld_surface.surface_operator(model, np.longdouble(z),
                                            plan.k_np.astype(np.longdouble),
                                            ld_surface.LD(complex(band.om[lane], 0.023)))
        for name, want in exact.items():
            scale = float(np.abs(want).max()) or 1.0     # RB2 is 0 in the half-space
            err = lambda got: float(np.abs(got - want).max()) / scale
            jfield = getattr(jops, name)
            ours = err(getattr(op.rev, name)[0, lane].numpy())
            theirs = err(np.asarray(jfield.re)[lane] + 1j * np.asarray(jfield.im)[lane])
            assert ours <= 10.0 * theirs + 1e-14, (name, lane, ours, theirs)


def test_clp_filter_matches_jax():
    """The cosine low-pass source filter over both signs of omega, below
    om1, on the ramp and beyond om2 (ends included), 1e-15 absolute."""
    om = np.concatenate([np.linspace(-3.0, 3.0, 61), [0.5, 2.0]])
    got = TL.clp_filter(torch.as_tensor(om), 0.5, 2.0)
    ref = np.asarray(JL.clp_filter(jnp.asarray(om), 0.5, 2.0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-15)
    assert got[-2] == 1.0 and got[-1] == 0.0
