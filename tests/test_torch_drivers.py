"""The port's two inversion modules against the JAX package's on the CPU, in
float64: ``compat_ricker`` (the Ricker_Figs_3_8 notebooks) and
``compat_loc_cmt`` (Figs 9-12) with its pyprop8-layout Jacobian, and the
host bridge ``models/pyprop8_bridge``. The same NumPy inputs go through both
packages; each test states its tolerance.

The loc/CMT problem is the JAX tests' tiny one (2 receivers, nt 16, a
two-layer table, nk 48, kmax 1.0). Its layered physics is held at the
damping ALPHA = 0.2 in both packages (each module's forward patched for this
test module). At the modules' own damping, 0.023, the omega = 0 lane of the stack
recursion cancels digits in both packages alike (ROADMAP Queue 3, item 3;
tests/test_torch_layered.py::test_omega0_lane_two_layer_as_accurate_as_jax),
so the two part there by up to 1.7e-5 of a column's max at this 4 km source
whatever the port does, and by ~4e-9 at 0.1; at 0.2 they agree to ~1e-10,
under the 1e-9 bars here. tests/test_torch_drivers_damping.py holds the two
packages at 0.023 at a bar set from that reading, and
test_jacobian_matches_autograd_at_production_damping holds the port's
Jacobian at 0.023 against plain autograd of its own forward.

The JAX compat compiles one jacfwd per restriction ('loc', 'mt', 'full').
This module compiles the full one once and serves the restrictions from its
columns (forward-mode columns do not depend on which others are computed),
which keeps the module's JAX compiles to one value and one Jacobian program.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveform_ot_torch import compat_loc_cmt as tlc
from waveform_ot_torch import compat_ricker as tru
from waveform_ot_torch import convert
from waveform_ot_torch.models import layered as TL
from waveform_ot_torch.models import pyprop8_bridge as tpb
from waveform_ot_torch.models.ricker import ricker_wavelet_noisy
from waveform_ot_torch.ops import cuda_distance
from waveform_ot_tpu import compat_loc_cmt as jlc
from waveform_ot_tpu import compat_ricker as jru
from waveform_ot_tpu.models import layered as JL
from waveform_ot_tpu.models import pyprop8_bridge as jpb

CPU = "cpu"
# Ricker_Figs_3_8's settings (tests/test_compat_l3.py:84-96)
GRID = (-2.0, 7.0, -2.0, 2.6, 40, 128)
TRANGE = (-2.0, 7.0)
X = np.array([0.25, 1.45, 1.08])
FD_GRID = GRID
# the tiny loc/CMT problem (tests/test_compat_l3.py:188-206)
ALPHA = 0.2
NT = 16
SRC = (2.0, -3.0, 4.0)
X0 = (2.5, -2.0, 4.5)
M_LOC = np.array([2.8, -2.2, 4.4])
M6 = np.array([0.3, -0.5, 0.2, 0.7, -0.1, 0.4])
TABLE = [(3.0, 5.0, 2.9, 2.5), (0.0, 7.0, 4.0, 3.0)]
DRV = {
    ("loc", "cartesian"): dict(x=True, y=True, z=True),
    ("loc", "spherical"): dict(r=True, phi=True, z=True),
    ("mt", "cartesian"): dict(moment_tensor=True),
    ("full", "cartesian"): dict(x=True, y=True, z=True, moment_tensor=True),
    ("full", "spherical"): dict(r=True, phi=True, z=True, moment_tensor=True),
}


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    """On the CPU the port takes the plain versions: no kernel launches."""
    before = cuda_distance.LAUNCHES
    yield
    assert cuda_distance.LAUNCHES == before


def _rel(got, want) -> float:
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# compat_ricker
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ricker_obs():
    """The observed wavelet and its transformed OTpdf in both packages."""
    t, w = jru.rickerwavelet(0.0, 1.6, 1.0, trange=TRANGE)
    _, obs_j = jru.BuildOTobjfromWaveform(t, w, GRID, lambdav=0.03, transform=True)
    _, obs_t = tru.BuildOTobjfromWaveform(t, w, GRID, lambdav=0.03, transform=True,
                                          device=CPU)
    return np.asarray(t), np.asarray(w), obs_j, obs_t


def test_rickerwavelet_matches_jax():
    """Wavelet, time axis and analytic (3, nt) Jacobian within 1e-12 of the
    JAX package's; ricker() and its df-derivative too."""
    for deriv in (False, True):
        got = tru.rickerwavelet(0.1, 1.6, 1.1, trange=TRANGE, deriv=deriv, device=CPU)
        want = jru.rickerwavelet(0.1, 1.6, 1.1, trange=TRANGE, deriv=deriv)
        assert len(got) == len(want) == (3 if deriv else 2)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)
    for a, b in zip(tru.ricker(30.0, deriv=True, device=CPU), jru.ricker(30.0, deriv=True)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)


@pytest.mark.parametrize("sigma_cor", [0.0, 0.2])
def test_rickerwavelet_noise_law(sigma_cor):
    """The noisy wavelet is the noiseless one plus noise of the reference's
    law: white N(0, (sigma_amp max|w|)^2) (mean and standard deviation of
    the 256 draws within 5 standard errors), or GP noise scaled to standard
    deviation sigma_amp exactly (1e-12) and smooth (lag-1 autocorrelation
    > 0.9). A seed gives the same draws again; another seed others. The
    draws are torch's, not jax.random's."""
    sigma = 0.1
    _, w0 = tru.rickerwavelet(0.0, 1.6, 1.0, trange=TRANGE, device=CPU)
    _, w1 = tru.rickerwavelet(0.0, 1.6, 1.0, trange=TRANGE, sigma_amp=sigma,
                              sigma_cor=sigma_cor, seed=3, device=CPU)
    _, w2 = tru.rickerwavelet(0.0, 1.6, 1.0, trange=TRANGE, sigma_amp=sigma,
                              sigma_cor=sigma_cor, seed=3, device=CPU)
    _, w3 = tru.rickerwavelet(0.0, 1.6, 1.0, trange=TRANGE, sigma_amp=sigma,
                              sigma_cor=sigma_cor, seed=4, device=CPU)
    np.testing.assert_array_equal(w1, w2)
    assert np.abs(w3 - w1).max() > 0.0
    noise = w1 - w0
    n = noise.size
    if sigma_cor == 0.0:
        z = noise / (sigma * np.abs(w0).max())
        assert abs(z.mean()) < 5.0 / np.sqrt(n)
        assert abs(z.std() - 1.0) < 5.0 / np.sqrt(2.0 * n)
    else:
        assert abs(noise.std() - sigma) < 1e-12
        c = noise - noise.mean()
        assert np.dot(c[1:], c[:-1]) / np.dot(c, c) > 0.9
    # the model-layer function directly, from its own generator
    gen = torch.Generator().manual_seed(3)
    m = [torch.tensor(v, dtype=torch.float64) for v in (0.0, 1.6, 1.0)]
    _, wm = ricker_wavelet_noisy(gen, *m, trange=TRANGE, sigma_amp=sigma,
                                    sigma_cor=sigma_cor)
    np.testing.assert_array_equal(wm.numpy(), w1)


@pytest.mark.parametrize("path", ["plain", "norm", "transform"])
def test_build_ot_obj_matches_jax(path):
    """BuildOTobjfromWaveform on its three paths: the distance field, the
    density, the grid positions and the OTpdf (1e-12), the automatic grid
    (exact), and the nearest points, dddy and the amplitude chain (1e-10 of
    their max) at every grid point not at a tie. At a tie, a point
    equidistant from two segments (the double Ricker is mirror-symmetric,
    and the port multiplies by 1/|c|^2 where JAX divides), either segment is
    right and the packages may take different ones: under 1% of the points
    here."""
    t, w = jru.rickerwavelet(0.3, 1.4, 1.05, trange=TRANGE)
    kw = dict(lambdav=0.03, norm=path == "norm", transform=path == "transform", deriv=True)
    got = tru.BuildOTobjfromWaveform(t, w, GRID, device=CPU, **kw)
    want = jru.BuildOTobjfromWaveform(t, w, GRID, **kw)
    assert len(got) == len(want) == (3 if path == "norm" else 2)
    (wf, ot), (jwf, jot) = got[:2], want[:2]
    for a, b in ((wf.dfield, jwf.dfield), (wf.pdf, jwf.pdf), (wf.pos, jwf.pos),
                 (ot.pdf, jot.pdf), (ot.x, jot.x)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)
    ties = wf.irays != np.asarray(jwf.irays)
    assert ties.mean() < 0.01
    for a, b in ((wf.xrays, jwf.xrays), (wf.dddy, jwf.dddy)):
        assert _rel(a[~ties], np.asarray(b)[~ties]) <= 1e-10
    chain = (~ties).reshape(wf.pdf.shape).astype(float)
    assert _rel(wf.PDFderiv(chain), jwf.PDFderiv(chain)) <= 1e-10
    if path == "norm":
        assert np.allclose(np.asarray(got[2], float), np.asarray(want[2], float),
                           rtol=0, atol=1e-15)


def test_calc_wasser_waveform_matches_jax(ricker_obs):
    """CalcWasserWaveform (both return forms, with and without derivatives)
    and CalcWasserWaveform_old: values, waveform and origin-time
    derivatives within 1e-10 of the JAX package's."""
    _, _, obs_j, obs_t = ricker_obs
    t, w = jru.rickerwavelet(0.3, 1.4, 1.05, trange=TRANGE)
    wf_j, pred_j = jru.BuildOTobjfromWaveform(t, w, GRID, lambdav=0.03, deriv=True,
                                              transform=True)
    wf_t, pred_t = tru.BuildOTobjfromWaveform(t, w, GRID, lambdav=0.03, deriv=True,
                                              transform=True, device=CPU)
    for fn_t, fn_j, kws in ((tru.CalcWasserWaveform, jru.CalcWasserWaveform,
                             [dict(deriv=True, returnmarg=True), dict(deriv=True),
                              dict(returnmarg=True), dict()]),
                            (tru.CalcWasserWaveform_old, jru.CalcWasserWaveform_old,
                             [dict(deriv=True), dict()])):
        for kw in kws:
            got = fn_t(pred_t, obs_t, wf_t, **kw)
            want = fn_j(pred_j, obs_j, wf_j, **kw)
            for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
                np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                           rtol=0, atol=1e-10, err_msg=str(kw))


def test_optfunc_matches_jax_and_records(ricker_obs):
    """The scipy objective at Ricker_Figs_3_8's settings: value and gradient
    within 1e-10 of the JAX package's, one Wdata record per call; findres
    matches the recorded iterates back to it; init() clears."""
    _, _, obs_j, obs_t = ricker_obs
    data = lambda obs: [obs, "W2", TRANGE, GRID, 0.03, True, 0.5, 45.0]
    jru.init()
    tru.init()
    w_j, d_j = jru.optfunc(X, data(obs_j))
    w_t, d_t = tru.optfunc(X, data(obs_t))
    assert abs(w_t - w_j) < 1e-10
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-10)
    assert len(tru.Wdata) == 1 and tru.Wdata[0][0] == w_t
    tru.recordresult(X)
    was, models, waves = tru.findres(tru.Wits, tru.Wdata)
    assert was == [w_t] and np.array_equal(models[0], X) and waves[0] is tru.Wdata[0][2]
    tru.init()
    assert tru.Wdata == [] and tru.Wits == []


def test_fd_checkers_match_jax():
    """check_dwduFD and check_dwdmFD (every parameter, both returnmarg
    branches) against the JAX package's at rtol 1e-6 (the reference
    parity tests' bar for these differences)."""
    t, w = jru.rickerwavelet(0.0, 1.6, 1.0, trange=TRANGE)
    _, obs_j = jru.BuildOTobjfromWaveform(t, w, FD_GRID, lambdav=0.03, transform=True)
    _, obs_t = tru.BuildOTobjfromWaveform(t, w, FD_GRID, lambdav=0.03, transform=True,
                                          device=CPU)
    mref = np.array([0.3, 1.4, 1.05])
    tp, wp = jru.rickerwavelet(*mref, trange=TRANGE)
    i = int(np.argmax(np.abs(np.asarray(wp))))
    got = tru.check_dwduFD(i, tp, wp, 0.1, FD_GRID, 0.03, obs_t, transform=True)
    want = jru.check_dwduFD(i, tp, wp, 0.1, FD_GRID, 0.03, obs_j, transform=True)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    for k, marg in ((0, True), (1, True), (2, True), (0, False)):
        got = tru.check_dwdmFD(k, tp, wp, 0.01, mref, FD_GRID, 0.03, obs_t, TRANGE,
                               transform=True, returnmarg=marg)
        want = jru.check_dwdmFD(k, tp, wp, 0.01, mref, FD_GRID, 0.03, obs_j, TRANGE,
                                transform=True, returnmarg=marg)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_ricker_helpers_match_jax():
    """datawindowunion, LSmisfit and arctan_trans (with its slope) within
    1e-12 of the JAX package's."""
    t1 = np.linspace(-2.0, 7.0, 128)
    t2 = np.linspace(-1.0, 8.0, 128)
    w1, w2 = np.sin(t1), 0.5 * np.cos(t2)
    for a, b in zip(tru.datawindowunion(t1, w1, t2, w2), jru.datawindowunion(t1, w1, t2, w2)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert abs(tru.LSmisfit(t1, w1, t2, w2) - jru.LSmisfit(t1, w1, t2, w2)) < 1e-12
    for a, b in zip(tru.arctan_trans(w1, -2.1, 2.6, deriv=True, device=CPU),
                    jru.arctan_trans(w1, -2.1, 2.6, deriv=True)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# compat_loc_cmt
# ---------------------------------------------------------------------------


def _serve_restrictions_from_full(base):
    """The JAX compat's 'loc' and 'mt' jacfwd entries for ``base`` served by
    the columns of its 'full' one (one compile instead of three)."""
    entry = jlc._FWD_CACHE[base]
    full = entry["full"]
    entry["loc"] = lambda *a: full(*a)[..., :3]
    entry["mt"] = lambda *a: full(*a)[..., 3:]


@pytest.fixture(scope="module")
def loc():
    """The tiny problem in both packages, both modules' physics at ALPHA:
    observed data from JAX's prop8seis at SRC, 20-row windows, OTdata Wavg
    W2 lambda 0.04, and the JAX full Jacobian at X0."""
    rng = np.random.default_rng(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlc, "layered_seismograms",
                   functools.partial(JL.layered_seismograms, alpha_damp=ALPHA))
        mp.setattr(jlc, "_FWD_CACHE", {})
        mp.setattr(tlc, "make_layered_stages",
                   functools.partial(TL.make_layered_stages, alpha_damp=ALPHA))
        mp.setattr(tlc, "_STAGES", {})
        p8 = {"sdrm": (30.0, 60.0, 45.0, 1.0e13), "recx": rng.uniform(5.0, 25.0, 2),
              "recy": rng.uniform(5.0, 25.0, 2), "model": JL.layered_model_from_table(TABLE),
              "nk": 48, "kmax": 1.0}
        t, s = jlc.prop8seis(*SRC, p8, nt=NT)
        p8["obs_seis"] = np.asarray(s)
        drv = jlc.DerivativeSwitches(x=True, y=True, z=True, moment_tensor=True)
        _, s0, d0, _, st0 = jlc.prop8seis(*X0, p8, Mxyz=jlc.buildMxyzfromupper(M6), drv=drv,
                                          nt=NT, returndata=True)
        _serve_restrictions_from_full((NT, 1.0, 48, 1.0))
        tp8 = convert.prop8data(p8, device=CPU)
        grids = jlc.buildFingerprintwindows(t, s, Nu=20)
        ot = {"Wopt": "Wavg", "distfunc": "W2", "plambda": 0.04, "theta": 45.0,
              "obs_grids": grids,
              "obs_grids01": [[g[:2] + [0.0, 1.0] + g[4:] for g in row] for row in grids]}
        wfo_j, tgt_j = jlc.BuildOTobjfromWaveform(t, s, grids, ot, lambdav=0.04)
        tot = dict(ot, obs_grids=convert.obs_grids(grids))
        wfo_t, tgt_t = tlc.BuildOTobjfromWaveform(t, s, tot["obs_grids"], tot, lambdav=0.04,
                                                  device=CPU)
        invopt = {"loc": True, "cmt": False, "mistype": "OT", "precon": False,
                  "mscal": np.ones(3), "mref": np.zeros(3)}
        yield {
            "t": np.asarray(t), "p8": p8, "tp8": tp8, "jac0": (np.asarray(s0), np.asarray(d0)),
            "st0": st0, "wfo": (wfo_j, wfo_t),
            "jax": {"invopt": invopt, "prop8data": p8, "OTdata": dict(ot, wfobs=wfo_j,
                                                                       wfobs_target=tgt_j)},
            "torch": {"invopt": invopt, "prop8data": tp8, "device": CPU,
                      "OTdata": dict(tot, wfobs=wfo_t, wfobs_target=tgt_t)},
        }


def _jax_channels(loc, drv_kw):
    """JAX's pyprop8-layout channels for ``drv_kw`` from its full Jacobian at
    X0, laid out by its own _assemble_channels."""
    _, d0 = loc["jac0"]
    jac9 = np.zeros((d0.shape[0], 9) + d0.shape[2:])
    jac9[:, :2], jac9[:, 2] = d0[:, :2], -d0[:, 2]
    for k in range(6):
        jac9[:, 3 + k] = d0[:, 3 + jlc._DIAGORDER[k]]
    st = jlc._Stations(loc["p8"]["recx"], loc["p8"]["recy"], *X0[:2])
    return jlc._assemble_channels(jac9, jlc.DerivativeSwitches(**drv_kw), st)


@pytest.mark.parametrize("mode,geometry", list(DRV))
def test_prop8seis_jacobian_matches_jax_jacfwd(loc, mode, geometry):
    """prop8seis with each drv (loc, mt, full; cartesian and spherical): the
    seismograms and every derivative channel within 1e-9 of the channel's
    max of JAX's jacfwd, in pyprop8's layout, on the same inputs."""
    s0, _ = loc["jac0"]
    drv = tlc.DerivativeSwitches(**DRV[mode, geometry])
    _, s, deriv = tlc.prop8seis(*X0, loc["tp8"], Mxyz=tlc.buildMxyzfromupper(M6), drv=drv,
                                nt=NT, device=CPU)
    want = _jax_channels(loc, DRV[mode, geometry])
    assert deriv.shape == want.shape == (2, drv.nderiv, 3, NT)
    assert _rel(s, s0) <= 1e-9
    for c in range(drv.nderiv):
        assert _rel(deriv[:, c], want[:, c]) <= 1e-9, c


def test_prop8seis_value_and_returndata_match_jax(loc):
    """The drv-less forward at the source (1e-9 of the peak), its time axis,
    and the source/station stand-ins returndata hands back."""
    t, s, src, st = tlc.prop8seis(*SRC, loc["tp8"], nt=NT, returndata=True, device=CPU)
    np.testing.assert_array_equal(t, loc["t"])
    assert _rel(s, loc["p8"]["obs_seis"]) <= 1e-9
    _, _, jsrc, jst = jlc.prop8seis(*SRC, loc["p8"], nt=NT, returndata=True)
    np.testing.assert_allclose(src.Mxyz, jsrc.Mxyz, rtol=0, atol=1e-15)
    assert (src.x, src.y, src.z) == (jsrc.x, jsrc.y, jsrc.z)
    for name in ("xx", "yy", "rr", "pp"):
        np.testing.assert_array_equal(getattr(st, name), getattr(jst, name))


@pytest.mark.parametrize("mode", ["loc", "mt", "full"])
def test_jacobian_runs_stage_a_once(loc, monkeypatch, mode):
    """One prop8seis call with a Jacobian runs stage A (the surface
    operator) once, for the value and every column alike."""
    calls = []
    real = TL._surface_operator
    monkeypatch.setattr(TL, "_surface_operator", lambda *a: calls.append(1) or real(*a))
    tlc.prop8seis(*X0, loc["tp8"], drv=tlc.DerivativeSwitches(**DRV[mode, "cartesian"]),
                  nt=NT, device=CPU)
    assert len(calls) == 1


def test_jacobian_matches_autograd_at_production_damping():
    """At the modules' own damping (0.023) the analytic columns equal the
    Jacobian of plain reverse-mode autograd through the whole layered
    forward (no structure used) within 1e-9 of each column's max, and the
    value bit for bit."""
    from waveform_ot_torch.models.seismo import StationSet, mxyz_from_upper

    rng = np.random.default_rng(0)
    st = StationSet(*(torch.tensor(rng.uniform(5.0, 25.0, 2)) for _ in range(2)))
    model = TL.layered_model_from_table(TABLE, device=CPU)
    p = torch.tensor([*X0, *M6], dtype=torch.float64)
    u, cols = TL.make_layered_stages(model=model, nt=NT, nk=48, kmax=1.0).jacobian(
        *p[:3], mxyz_from_upper(p[3:]), st)
    fwd = lambda q: TL.layered_seismograms(q[0], q[1], q[2], mxyz_from_upper(q[3:]), st,
                                           model=model, nt=NT, nk=48, kmax=1.0)[1]
    want = torch.autograd.functional.jacobian(fwd, p).movedim(-1, 0)
    assert torch.equal(u, fwd(p))
    for c in range(9):
        assert _rel(cols[c].numpy(), want[c].numpy()) <= 1e-9, c


def test_optfunc_l2_matches_jax(loc):
    """optfunc_L2, loc only: misfit and gradient within 1e-9 relative of the
    JAX package's; returnseis/returnseisd/noderiv and the history record."""
    tlc.init()
    got = tlc.optfunc_L2(M_LOC, loc["torch"], returnseisd=True)
    want = jlc.optfunc_L2(M_LOC, loc["jax"], returnseisd=True)
    assert abs(got[0] - want[0]) <= 1e-9 * abs(want[0])
    assert _rel(got[1], want[1]) <= 1e-9
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    assert _rel(got[3], want[3]) <= 1e-9 and _rel(got[4], want[4]) <= 1e-9
    assert tlc.optfunc_L2(M_LOC, loc["torch"], noderiv=True) == got[0]
    assert len(tlc.opt_history_data) == 2
    tlc.optdata = loc["torch"]
    tlc.recordresult(M_LOC)
    assert len(tlc.opt_history) == 1 and tlc.opt_history[0][1] == got[0]
    via = tlc.optfunc(M_LOC, {**loc["torch"], "invopt": {**loc["torch"]["invopt"],
                                                         "mistype": "L2"}})
    assert via[0] == got[0]
    tlc.init()


def test_optfunc_ot_matches_jax(loc):
    """optfunc_OT, loc only, within 1e-9 relative of the JAX package's:
    Wavg with returnderiv (misfit, gradient, derivxyz, dr), return2W and
    Wt/Wu (their misfits and gradients), and the preconditioned gradient."""
    got = tlc.optfunc_OT(M_LOC, loc["torch"], returnderiv=True)
    want = jlc.optfunc_OT(M_LOC, loc["jax"], returnderiv=True)
    assert abs(got[0] - want[0]) <= 1e-9 * abs(want[0])
    for a, b in zip(got[1:], want[1:]):
        assert _rel(a, b) <= 1e-9
    got2 = tlc.optfunc_OT(M_LOC, loc["torch"], return2W=True)
    want2 = jlc.optfunc_OT(M_LOC, loc["jax"], return2W=True)
    for k, wopt in enumerate(("Wt", "Wu")):
        assert abs(got2[0][k] - want2[0][k]) <= 1e-9 * abs(want2[0][k])
        assert _rel(got2[1][k], want2[1][k]) <= 1e-9
        data = {**loc["torch"], "OTdata": {**loc["torch"]["OTdata"], "Wopt": wopt}}
        mis, dmis = tlc.optfunc_OT(M_LOC, data)
        assert mis == got2[0][k] and np.array_equal(dmis, got2[1][k])
    mscal = np.array([2.0, 0.5, 1.5])
    data = {**loc["torch"], "invopt": {**loc["torch"]["invopt"], "precon": True,
                                       "mscal": mscal}}
    mis, dmis = tlc.optfunc_OT(M_LOC / mscal, data)
    assert abs(mis - want[0]) <= 1e-9 * abs(want[0])
    assert _rel(dmis, want[1] * mscal) <= 1e-9
    tlc.init()


def test_moment_ls_recovers_truth(loc):
    """Moment_LS at the source of noiseless data recovers its six moment
    entries within 1e-9 of their max."""
    p8 = dict(loc["tp8"])
    _, p8["obs_seis"] = tlc.prop8seis(*SRC, p8, Mxyz=tlc.buildMxyzfromupper(M6), nt=NT,
                                      device=CPU)
    assert _rel(tlc.Moment_LS(list(SRC), p8, device=CPU), M6) <= 1e-9


def test_moment_ls_matches_jax_on_noisy_data(loc):
    """Moment_LS at X0, away from the source, on the observed data plus 5% of
    their peak in Gaussian noise (default_rng(1)), where the least-squares
    solution is not the truth: within 1e-9 of the JAX package's, of its
    max."""
    obs = loc["p8"]["obs_seis"]
    obs = obs + 0.05 * np.abs(obs).max() * np.random.default_rng(1).standard_normal(obs.shape)
    got = tlc.Moment_LS(list(X0), dict(loc["tp8"], obs_seis=obs), device=CPU)
    want = jlc.Moment_LS(list(X0), dict(loc["p8"], obs_seis=obs))
    assert _rel(got, want) <= 1e-9


def test_fingerprint_windows_and_builders_match_jax(loc):
    """buildFingerprintwindows with per-trace and with fixed u0/u1 limits
    (exactly JAX's), arctan_trans (1e-12) and the per-trace fingerprints of
    BuildOTobjfromWaveform (1e-12)."""
    t, s = loc["t"], loc["p8"]["obs_seis"]
    for kw in (dict(), dict(Nu=20, Nt=12, u0=-3.0, u1=3.0)):
        got = tlc.buildFingerprintwindows(t, s, device=CPU, **kw)
        want = jlc.buildFingerprintwindows(t, s, **kw)
        assert got == convert.obs_grids(want), kw
    grids = loc["torch"]["OTdata"]["obs_grids"]
    for a, b in zip(tlc.arctan_trans(s, grids, deriv=True, device=CPU),
                    jlc.arctan_trans(s, grids, deriv=True)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    (wj, wt) = loc["wfo"]
    for i in range(2):
        for j in range(3):
            np.testing.assert_allclose(wt[i][j].pdf, np.asarray(wj[i][j].pdf), rtol=0,
                                       atol=1e-12)


def test_loc_cmt_helpers_match_jax():
    """checkconverge, setmref, buildMxyzfromupper, misfitfunc, drv_rpd2xyz
    and the loc/CMT CalcWasserWaveform's no-tantheta origin-time scale."""
    rng = np.random.default_rng(5)
    mtrue = np.array([1.0, -2.0, 5.0])
    sols = []
    for i in range(12):
        mstart = rng.uniform(-70.0, 70.0, 3)
        if i % 5 == 0:
            mstart[0] = 80.0
        sols.append([mstart, 100.0, mtrue + (0.1 if i % 2 else 5.0) * rng.normal(size=3),
                     1.0, mtrue, -10.0])
    for a, b in zip(tlc.checkconverge(sols), jlc.checkconverge(sols)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    class _Src:
        Mxyz = rng.normal(size=(1, 3, 3))

    for invopt in ({"loc": True, "cmt": False}, {"loc": True, "cmt": True},
                   {"loc": False, "cmt": True}):
        np.testing.assert_array_equal(np.hstack(tlc.setmref(invopt, _Src, mtrue)),
                                      np.hstack(jlc.setmref(invopt, _Src, mtrue)))
    np.testing.assert_array_equal(tlc.buildMxyzfromupper(M6), jlc.buildMxyzfromupper(M6))
    so, sp = rng.normal(size=(2, 3, 8)), rng.normal(size=(2, 3, 8))
    assert tlc.misfitfunc(so, sp) == jlc.misfitfunc(so, sp)
    deriv = rng.normal(size=(2, 9, 3, 8))
    st = jlc._Stations(rng.uniform(5, 25, 2), rng.uniform(5, 25, 2), 1.0, 2.0)
    for kw, geometry in ((DRV["full", "cartesian"], "cartesian"),
                         (DRV["full", "spherical"], "spherical")):
        np.testing.assert_array_equal(
            tlc.drv_rpd2xyz(tlc.DerivativeSwitches(**kw), deriv, st, geometry=geometry),
            jlc.drv_rpd2xyz(jlc.DerivativeSwitches(**kw), deriv, st, geometry=geometry))
    # the loc/CMT origin-time rescale 1/(t1 - t0), without tantheta
    t = np.arange(16.0)
    w, w2 = np.sin(t / 3.0), np.sin(t / 3.0 - 0.2)
    g = [[[0.0, 15.0, -1.5, 1.5, 20, 16]]]
    ot = {"obs_grids01": [[[0.0, 15.0, 0.0, 1.0, 20, 16]]]}
    res = []
    for mod, kw in ((tlc, dict(device=CPU)), (jlc, {})):
        wfp, src = mod.BuildOTobjfromWaveform(t, w, g[0][0], ot, deriv=True, theta=60.0, **kw)
        _, tgt = mod.BuildOTobjfromWaveform(t, w2, g[0][0], ot, theta=60.0, **kw)
        res.append(mod.CalcWasserWaveform(src[0][0], tgt[0][0], wfp[0][0], deriv=True,
                                          returnmarg=True))
    for a, b in zip(jax.tree_util.tree_leaves(res[0]), jax.tree_util.tree_leaves(res[1])):
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float), rtol=0,
                                   atol=1e-10)


def test_build_mxyz_matches_jax():
    """BuildMxyz, the reference's alias of buildMxyzfromupper: the symmetric
    tensor of the six upper entries, exactly as JAX's."""
    m6 = np.random.default_rng(6).normal(size=6)
    got, ref = tlc.BuildMxyz(m6), jlc.BuildMxyz(m6)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("success", [True, False])
def test_printanalysis_prints_as_jax(success, capsys, monkeypatch):
    """printanalysis (without the Moment_LS fit) on a fixed optimizer result
    and history prints what JAX's prints, character for character; a failed
    optimisation prints its one line."""
    rng = np.random.default_rng(9)
    mtrue = np.append(np.array(SRC), M6)
    mstart = np.append(np.array(X0), rng.normal(size=6))
    final = tlc.buildMxyzfromupper(M6 + 0.01 * rng.normal(size=6))
    opt = types.SimpleNamespace(success=success, fun=0.125)
    out = []
    for mod in (tlc, jlc):
        monkeypatch.setattr(mod, "opt_history", [[0.125, mtrue, None, final]])
        mod.printanalysis(np.append(M_LOC, M6), opt, mtrue, mstart, 3.5, 0.0625, None, None)
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    assert ("Optimisation Failed" in out[0]) != success


@pytest.mark.parametrize("call", ["prop8seis", "rickerwavelet", "buildFingerprintwindows"])
def test_inversion_modules_default_to_the_card(call):
    """Without ``device`` the inversion modules compute on the card: where torch has no
    CUDA the call raises, and it never runs on the CPU instead."""
    fns = {
        "prop8seis": lambda: tlc.prop8seis(1.0, 2.0, 5.0, {"sdrm": (30.0, 60.0, 45.0, 1e13),
                                                           "recx": [10.0], "recy": [5.0],
                                                           "model": TABLE, "nk": 8},
                                           nt=8),
        "rickerwavelet": lambda: tru.rickerwavelet(0.0, 1.6, 1.0),
        "buildFingerprintwindows": lambda: tlc.buildFingerprintwindows(
            np.arange(4.0), np.ones((1, 1, 4))),
    }
    if torch.cuda.is_available():
        fns[call]()
        return
    with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda"):
        fns[call]()


# ---------------------------------------------------------------------------
# models/pyprop8_bridge
# ---------------------------------------------------------------------------

A = np.arange(12.0).reshape(4, 3) / 10.0


def _mock_host(m):
    """Linear mock physics with its analytic Jacobian: (2, 2) and (3, 2, 2)."""
    return (A @ m).reshape(2, 2), A.T.reshape(3, 2, 2)


def test_host_forward_with_jacobian_gradcheck():
    """The host function's value on m's device and, by gradcheck, a backward
    that contracts with its host Jacobian; one host call per forward."""
    calls = []
    host = lambda m: calls.append(1) or _mock_host(m)
    m = torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64, requires_grad=True)
    out = tpb.host_forward_with_jacobian(host, m, (2, 2), torch.float64, (3, 2, 2))
    np.testing.assert_allclose(out.detach().numpy(), (A @ m.detach().numpy()).reshape(2, 2))
    (out ** 2).sum().backward()
    np.testing.assert_allclose(m.grad.numpy(), 2.0 * A.T @ (A @ m.detach().numpy()),
                               atol=1e-12)
    assert len(calls) == 1
    assert torch.autograd.gradcheck(
        lambda mm: tpb.host_forward_with_jacobian(_mock_host, mm, (2, 2), torch.float64,
                                                  (3, 2, 2)), (m,))
    with pytest.raises(ValueError, match="host function gave"):
        tpb.host_forward_with_jacobian(_mock_host, m, (4,), torch.float64, (3, 4))


def test_bridge_prop8seis_with_a_mock_host(monkeypatch):
    """The bridge's prop8seis wires a host forward (here a mock in place of
    pyprop8) into autograd: value and gradient of a loss, as JAX's bridge
    gives them with the same mock; without pyprop8 the host call raises."""
    nr, nt = 2, 4
    B = np.random.default_rng(1).normal(size=(9, nr * 3 * nt))

    def host(x, y, z, prop8data, Mxyz=None, nt=nt, timestep=1.0):
        m = np.concatenate([[x, y, z], Mxyz[np.triu_indices(3)]])
        return None, (m @ B).reshape(nr, 3, nt), B.reshape(9, nr, 3, nt)

    monkeypatch.setattr(tpb, "prop8seis_host", host)
    monkeypatch.setattr(jpb, "prop8seis_host", host)
    m0 = np.array([1.0, 2.0, 3.0, *M6])
    m = torch.tensor(m0, requires_grad=True)
    loss = (tpb.prop8seis(m, {}, nr, nt=nt) ** 2).sum()
    loss.backward()
    jloss, jg = jax.value_and_grad(lambda mm: jnp.sum(jpb.prop8seis(mm, {}, nr, nt=nt) ** 2))(
        jnp.asarray(m0))
    assert abs(loss.item() - float(jloss)) <= 1e-12 * float(jloss)
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(jg), rtol=1e-12)
    monkeypatch.undo()
    if not tpb.HAVE_PYPROP8:
        with pytest.raises(ImportError):
            tpb.prop8seis_host(0.0, 0.0, 1.0, {"sdrm": (0, 0, 0, 1)})
