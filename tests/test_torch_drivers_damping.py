"""compat_loc_cmt against the JAX package at the modules' own damping, alpha
0.023, on the CPU in float64, with neither package patched: the tiny problem
of tests/test_torch_drivers.py (2 receivers, nt 16, a two-layer table, nk 48,
kmax 1.0, the same seeds).

At this damping the omega = 0 lane of the stack recursion cancels digits in
both packages (ROADMAP Queue 3, item 3): on that lane each package's surface
operator is ~7e-7 off a long-double solve, and the port's error is the size
of JAX's (test_torch_layered.py::test_omega0_lane_two_layer_as_accurate_as_jax).
Through the synthesis that parts the two packages by more than the 1e-9 bars
that test_torch_drivers.py holds at damping 0.2. The bar here, BAR = 5e-5,
is three times the largest deviation read on this problem on the CPU in
float64:

  * prop8seis at the model: seismograms 1.7e-6 of their peak, derivative
    channels 9.7e-7 ... 1.7e-5 of each channel's max (the same in both
    geometries); at the source, the drv-less seismograms 7.7e-6;
  * optfunc_L2 / optfunc_OT, loc only, at M_LOC: values 2.6e-6 / 1.1e-6
    relative, gradients 6.6e-6 / 9.6e-6 of their max;
  * Moment_LS at the model: 3.3e-6 of its max on the observed data, 4.0e-6
    with 5% noise added.
"""

import numpy as np
import pytest

from waveform_ot_torch import compat_loc_cmt as tlc
from waveform_ot_torch import convert
from waveform_ot_tpu import compat_loc_cmt as jlc
from waveform_ot_tpu.models import layered as JL

CPU = "cpu"
BAR = 5e-5
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


def _rel(got, want) -> float:
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def prod():
    """The tiny problem in both packages at damping 0.023: observed data
    from JAX's prop8seis at SRC, 20-row windows, OTdata Wavg W2 lambda 0.04,
    and JAX's full Jacobian at X0 in both geometries."""
    rng = np.random.default_rng(0)
    p8 = {"sdrm": (30.0, 60.0, 45.0, 1.0e13), "recx": rng.uniform(5.0, 25.0, 2),
          "recy": rng.uniform(5.0, 25.0, 2), "model": JL.layered_model_from_table(TABLE),
          "nk": 48, "kmax": 1.0}
    t, s = jlc.prop8seis(*SRC, p8, nt=NT)
    p8["obs_seis"] = np.asarray(s)
    full = {}
    for geometry in ("cartesian", "spherical"):
        drv = jlc.DerivativeSwitches(**DRV["full", geometry])
        _, s0, d0 = jlc.prop8seis(*X0, p8, Mxyz=jlc.buildMxyzfromupper(M6), drv=drv, nt=NT)
        full[geometry] = (np.asarray(s0), np.asarray(d0))
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
    return {
        "p8": p8, "tp8": tp8, "full": full,
        "jax": {"invopt": invopt, "prop8data": p8,
                "OTdata": dict(ot, wfobs=wfo_j, wfobs_target=tgt_j)},
        "torch": {"invopt": invopt, "prop8data": tp8, "device": CPU,
                  "OTdata": dict(tot, wfobs=wfo_t, wfobs_target=tgt_t)},
    }


@pytest.mark.parametrize("mode,geometry", list(DRV))
def test_prop8seis_matches_jax_at_production_damping(prod, mode, geometry):
    """prop8seis at X0 with each drv: the seismograms and every derivative
    channel within BAR of the channel's max of JAX's jacfwd channels (its
    full Jacobian, restricted to the channels this drv asks for)."""
    s0, d0 = prod["full"][geometry]
    drv = tlc.DerivativeSwitches(**DRV[mode, geometry])
    _, s, deriv = tlc.prop8seis(*X0, prod["tp8"], Mxyz=tlc.buildMxyzfromupper(M6), drv=drv,
                                nt=NT, device=CPU)
    want = {"loc": d0[:, :3], "mt": d0[:, 3:], "full": d0}[mode]
    assert deriv.shape == want.shape == (2, drv.nderiv, 3, NT)
    assert _rel(s, s0) <= BAR
    for c in range(drv.nderiv):
        assert _rel(deriv[:, c], want[:, c]) <= BAR, c
    _, s_src = tlc.prop8seis(*SRC, prod["tp8"], nt=NT, device=CPU)
    assert _rel(s_src, prod["p8"]["obs_seis"]) <= BAR


@pytest.mark.parametrize("mistype", ["L2", "OT"])
def test_objectives_match_jax_at_production_damping(prod, mistype):
    """optfunc_L2 and optfunc_OT, loc only, at M_LOC: the misfit within BAR
    relative and the gradient within BAR of its max of the JAX package's."""
    fn_t, fn_j = {"L2": (tlc.optfunc_L2, jlc.optfunc_L2),
                  "OT": (tlc.optfunc_OT, jlc.optfunc_OT)}[mistype]
    invopt = dict(prod["torch"]["invopt"], mistype=mistype)
    got = fn_t(M_LOC, dict(prod["torch"], invopt=invopt))
    want = fn_j(M_LOC, dict(prod["jax"], invopt=invopt))
    assert abs(got[0] - want[0]) <= BAR * abs(want[0])
    assert _rel(got[1], want[1]) <= BAR
    tlc.init()
    jlc.init()


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_moment_ls_matches_jax_at_production_damping(prod, noise):
    """Moment_LS at X0, away from the source, on the observed data plus
    ``noise`` times their peak in Gaussian noise (default_rng(1)): within
    BAR of the JAX package's solution, of its max. Neither is the truth
    there."""
    obs = prod["p8"]["obs_seis"]
    obs = obs + noise * np.abs(obs).max() * np.random.default_rng(1).standard_normal(obs.shape)
    got = tlc.Moment_LS(list(X0), dict(prod["tp8"], obs_seis=obs), device=CPU)
    want = jlc.Moment_LS(list(X0), dict(prod["p8"], obs_seis=obs))
    assert _rel(got, want) <= BAR
