"""End-to-end parity of the port's loc/CMT and Ricker objectives with the
JAX package (CPU, float64): problems are built in JAX, carried over by
``waveform_ot_torch.convert`` and evaluated on both sides, and the port's
own problem builders are held against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from __graft_entry__ import _build_problem
from waveform_ot_torch import convert
from waveform_ot_torch.inversion import (
    InvOptions as TInvOptions, LocCMTObjective, RickerObjective,
    TraceConfig as TTraceConfig,
    build_loc_cmt_problem as t_build_loc_cmt_problem, loc_cmt_value_and_grad
    as t_loc_cmt_value_and_grad, ricker_value_and_grad as t_ricker_value_and_grad,
)
from waveform_ot_torch.inversion.loc_cmt import _clamp_depth_straight_through
from waveform_ot_torch.models import StationSet as TStationSet
from waveform_ot_torch.models import (
    moment_tensor_from_sdr as t_sdr, mxyz_from_upper as t_mxyz,
    synthetic_seismograms as t_seis,
)
from waveform_ot_torch.ops import cuda_distance
from waveform_ot_tpu.inversion import (
    InvOptions, build_target, loc_cmt_value_and_grad, make_ricker_problem,
    ricker_value_and_grad,
)
from waveform_ot_tpu.inversion.pipeline import TraceConfig, grid6_to_window
from waveform_ot_tpu.models import (
    StationSet, moment_tensor_from_sdr, mxyz_from_upper, synthetic_seismograms,
)

NR = 4   # 12 traces on the 79x61 loc/CMT grid


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    """On the CPU the port takes the plain versions: no kernel launches."""
    before = cuda_distance.LAUNCHES
    yield
    assert cuda_distance.LAUNCHES == before


@pytest.fixture(scope="module")
def jax_loc():
    """The bench problem at NR stations, built and evaluated by JAX."""
    loc, cfg, prob = _build_problem(nr=NR, impl="jnp", dtype=jnp.float64)
    opts = InvOptions(loc=True, cmt=False, mistype="OT")
    m = loc + jnp.asarray([4.0, -3.0, 2.0], jnp.float64)
    v, g = jax.jit(lambda mm, pp: loc_cmt_value_and_grad(mm, pp, opts, cfg,
                                                         impl="jnp"))(m, prob)
    return loc, cfg, prob, np.asarray(m), float(v), np.asarray(g)


def _t_cfg(cfg):
    return TTraceConfig(nu=cfg.nu, ntg=cfg.ntg, lambdav=cfg.lambdav, q=cfg.q, p=cfg.p)


def _assert_value_grad(v, g, ref_v, ref_g):
    """value rtol 1e-10; gradient within 1e-8 of max |g|."""
    np.testing.assert_allclose(float(v), ref_v, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(g), ref_g, rtol=0,
                               atol=1e-8 * np.abs(ref_g).max())


def test_loc_cmt_value_and_grad_matches_jax(jax_loc):
    _, cfg, prob, m, ref_v, ref_g = jax_loc
    tprob = convert.loc_cmt_problem(prob)
    assert tprob.targets.t.pdf.shape == (3 * NR, cfg.ntg)
    v, g = t_loc_cmt_value_and_grad(torch.tensor(m), tprob, TInvOptions(),
                                    _t_cfg(cfg))
    _assert_value_grad(v, g, ref_v, ref_g)


@pytest.mark.parametrize("opts", [
    dict(cmt=True, precon=True, wopt="Wu"),      # 9 parameters, preconditioned
    dict(loc=False, cmt=True, wopt="Wt"),        # moment tensor only
    dict(mistype="L2"),
], ids=["loc_cmt_precon_Wu", "cmt_only_Wt", "L2"])
def test_loc_cmt_options_match_jax(jax_loc, opts):
    """The InvOptions switches: value rtol 1e-10, gradient 1e-8 of max |g|."""
    _, cfg, prob, m, _, _ = jax_loc
    rng = np.random.default_rng(12)
    upper = np.asarray(prob.mxyz_fixed)[np.triu_indices(3)]
    mm = np.concatenate([m, upper]) if opts.get("cmt") else m
    if opts.get("loc") is False:
        mm = upper * (1.0 + 0.1 * rng.standard_normal(6))
        prob = prob._replace(mref=jnp.asarray(m))
    mscal = 1.0 + 0.1 * rng.random(mm.shape[0])
    if opts.get("precon"):
        prob = prob._replace(mscal=jnp.asarray(mscal))
        mm = mm / mscal
    jo = InvOptions(**opts)
    ref_v, ref_g = jax.jit(lambda a, pp: loc_cmt_value_and_grad(a, pp, jo, cfg,
                                                                impl="jnp"))(
        jnp.asarray(mm), prob)
    v, g = t_loc_cmt_value_and_grad(torch.tensor(mm), convert.loc_cmt_problem(prob),
                                    TInvOptions(**opts), _t_cfg(cfg))
    assert g.shape == (mm.shape[0],)
    _assert_value_grad(v, g, float(ref_v), np.asarray(ref_g))


def test_loc_cmt_objective_module(jax_loc):
    """LocCMTObjective holds the problem as buffers; .to() moves and casts it."""
    _, cfg, prob, m, ref_v, ref_g = jax_loc
    obj = LocCMTObjective(convert.loc_cmt_problem(prob, dtype=torch.float32),
                          TInvOptions(), _t_cfg(cfg))
    assert all(b.dtype == torch.float32 for b in obj.buffers())
    obj = obj.double()
    assert obj.tree().targets.u.cdf.dtype == torch.float64
    mt = torch.tensor(m)
    np.testing.assert_allclose(obj(mt).item(), ref_v, rtol=1e-6)  # problem rounded via f32
    v, g = obj.value_and_grad(mt)
    assert torch.isfinite(g).all() and v.item() == obj(mt).item()


def test_port_builds_the_same_loc_problem(jax_loc):
    """The port's build_loc_cmt_problem and chip_smoke's bench builder give
    JAX's windows and targets (1e-12) and its value and gradient."""
    _, cfg, prob, m, ref_v, ref_g = jax_loc
    jp = convert.loc_cmt_problem(prob)
    loc, tcfg, tp = chip_smoke.build_loc64_problem(NR, torch.float64, torch.device("cpu"))
    np.testing.assert_allclose(tp.seis_obs.numpy(), jp.seis_obs.numpy(), rtol=0,
                               atol=1e-12 * jp.seis_obs.abs().max().item())
    # targets built by the port from JAX's observed seismograms
    tp2 = t_build_loc_cmt_problem(jp.t, jp.seis_obs, jp.stations, tcfg,
                                  mxyz_fixed=jp.mxyz_fixed)
    for a, b in ((tp.windows, jp.windows), (tp2.windows, jp.windows)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12, atol=1e-14)
    for dens in ("t", "u"):
        for f in ("amp", "pdf", "x", "cdf"):
            y = getattr(getattr(jp.targets, dens), f).numpy()
            x = getattr(getattr(tp2.targets, dens), f).numpy()
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-14, err_msg=dens + f)
    v, g = t_loc_cmt_value_and_grad(torch.tensor(m), tp, TInvOptions(), tcfg)
    np.testing.assert_allclose(v.item(), ref_v, rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=0, atol=1e-7 * np.abs(ref_g).max())


def test_seismograms_and_moment_tensor_match_jax():
    rng = np.random.default_rng(11)
    ang = rng.random(5) * 2 * np.pi
    sx, sy = 50 * np.cos(ang), 50 * np.sin(ang)
    vals = rng.standard_normal(6)
    jm = mxyz_from_upper(jnp.asarray(vals))
    tm = t_mxyz(torch.from_numpy(vals))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    jsdr = moment_tensor_from_sdr(30.0, 60.0, 45.0, m0=5.0e6)
    tsdr = t_sdr(30.0, 60.0, 45.0, m0=5.0e6)
    np.testing.assert_allclose(tsdr.numpy(), np.asarray(jsdr), rtol=1e-13, atol=1e-6)
    jt, js = synthetic_seismograms(1.5, -2.0, 9.0, jsdr,
                                   StationSet(jnp.asarray(sx), jnp.asarray(sy)), nt=40)
    x, y, z = (torch.tensor(v, dtype=torch.float64) for v in (1.5, -2.0, 9.0))
    tt, ts = t_seis(x, y, z, tsdr, TStationSet(torch.from_numpy(sx), torch.from_numpy(sy)),
                    nt=40)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-15)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(js)).max())


def test_depth_clamp_is_straight_through():
    z = torch.tensor([-0.5, 0.0005, 2.0], dtype=torch.float64, requires_grad=True)
    out = _clamp_depth_straight_through(z, 0.001)
    # z - (z - max(z, zmin)), as in JAX: the floor up to rounding
    np.testing.assert_allclose(out.detach().numpy(), [0.001, 0.001, 2.0], rtol=1e-15)
    (g,) = torch.autograd.grad(out.sum(), z)
    np.testing.assert_array_equal(g.numpy(), [1.0, 1.0, 1.0])


@pytest.fixture(scope="module")
def jax_ricker(golden):
    gd = golden["ricker_full"]
    win, spec = grid6_to_window(gd["grid"])
    cfg = TraceConfig(nu=spec.nu, ntg=spec.ntg, lambdav=gd["lambdav"], q=None,
                      p=2, transform=True)
    targets = build_target(jnp.array(gd["tobs"]), jnp.array(gd["wobs"]), win, cfg,
                           impl="jnp")
    prob, cfg = make_ricker_problem(targets, gd["grid"], trange=(-2.0, 7.0),
                                    alpha=0.5, lambdav=gd["lambdav"])
    return prob, cfg


def test_ricker_golden_values(golden):
    """The port alone (its own target build) against the golden reference:
    w2 within 1e-8, gradient within 5e-7, the JAX package's bars."""
    prob, cfg = chip_smoke.build_ricker_problem(golden, torch.float64,
                                                torch.device("cpu"))
    w2, dm = t_ricker_value_and_grad(torch.tensor([0.5, 1.2, 1.1], dtype=torch.float64),
                                     prob, cfg)
    ref = golden["ricker_obj"]
    assert abs(w2.item() - ref["w2"]) <= 1e-8
    np.testing.assert_allclose(dm.numpy(), ref["deriv"], atol=5e-7)


def test_ricker_converted_problem_matches_jax(jax_ricker):
    """A JAX RickerProblem carried over by convert gives JAX's value
    (rtol 1e-10) and gradient (1e-8 of max |g|), also through the module."""
    prob, cfg = jax_ricker
    m = jnp.array([0.7, 1.1, 1.3])
    ref_v, ref_g = jax.jit(lambda mm: ricker_value_and_grad(mm, prob, cfg,
                                                            impl="jnp"))(m)
    tprob = convert.ricker_problem(prob)
    tcfg = TTraceConfig(nu=cfg.nu, ntg=cfg.ntg, lambdav=cfg.lambdav, q=cfg.q,
                        p=cfg.p, transform=cfg.transform)
    v, g = t_ricker_value_and_grad(torch.tensor(np.asarray(m)), tprob, tcfg)
    _assert_value_grad(v, g, float(ref_v), np.asarray(ref_g))
    obj = RickerObjective(tprob, tcfg)
    v2, g2 = obj.value_and_grad(torch.tensor(np.asarray(m)))
    assert v2.item() == v.item() and torch.equal(g2, g)
