"""The port's parallel layer against the JAX package's (CPU, float64).

The JAX side runs on the conftest's 8 virtual CPU devices, the port on
``make_mesh(8, device="cpu")``: eight shards on the one CPU, the port's
counterpart of the forced host device count. Inputs come from numpy seeds
and reach both packages as the same numbers. Each test states its tolerance.

JAX's dp x sp gradient raises at trace time (a shard_map type check on the
amplitude axis's cotangent, see ROADMAP), so the port's dp x sp gradient is
held against jax.grad of the single-device pipeline, the JAX test's own
reference. The layered case damps at alpha = 0.1, where the two packages'
layered physics agree to 1e-9 (tests/test_torch_layered.py says why not at
the production 0.023).
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveform_ot_torch import inversion as ti
from waveform_ot_torch import models as tm
from waveform_ot_torch import parallel as tp
from waveform_ot_torch.inversion.pipeline import trace_misfit as t_trace_misfit
from waveform_ot_torch.models import layered as TL
from waveform_ot_torch.ops import cuda_distance
from waveform_ot_torch.ops import make_density_1d as t_density
from waveform_ot_torch.ops import wasserstein_1d as t_wasserstein_1d
from waveform_ot_tpu import inversion as ji
from waveform_ot_tpu import models as jm
from waveform_ot_tpu import parallel as jp
from waveform_ot_tpu.inversion.pipeline import trace_misfit as j_trace_misfit
from waveform_ot_tpu.inversion.windows import unit_amplitude_windows as j_unit_windows
from waveform_ot_tpu.models import layered as JL
from waveform_ot_tpu.ops import make_density_1d as j_density
from waveform_ot_tpu.ops import wasserstein_1d as j_wasserstein_1d
from waveform_ot_tpu.ops.fingerprint import density_from_distance, distance_field_diff
from waveform_ot_tpu.ops.marginal import marg_wasserstein_value as j_marg
from waveform_ot_tpu.ops.transforms import arctan_transform as j_arctan

CPU, F64 = torch.device("cpu"), torch.float64
OPTS_T, OPTS_J = ti.InvOptions(loc=True, cmt=False), ji.InvOptions(loc=True, cmt=False)
LAYERED_ALPHA = 0.1          # the damping of the layered parity tests (module note)


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    before = cuda_distance.LAUNCHES
    yield
    assert cuda_distance.LAUNCHES == before


@pytest.fixture(scope="module")
def mesh8():
    return tp.make_mesh(8, device="cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _j(a):
    return jnp.asarray(np.asarray(a))


def _loc_cmt_pair(nr, nt, nu, dt=1.0):
    """The far-field loc/CMT problem of tests/test_parallel.py (nr stations on
    a 60 km circle, source (2, -1.5, 12), 30/60/45, M0 5e6, noise
    0.002 max|s| from default_rng(0)) built by both packages from the same
    observed seismograms: (port problem, JAX problem, port cfg, JAX cfg)."""
    ang = np.linspace(0, 2 * np.pi, nr, endpoint=False)
    sx, sy = 60.0 * np.cos(ang), 60.0 * np.sin(ang)
    mxyz = tm.moment_tensor_from_sdr(30.0, 60.0, 45.0, m0=5.0e6, device=CPU).to(F64)
    st = tm.StationSet(x=_t(sx), y=_t(sy))
    t, s = tm.synthetic_seismograms(*_t([2.0, -1.5, 12.0]), mxyz, st, nt=nt, dt=dt)
    rng = np.random.default_rng(0)
    obs = s.numpy() + 0.002 * float(s.abs().max()) * rng.standard_normal(tuple(s.shape))
    tcfg = ti.TraceConfig(nu=nu, ntg=nt, lambdav=0.04, q=None, p=2)
    jcfg = ji.TraceConfig(nu=nu, ntg=nt, lambdav=0.04, q=None, p=2)
    tprob = ti.build_loc_cmt_problem(t, _t(obs), st, tcfg, mxyz_fixed=mxyz)
    jprob = ji.build_loc_cmt_problem(_j(t), _j(obs), jm.StationSet(x=_j(sx), y=_j(sy)),
                                     jcfg, mxyz_fixed=_j(mxyz), impl="jnp")
    return tprob, jprob, tcfg, jcfg


@pytest.fixture(scope="module")
def batch_pair():
    """tests/test_parallel.py's batch_problem: 16 stations, nt 61, 79x61."""
    return _loc_cmt_pair(16, 61, 79)


def test_sharded_sum_matches_jax(batch_pair, mesh8):
    """The 48 traces' summed marginal misfit, sharded 6 per shard: the
    port's sharded_sum of a batched trace_misfit against JAX's sharded_sum of
    its per-trace one, 1e-10 relative."""
    tprob, jprob, tcfg, jcfg = batch_pair
    nr, nc, nt = tprob.seis_obs.shape
    cfg_fp = ti.TraceConfig(nu=79, ntg=nt, lambdav=0.04, q=None, p=2, transform=False)
    jcfg_fp = ji.TraceConfig(nu=79, ntg=nt, lambdav=0.04, q=None, p=2, transform=False)

    un = j_arctan(jprob.seis_obs, jprob.windows.u0[..., None], jprob.windows.u1[..., None])
    jwin = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (nr, nc)).reshape(nr * nc),
                                  j_unit_windows(jprob.windows))

    def j_item(item, t):
        wt, wu = j_trace_misfit(t, *item, jcfg_fp, impl="jnp")
        return 0.5 * (wt + wu)

    jmesh = jp.make_mesh()
    ref = float(jax.jit(jp.sharded_sum(j_item, jmesh))(
        jp.shard_leading_axis((un.reshape(nr * nc, nt), jwin, jprob.targets), jmesh),
        *jp.replicate((jprob.t,), jmesh)))

    from waveform_ot_torch.inversion.loc_cmt import _flat_unit_windows
    from waveform_ot_torch.ops import arctan_transform

    tun = arctan_transform(tprob.seis_obs, tprob.windows.u0[..., None],
                           tprob.windows.u1[..., None])

    def t_batch(batch, t):
        wt, wu = t_trace_misfit(t, *batch, cfg_fp)
        return 0.5 * (wt + wu)

    batch = tp.shard_leading_axis(
        (tun.reshape(nr * nc, nt), _flat_unit_windows(tprob.windows, nr, nc),
         tprob.targets), mesh8)
    assert all(p[0].shape[0] == 6 for p in batch.parts)
    got = tp.sharded_sum(t_batch, mesh8)(batch, tprob.t)
    assert got.device == CPU and got.dim() == 0
    assert abs(got.item() - ref) <= 1e-10 * max(1.0, abs(ref))


def test_sharded_map_matches_jax(mesh8):
    """sharded_map of a per-trace W2 against one replicated target: 16
    source densities, 2 per shard. The port's fn takes a shard's slice, JAX's
    per_item_fn one item (vmapped per shard); the per-item outputs, gathered,
    within 1e-12 relative, and each shard holds its own slice's."""
    rng = np.random.default_rng(13)
    f, g = rng.random((16, 10)) + 0.05, rng.random(12) + 0.05
    xf, xg = np.sort(rng.standard_normal((16, 10)), axis=-1), np.sort(rng.standard_normal(12))
    jmesh = jp.make_mesh()
    ref = np.asarray(jax.jit(jp.sharded_map(
        lambda item, gg, yy: j_wasserstein_1d(item[0], item[1], gg, yy, 2), jmesh))(
        jp.shard_leading_axis((_j(f), _j(xf)), jmesh), *jp.replicate((_j(g), _j(xg)), jmesh)))

    def t_batch(batch, gg, yy):
        ff, xx = batch
        return t_wasserstein_1d(ff, xx, gg.expand(len(ff), -1), yy.expand(len(ff), -1), 2)

    got = tp.sharded_map(t_batch, mesh8)((_t(f), _t(xf)), _t(g), _t(xg))
    assert [p.shape for p in got.parts] == [(2,)] * 8
    np.testing.assert_allclose(got.gather().numpy(), ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("placement", ["replicated", "whole"])
def test_trace_sharded_objective_matches_jax(batch_pair, mesh8, placement):
    """The loc/CMT objective with its traces sharded over 8 shards, value and
    gradient through pjit_batched_misfit (autograd through the psum of the
    replicated model), against JAX's jit over its sharded problem: value
    1e-10 relative, gradient rtol 1e-8. ``replicated`` passes the problem as
    it is (the port splits its traces itself), ``whole`` places it by JAX's
    rule first."""
    tprob, jprob, tcfg, jcfg = batch_pair
    m = np.array([2.0, -1.5, 12.0]) + np.array([4.0, -3.0, 2.0])
    jmesh = jp.make_mesh()
    jsh = jprob._replace(targets=jp.shard_leading_axis(jprob.targets, jmesh))
    v0, g0 = jax.jit(lambda mm, pp: ji.loc_cmt_value_and_grad(mm, pp, OPTS_J, jcfg,
                                                              impl="jnp"))(
        jp.replicate(_j(m), jmesh), jsh)

    f = tp.pjit_batched_misfit(lambda mm, pp: ti.loc_cmt_misfit(mm, pp, OPTS_T, tcfg), mesh8)
    placed = tp.shard_leading_axis(tprob, mesh8) if placement == "whole" else tprob
    mt = _t(m).requires_grad_(True)
    v1 = f(tp.replicate(mt, mesh8), placed)
    (g1,) = torch.autograd.grad(v1, mt)
    assert abs(v1.item() - float(v0)) <= 1e-10 * max(1.0, abs(float(v0)))
    np.testing.assert_allclose(g1.numpy(), np.asarray(g0), rtol=1e-8)


def test_pjit_gathers_split_leaves_that_are_not_traces():
    """JAX's rule splits every leaf whose leading axis the mesh divides: on
    3 shards with 6 stations and nt 33, also t (33,), mref (3,) and
    mxyz_fixed (3, 3). The port gathers those before each shard evaluates, so
    the sharded value and gradient equal JAX's jit over the same placement
    (1e-10, rtol 1e-8) and the port's unsharded call (1e-12)."""
    tprob, jprob, tcfg, jcfg = _loc_cmt_pair(6, 33, 15, dt=2.0)
    mesh3 = tp.make_mesh(3, device="cpu")
    placed = tp.shard_leading_axis(tprob, mesh3)
    assert (placed.axes.t, placed.axes.mref, placed.axes.mxyz_fixed) == (0, 0, 0)
    m = np.array([2.0, -1.5, 12.0]) + np.array([3.0, 2.0, -1.0])
    jmesh = jp.make_mesh(3)
    v0, g0 = jax.jit(lambda mm, pp: ji.loc_cmt_value_and_grad(mm, pp, OPTS_J, jcfg,
                                                              impl="jnp"))(
        jp.replicate(_j(m), jmesh), jp.shard_leading_axis(jprob, jmesh))

    f = tp.pjit_batched_misfit(lambda mm, pp: ti.loc_cmt_misfit(mm, pp, OPTS_T, tcfg), mesh3)
    mt = _t(m).requires_grad_(True)
    v1 = f(mt, placed)
    (g1,) = torch.autograd.grad(v1, mt)
    v2, g2 = ti.loc_cmt_value_and_grad(_t(m), tprob, OPTS_T, tcfg)
    assert abs(v1.item() - float(v0)) <= 1e-10 * abs(float(v0))
    np.testing.assert_allclose(g1.numpy(), np.asarray(g0), rtol=1e-8)
    assert abs(v1.item() - v2.item()) <= 1e-12 * abs(v2.item())
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=0, atol=1e-12 * g2.abs().max())


def test_pjit_rejects_a_mesh_that_does_not_divide_the_stations(batch_pair):
    tprob, _, tcfg, _ = batch_pair
    f = tp.pjit_batched_misfit(lambda mm, pp: ti.loc_cmt_misfit(mm, pp, OPTS_T, tcfg),
                               tp.make_mesh(3, device="cpu"))
    with pytest.raises(ValueError, match="does not split into 3 shards"):
        f(_t([2.0, -1.5, 12.0]), tprob)


def test_misfit_grid_sharded_matches_jax():
    """8 model nodes, one per shard, on tests/test_parallel.py's tiny problem
    (2 stations, nt 31, dt 2, 16x31): JAX's misfit_grid_sharded, 1e-12; the
    result stays on the 8 shards until gathered."""
    tprob, jprob, tcfg, jcfg = _loc_cmt_pair(2, 31, 16, dt=2.0)
    rng = np.random.default_rng(0)
    ms = np.array([2.0, -1.5, 12.0]) + 5.0 * rng.standard_normal((8, 3))
    jmesh = jp.make_mesh()
    ref = jax.jit(lambda m_, p_: ji.loc_cmt.misfit_grid_sharded(
        m_, p_, OPTS_J, jcfg, jmesh, impl="jnp"))(jp.shard_leading_axis(_j(ms), jmesh),
                                                  jp.replicate(jprob, jmesh))
    got = ti.misfit_grid_sharded(_t(ms), tprob, OPTS_T, tcfg, tp.make_mesh(8, device="cpu"))
    assert len(got.parts) == 8 and all(p.shape == (1,) for p in got.parts)
    np.testing.assert_allclose(got.gather().numpy(), np.asarray(ref), rtol=1e-12)


def _grid_problem(rng, ntg=128, nu=24, nt=40):
    """TestGridSharded._problem: a noisy sine polyline, 24x128 grid on the
    unit box, random positive target marginals."""
    t = np.linspace(0.0, 1.0, nt)
    w = 0.4 + 0.2 * np.sin(4 * np.pi * t) + 0.02 * rng.standard_normal(nt)
    return (np.stack([t, w], 1), np.linspace(0.0, 1.0, ntg), np.linspace(0.0, 1.0, nu),
            rng.random(ntg) + 0.1, rng.random(nu) + 0.1)


def test_grid_sharded_marg_misfit_matches_jax(rng, mesh8):
    """The 128 grid columns in 8 blocks of 16: (wt, wu) against JAX's
    grid_sharded_marg_misfit at 1e-12, the gradients of 0.5 (wt + wu) w.r.t.
    the polyline and the time shift against JAX's at 1e-11."""
    verts, tgrid, ugrid, tt, uu = _grid_problem(rng)
    jmesh = jp.make_mesh(axis_name="seq")
    jfn = jp.grid_sharded_marg_misfit(jmesh, lambdav=0.04, q=None, p=2, impl="jnp")
    jtg = jp.shard_grid_axis(_j(tgrid), jmesh)
    jtt, jtu = j_density(_j(tt), _j(tgrid)), j_density(_j(uu), _j(ugrid))

    def jobj(v, ts):
        wt, wu = jfn(v, jtg, _j(ugrid), jtt, jtu, ts)
        return 0.5 * wt + 0.5 * wu

    jwt, jwu = jax.jit(jfn)(_j(verts), jtg, _j(ugrid), jtt, jtu, jnp.asarray(0.0))
    jgv, jgt = jax.jit(jax.grad(jobj, argnums=(0, 1)))(_j(verts), jnp.asarray(0.0))

    mesh = tp.make_mesh(8, axis_name="seq", device="cpu")
    fn = tp.grid_sharded_marg_misfit(mesh, lambdav=0.04, q=None, p=2)
    tg = tp.shard_grid_axis(_t(tgrid), mesh)
    assert all(p.shape == (16,) and p.is_contiguous() for p in tg.parts)
    v = _t(verts).requires_grad_(True)
    ts = torch.zeros((), dtype=F64, requires_grad=True)
    wt, wu = fn(v, tg, _t(ugrid), t_density(_t(tt), _t(tgrid)), t_density(_t(uu), _t(ugrid)), ts)
    np.testing.assert_allclose(wt.item(), float(jwt), rtol=1e-12)
    np.testing.assert_allclose(wu.item(), float(jwu), rtol=1e-12)
    gv, gt = torch.autograd.grad(0.5 * wt + 0.5 * wu, (v, ts))
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), rtol=1e-11, atol=1e-14)
    np.testing.assert_allclose(gt.item(), float(jgt), rtol=1e-11)


def test_grid_sharded_density_layout(rng, mesh8):
    """The (nu, ntg) density stays in 8 column blocks of (24, 16), one per
    shard; gathered, it equals JAX's grid_sharded_density at 1e-14."""
    verts, tgrid, ugrid, _, _ = _grid_problem(rng)
    jmesh = jp.make_mesh(axis_name="seq")
    ref = jax.jit(jp.grid_sharded_density(jmesh, lambdav=0.04, q=None, impl="jnp"))(
        _j(verts), jp.shard_grid_axis(_j(tgrid), jmesh), _j(ugrid))
    pdf = tp.grid_sharded_density(mesh8, lambdav=0.04, q=None)(
        _t(verts), tp.shard_grid_axis(_t(tgrid), mesh8), _t(ugrid))
    assert len(pdf.parts) == 8 and all(p.shape == (24, 16) for p in pdf.parts)
    full = pdf.gather()
    assert full.shape == (24, 128)
    np.testing.assert_allclose(full.numpy(), np.asarray(ref), rtol=1e-14)


def test_dp_sp_matches_jax_value_and_single_device_gradient(rng):
    """6 traces x 64 columns on a (2, 4) mesh: 3 traces per row, 16 columns
    per shard. The value against JAX's dp_sp_marg_misfit at 1e-12; the
    gradient w.r.t. the polylines against jax.grad of the single-device
    pipeline (tests/test_parallel.py's ref_total) at 1e-11."""
    ntr, nt, ntg, nu = 6, 30, 64, 16
    t = np.linspace(0.0, 1.0, nt)
    w = 0.5 + 0.2 * np.sin(4 * np.pi * t)[None, :] * rng.uniform(0.5, 1.5, (ntr, 1))
    w = w + 0.02 * rng.standard_normal((ntr, nt))
    verts = np.stack([np.broadcast_to(t, (ntr, nt)), w], axis=-1)
    tgrid, ugrid = np.linspace(0.0, 1.0, ntg), np.linspace(0.0, 1.0, nu)
    tt, uu = rng.random((ntr, ntg)) + 0.1, rng.random((ntr, nu)) + 0.1
    jtt = jax.vmap(lambda f: j_density(f, _j(tgrid)))(_j(tt))
    jtu = jax.vmap(lambda f: j_density(f, _j(ugrid)))(_j(uu))
    tshift = np.zeros(ntr)

    def ref_total(verts_b, ts_b):
        def one(v, ft, fu, ts):
            u2d = density_from_distance(distance_field_diff(v, _j(tgrid), _j(ugrid), "jnp"),
                                        0.04, q=None)
            wt, wu = j_marg(u2d, _j(tgrid), _j(ugrid), ft, fu, p=2, tshift=ts)
            return 0.5 * wt + 0.5 * wu
        return jnp.sum(jax.vmap(one)(verts_b, jtt, jtu, ts_b))

    jmesh = jp.make_mesh_2d(2, 4)
    jfn = jp.dp_sp_marg_misfit(jmesh, lambdav=0.04, q=None, p=2, alpha=0.5, impl="jnp")
    jv = jax.jit(jfn)(_j(verts), jp.shard_grid_axis(_j(tgrid), jmesh, axis_name="seq"),
                      _j(ugrid), jtt, jtu, _j(tshift))
    jg = jax.jit(jax.grad(ref_total))(_j(verts), _j(tshift))

    mesh = tp.make_mesh_2d(2, 4, device="cpu")
    fn = tp.dp_sp_marg_misfit(mesh, lambdav=0.04, q=None, p=2, alpha=0.5)
    v = _t(verts).requires_grad_(True)
    total = fn(v, tp.shard_grid_axis(_t(tgrid), mesh, axis_name="seq"), _t(ugrid),
               t_density(_t(tt), _t(tgrid)), t_density(_t(uu), _t(ugrid)), _t(tshift))
    np.testing.assert_allclose(total.item(), float(jv), rtol=1e-12)
    (g,) = torch.autograd.grad(total, v)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-11, atol=1e-14)


def _rosen_t(xs):
    return (100.0 * (xs[:, 1:] - xs[:, :-1] ** 2) ** 2 + (1 - xs[:, :-1]) ** 2).sum(-1)


def _rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


@pytest.mark.parametrize("devices", ["one", "two"])
def test_multi_start_sharded_matches_unsharded_and_jax(mesh8, devices):
    """Rosenbrock, 16 starts in 6 dimensions, 2 per shard: per lane the same
    n_iter and x within 1e-10 as the port's unsharded solve, x within 1e-6
    of JAX's minimize_multi_start_sharded. ``two`` spreads the shards over
    two distinct devices ("cpu" and "cpu:0" compare unequal), which runs
    each device's shards in a thread of its own."""
    x0 = np.random.default_rng(0).uniform(-2, 2, size=(16, 6))
    mesh = mesh8 if devices == "one" else tp.Mesh(
        (CPU, torch.device("cpu", 0)) * 4, ("batch",), (8,))
    res = ti.minimize_multi_start_sharded(_rosen_t, _t(x0), mesh, max_iter=400, tol=1e-8)
    assert len(res.parts) == 8 and all(p.x.shape == (2, 6) for p in res.parts)
    got = res.gather()
    ref = ti.minimize_lbfgs_batched(_rosen_t, _t(x0), max_iter=400, tol=1e-8)
    np.testing.assert_array_equal(got.n_iter.numpy(), ref.n_iter.numpy())
    np.testing.assert_allclose(got.x.numpy(), ref.x.numpy(), rtol=0, atol=1e-10)
    jmesh = jp.make_mesh()
    jres = jax.jit(lambda xs: ji.minimize_multi_start_sharded(
        _rosen_j, xs, jmesh, max_iter=400, tol=1e-8))(_j(x0))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(jres.x), atol=1e-6)


def test_station_sharded_layered_f64_matches_jax(mesh8):
    """The layered physics (six-layer Fukuoka) with its 8 stations sharded
    over 8 shards, at JAX's sizes (nr 8, nt 16, nk 24, 15x16 grids), placed
    by JAX's rule, which splits t (16,) too: the value and gradient through
    pjit_batched_misfit against the port's unsharded call at 1e-9 of the
    value and of max |g| (JAX's sharded-vs-single contract,
    tests/test_parallel.py; measured 0 and 1.2e-16), and against JAX's
    single-device jit at the layered parity bars of
    tests/test_torch_layered.py, 1e-9 of the value and 1e-7 of max |g|
    (measured 8.4e-10 and 1.1e-9: the two packages' physics, not the
    sharding)."""
    nr, nt, nk = 8, 16, 24
    ang = np.linspace(0, 2 * np.pi, nr, endpoint=False)
    sx, sy = 30.0 * np.cos(ang), 30.0 * np.sin(ang)
    st = tm.StationSet(x=_t(sx), y=_t(sy))
    mxyz = tm.moment_tensor_from_sdr(30.0, 60.0, 45.0, m0=5.0e6, device=CPU).to(F64)
    kw = dict(nt=nt, dt=1.0, nk=nk, kmax=1.0, alpha_damp=LAYERED_ALPHA)
    fwd = TL.make_layered_forward(model=TL.fukuoka_model(device=CPU), **kw)
    loc = np.array([2.0, -1.5, 9.0])
    s = fwd(*_t(loc), mxyz, st)
    obs = s.numpy() + 0.002 * float(s.abs().max()) * np.random.default_rng(0).standard_normal(
        tuple(s.shape))
    tcfg = ti.TraceConfig(nu=15, ntg=nt, lambdav=0.04, q=None, p=2)
    jcfg = ji.TraceConfig(nu=15, ntg=nt, lambdav=0.04, q=None, p=2)
    tprob = ti.build_loc_cmt_problem(torch.arange(nt, dtype=F64), _t(obs), st, tcfg,
                                     mxyz_fixed=mxyz)
    jprob = ji.build_loc_cmt_problem(jnp.arange(nt, dtype=jnp.float64), _j(obs),
                                     jm.StationSet(x=_j(sx), y=_j(sy)), jcfg,
                                     mxyz_fixed=_j(mxyz), impl="jnp")
    m = loc + np.array([1.0, -0.5, 0.5])
    jfwd = JL.make_layered_forward(model=JL.fukuoka_model(jnp.float64), **kw)

    def jobj(mm, pp):
        fw = lambda x, y, z, mx: jfwd(x, y, z, mx, pp.stations)
        return ji.loc_cmt_misfit(mm, pp, OPTS_J, jcfg, forward=fw, impl="jnp")

    v0, g0 = jax.jit(jax.value_and_grad(jobj))(_j(m), jprob)

    def tobj(mm, pp):
        fw = lambda x, y, z, mx: fwd(x, y, z, mx, pp.stations)
        return ti.loc_cmt_misfit(mm, pp, OPTS_T, tcfg, forward=fw)

    placed = tp.shard_leading_axis(tprob, mesh8)
    assert placed.axes.t == 0 and placed.axes.stations.x == 0
    mt = _t(m).requires_grad_(True)
    v1 = tp.pjit_batched_misfit(tobj, mesh8)(mt, placed)
    (g1,) = torch.autograd.grad(v1, mt)
    v2, g2 = ti.loc_cmt_value_and_grad(_t(m), tprob, OPTS_T, tcfg,
                                       forward=lambda x, y, z, mx: fwd(x, y, z, mx, st))
    gscale = float(np.abs(np.asarray(g0)).max())
    assert abs(v1.item() - v2.item()) <= 1e-9 * max(1.0, abs(v2.item()))
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=0, atol=1e-9 * gscale)
    assert abs(v1.item() - float(v0)) <= 1e-9 * abs(float(v0))
    np.testing.assert_allclose(g1.numpy(), np.asarray(g0), rtol=0, atol=1e-7 * gscale)


def test_make_mesh_2d_needs_enough_devices(monkeypatch):
    """JAX's make_mesh_2d raises for more devices than it has (16 of 8); the
    port's for more cards than it sees, with JAX's message, and takes a
    virtual mesh on one device."""
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        jp.make_mesh_2d(4, 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        tp.make_mesh_2d(2, 2)
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        tp.make_mesh(4)
    assert tp.make_mesh(3).devices == tuple(torch.device("cuda", i) for i in range(3))
    mesh = tp.make_mesh_2d(2, 4, device="cpu")
    assert mesh.shape == (2, 4) and mesh.axis_names == ("batch", "seq")
    assert [mesh.coord(i, "seq") for i in range(8)] == [0, 1, 2, 3] * 2


def test_replicate_copies_modules_and_keeps_functions(batch_pair):
    """replicate gives each shard its device's copy: tensors and modules
    moved once per distinct device (shards on one device share it), plain
    functions kept as they are."""
    tprob, _, tcfg, _ = batch_pair
    obj = ti.LocCMTObjective(tprob, OPTS_T, tcfg)
    mesh = tp.Mesh((CPU, torch.device("cpu", 0), CPU), ("batch",), (3,))
    rep = tp.replicate((obj, _rosen_t, tprob.t), mesh)
    assert rep.parts[0][0] is obj and rep.parts[2][0] is obj
    assert rep.parts[1][0] is not obj and rep.parts[1][1] is _rosen_t
    m = _t([[4.0, -2.0, 10.0]])
    assert torch.equal(rep.parts[1][0](m), obj(m))


def test_launch_counter_under_threads():
    """count_launch from 16 threads at once, with a short switch interval: no
    update is lost, in the total or by device."""
    total0 = cuda_distance.LAUNCHES
    by0 = dict(cuda_distance.LAUNCHES_BY_DEVICE)
    devs = [torch.device("cuda", i % 4) for i in range(16)]
    barrier = threading.Barrier(len(devs))

    def hammer(dev):
        barrier.wait()
        for _ in range(2000):
            cuda_distance.count_launch(dev)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer, args=(d,)) for d in devs]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
        added = cuda_distance.LAUNCHES - total0
        cuda_distance.LAUNCHES = total0
        by = dict(cuda_distance.LAUNCHES_BY_DEVICE)
        cuda_distance.LAUNCHES_BY_DEVICE.clear()
        cuda_distance.LAUNCHES_BY_DEVICE.update(by0)
    assert added == 16 * 2000
    assert all(by[f"cuda:{i}"] - by0.get(f"cuda:{i}", 0) == 4 * 2000 for i in range(4))
