"""Parity of the port's fingerprint module with the JAX package (CPU, float64).

The CUDA kernel against its plain version is in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveform_ot_torch.ops import cuda_distance
from waveform_ot_torch.ops import fingerprint as tfp
from waveform_ot_tpu.ops import fingerprint as jfp

T = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64).copy())


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    """On the CPU the port takes the plain versions: no kernel launches."""
    before = cuda_distance.LAUNCHES
    yield
    assert cuda_distance.LAUNCHES == before


def _traces(rng, bsz, nt, wiggle=7.0):
    t = np.linspace(0.0, 1.0, nt)
    w = (np.sin(wiggle * t[None] + rng.standard_normal((bsz, 1)))
         + 0.05 * rng.standard_normal((bsz, nt)))
    return t, w


def _windows(rng, bsz):
    u0 = -1.4 - 0.2 * rng.random(bsz)
    u1 = 1.4 + 0.2 * rng.random(bsz)
    return u0, u1


def _problem(rng, bsz, nt, nu, ntg):
    """Normalized vertices and grids of ``bsz`` noisy traces, both sides."""
    t, w = _traces(rng, bsz, nt)
    u0, u1 = _windows(rng, bsz)
    spec_t = tfp.FingerprintSpec(nu=nu, ntg=ntg)
    win = tfp.make_window(0.0, 1.0, 0.0, 0.0)._replace(u0=T(u0), u1=T(u1))
    verts = tfp.normalize_vertices(T(t), T(w), win)
    tg, ug = tfp.grid_axes(T(t), win, spec_t)
    return t, w, u0, u1, verts, tg.expand(bsz, ntg), ug.expand(bsz, nu)


def _assert_grid_close(got, ref):
    assert got[0] == ref[0] and got[-1] == ref[-1]
    scale = np.spacing(max(abs(ref[0]), abs(ref[-1])))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2 * scale)


@pytest.mark.parametrize("theta", [None, 45.0, 30.0])
def test_grid_axes_and_vertices_match_jax(theta):
    """grid_axes writes jnp.linspace's expression start*(1-s) + stop*s with
    the last point exactly ``stop``. XLA's CPU compiler rewrites it
    (reciprocal of div, reassociation, FMA), so the JAX grid itself is off
    that expression by an ulp or two of the axis scale: the bar is 2 ulp of
    max(|start|, |stop|). Vertices agree to 1e-15."""
    rng = np.random.default_rng(4)
    bsz, nt = 3, 33
    t, w = _traces(rng, bsz, nt)
    t = t * 3.7 - 1.1
    u0, u1 = _windows(rng, bsz)
    win = tfp.make_window(-1.3, 2.9, 0.0, 0.0, theta=theta)._replace(
        u0=T(u0), u1=T(u1))
    for nu, ntg in ((79, 61), (80, 512), (37, 301)):
        spec = tfp.FingerprintSpec(nu=nu, ntg=ntg)
        tg, ug = tfp.grid_axes(T(t), win, spec)
        tv = tfp.normalize_vertices(T(t), T(w), win)
        for b in range(bsz):
            jw = jfp.make_window(-1.3, 2.9, u0[b], u1[b], theta=theta)
            assert float(win.tantheta) == float(jw.tantheta)
            jtg, jug = jfp.grid_axes(jnp.asarray(t), jw, spec)
            _assert_grid_close(tg.numpy(), np.asarray(jtg))
            _assert_grid_close(ug.numpy(), np.asarray(jug))
            jv = jfp.normalize_vertices(jnp.asarray(t), jnp.asarray(w[b]), jw)
            np.testing.assert_allclose(tv[b].numpy(), np.asarray(jv),
                                       rtol=1e-15, atol=1e-15)


def _assert_fields_agree(a, b, tol):
    """The bars of the JAX package's kernel tests: d to rtol ``tol``;
    winners differ only at exact ties; lam and dvec to ``tol`` where the
    winners agree."""
    ad, bd = np.asarray(a.d), np.asarray(b.d)
    np.testing.assert_allclose(ad, bd, rtol=tol, atol=1e-15)
    same = np.asarray(a.iclose) == np.asarray(b.iclose)
    assert np.abs(np.where(same, 0.0, ad - bd)).max() <= tol * max(1.0, np.abs(bd).max())
    assert np.abs(np.where(same, np.asarray(a.lam) - np.asarray(b.lam), 0.0)).max() <= tol
    dv = np.asarray(a.dvec) - np.asarray(b.dvec)
    assert np.abs(np.where(same[..., None], dv, 0.0)).max() <= tol
    return same


@pytest.mark.parametrize("nt,nu,ntg,chunk_pairs", [
    (40, 24, 40, None),          # one chunk of grid points
    (301, 37, 301, 1 << 14),     # odd grid, many chunks of grid points
    (61, 79, 61, 5000),          # loc/CMT grid, ragged last chunk
    (512, 9, 64, 1 << 13),       # Ricker's 511 segments, 8 points per chunk
])
def test_distance_field_torch_matches_jnp(monkeypatch, nt, nu, ntg, chunk_pairs):
    if chunk_pairs is not None:
        monkeypatch.setattr(tfp, "_PAIRS_PER_CHUNK", chunk_pairs)
    rng = np.random.default_rng(nt)
    bsz = 2
    _, _, _, _, verts, tg, ug = _problem(rng, bsz, nt, nu, ntg)
    fld = tfp.distance_field_torch(verts, tg, ug)
    assert fld.iclose.dtype == torch.int32
    assert fld.d.shape == (bsz, nu, ntg) and fld.dvec.shape == (bsz, nu, ntg, 2)
    for b in range(bsz):
        ref = jfp._distance_field_jnp(jnp.asarray(verts[b].numpy()),
                                      jnp.asarray(tg[b].numpy()),
                                      jnp.asarray(ug[b].numpy()))
        got = jfp.DistanceField(*(x[b].numpy() for x in fld))
        _assert_fields_agree(got, ref, 1e-12)


def test_distance_field_dispatch_on_cpu_uses_plain_version():
    rng = np.random.default_rng(5)
    _, _, _, _, verts, tg, ug = _problem(rng, 2, 20, 9, 11)
    a = tfp.distance_field(verts, tg, ug)
    b = tfp.distance_field_torch(verts, tg, ug)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_distance_field_diff_vjp_matches_jax():
    """Envelope backward w.r.t. vertices and both grid axes, 1e-12."""
    rng = np.random.default_rng(6)
    bsz, nt, nu, ntg = 3, 25, 14, 19
    _, _, _, _, verts, tg, ug = _problem(rng, bsz, nt, nu, ntg)
    gbar = rng.standard_normal((bsz, nu, ntg))
    args = [x.clone().requires_grad_(True) for x in (verts, tg, ug)]
    d = tfp.distance_field_diff(*args)
    grads = torch.autograd.grad(d, args, grad_outputs=T(gbar))
    for b in range(bsz):
        jargs = [jnp.asarray(x[b].detach().numpy()) for x in args]
        jd, vjp = jax.vjp(lambda v, t_, u_: jfp.distance_field_diff(v, t_, u_, "jnp"),
                          *jargs)
        np.testing.assert_allclose(d[b].detach().numpy(), np.asarray(jd), rtol=1e-12)
        for tg_, jg in zip(grads, vjp(jnp.asarray(gbar[b]))):
            np.testing.assert_allclose(tg_[b].numpy(), np.asarray(jg),
                                       rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("q", [None, 2])
def test_fingerprint_density_and_gradient_match_jax(q):
    """Density 1e-13 and the gradient of a scalar of it w.r.t. the waveform,
    its time axis and the window bounds against jax.grad, 1e-12."""
    rng = np.random.default_rng(7)
    bsz, nt, nu, ntg = 2, 21, 12, 17
    t, w = _traces(rng, bsz, nt)
    u0, u1 = _windows(rng, bsz)
    spec = tfp.FingerprintSpec(nu=nu, ntg=ntg)
    weight = rng.random((bsz, nu, ntg))
    tt, tw, tu0, tu1 = (T(a).requires_grad_(True) for a in (t, w, u0, u1))
    win = tfp.make_window(0.0, 1.0, 0.0, 0.0)._replace(u0=tu0, u1=tu1)
    pdf, (tg, ug) = tfp.fingerprint_density(tt, tw, win, spec, lambdav=0.04, q=q)
    assert tg.shape == (bsz, ntg) and ug.shape == (bsz, nu)
    loss = (pdf * T(weight)).sum()
    gt, gw, gu0, gu1 = torch.autograd.grad(loss, (tt, tw, tu0, tu1))
    gt_sum = np.zeros(nt)
    for b in range(bsz):
        def jloss(t_, w_, a, c):
            jw = jfp.make_window(0.0, 1.0, a, c)
            p, _ = jfp.fingerprint_density(t_, w_, jw, spec, lambdav=0.04, q=q,
                                           impl="jnp")
            return jnp.sum(p * weight[b]), p
        (_, jp), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
            jnp.asarray(t), jnp.asarray(w[b]), u0[b], u1[b])
        np.testing.assert_allclose(pdf[b].detach().numpy(), np.asarray(jp),
                                   rtol=1e-13, atol=1e-15)
        np.testing.assert_allclose(gw[b].numpy(), np.asarray(jg[1]), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(gu0[b].item(), float(jg[2]), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(gu1[b].item(), float(jg[3]), rtol=1e-12, atol=1e-12)
        gt_sum += np.asarray(jg[0])
    np.testing.assert_allclose(gt.numpy(), gt_sum, rtol=1e-12, atol=1e-12)


def test_density_rejects_unknown_exponent():
    from waveform_ot_torch.ops import errors
    with pytest.raises(errors.FingerprintMethodError):
        tfp.density_from_distance(torch.zeros(1, 2, 2), 0.04, q=3)
