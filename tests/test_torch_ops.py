"""Parity of the PyTorch port's leaf ops with the JAX package (CPU, float64).

Inputs come from numpy with a seed and go through the JAX function and its
port counterpart; each tolerance is stated beside its assertion.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveform_ot_torch import _build
from waveform_ot_torch.ops import cuda_distance
from waveform_ot_torch.ops import errors as t_errors
from waveform_ot_torch.ops.marginal import marg_wasserstein_value as t_marg
from waveform_ot_torch.ops.otpdf import make_density_1d as t_make_density_1d
from waveform_ot_torch.ops.otpdf import marginals_raw as t_marginals_raw
from waveform_ot_torch.ops.transforms import arctan_transform as t_arctan
from waveform_ot_torch.ops.wasser import wasserstein_1d as t_wasserstein_1d
from waveform_ot_tpu.ops import errors as j_errors
from waveform_ot_tpu.ops.marginal import marg_wasserstein_value as j_marg
from waveform_ot_tpu.ops.otpdf import make_density_1d as j_make_density_1d
from waveform_ot_tpu.ops.otpdf import marginals_raw as j_marginals_raw
from waveform_ot_tpu.ops.transforms import arctan_transform as j_arctan
from waveform_ot_tpu.ops.wasser import wasserstein_1d as j_wasserstein_1d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64).copy())


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    """On the CPU the port takes the plain versions: no kernel launches."""
    before = cuda_distance.LAUNCHES
    yield
    assert cuda_distance.LAUNCHES == before


def test_arctan_transform_matches_jax():
    rng = np.random.default_rng(1)
    u = rng.standard_normal((4, 3, 17))
    u0 = rng.standard_normal((4, 3, 1)) - 3.0
    u1 = rng.standard_normal((4, 3, 1)) + 3.0
    jv, jd = j_arctan(jnp.asarray(u), jnp.asarray(u0), jnp.asarray(u1), deriv=True)
    tv, td = t_arctan(T(u), T(u0), T(u1), deriv=True)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-14, atol=1e-14)


def test_make_density_1d_matches_jax():
    rng = np.random.default_rng(2)
    f = rng.random((5, 23)) + 0.01
    x = np.sort(rng.standard_normal((5, 23)), axis=-1)
    td = t_make_density_1d(T(f), T(x))
    for b in range(f.shape[0]):
        jd = j_make_density_1d(jnp.asarray(f[b]), jnp.asarray(x[b]))
        for name in ("amp", "pdf", "x", "cdf"):
            np.testing.assert_allclose(getattr(td, name)[b].numpy(),
                                       np.asarray(getattr(jd, name)),
                                       rtol=1e-14, atol=1e-14, err_msg=name)


def test_marginals_raw_matches_jax():
    rng = np.random.default_rng(3)
    pdf = rng.random((2, 7, 9))
    tt, tu = t_marginals_raw(T(pdf))
    for b in range(2):
        jt, ju = j_marginals_raw(jnp.asarray(pdf[b]))
        np.testing.assert_allclose(tt[b].numpy(), np.asarray(jt), rtol=1e-14)
        np.testing.assert_allclose(tu[b].numpy(), np.asarray(ju), rtol=1e-14)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("nf,ng", [(12, 12), (9, 21)])
def test_wasserstein_1d_value_and_grads_match_jax(p, nf, ng):
    """Value and all four gradients against jax.grad of the JAX custom VJP,
    rtol 1e-12, for equal and unequal support sizes."""
    rng = np.random.default_rng(10 * p + nf)
    bsz = 3
    f = rng.random((bsz, nf)) + 0.05
    g = rng.random((bsz, ng)) + 0.05
    xf = np.sort(rng.standard_normal((bsz, nf)), axis=-1)
    xg = np.sort(rng.standard_normal((bsz, ng)), axis=-1)
    args = [T(a).requires_grad_(True) for a in (f, xf, g, xg)]
    w = t_wasserstein_1d(*args, p=p)
    wbar = rng.random(bsz) + 0.5        # distinct cotangent per trace
    grads = torch.autograd.grad(w, args, grad_outputs=T(wbar))
    jfun = jax.jit(jax.value_and_grad(
        lambda *a: j_wasserstein_1d(*a, p), argnums=(0, 1, 2, 3)))
    for b in range(bsz):
        jw, jg = jfun(*(jnp.asarray(a[b]) for a in (f, xf, g, xg)))
        np.testing.assert_allclose(w[b].item(), float(jw), rtol=1e-12)
        for tg, gj, name in zip(grads, jg, ("f", "xf", "g", "xg")):
            np.testing.assert_allclose(tg[b].numpy(), wbar[b] * np.asarray(gj),
                                       rtol=1e-12, atol=1e-14, err_msg=name)


def test_marg_wasserstein_value_with_tshift_matches_jax():
    """(W_t, W_u) of batched fields with a per-trace time shift: values and
    the gradients w.r.t. the field and the shift against jax.grad, 1e-12."""
    rng = np.random.default_rng(13)
    bsz, nu, ntg = 3, 9, 11
    u2d = rng.random((bsz, nu, ntg)) + 0.01
    tg = np.sort(rng.random((bsz, ntg)), axis=-1)
    ug = np.sort(rng.random((bsz, nu)), axis=-1)
    ft, fu = rng.random((bsz, ntg)) + 0.01, rng.random((bsz, nu)) + 0.01
    xt = np.sort(rng.random((bsz, ntg)), axis=-1) + 0.1
    xu = np.sort(rng.random((bsz, nu)), axis=-1)
    tshift = 0.05 * rng.standard_normal(bsz)
    wbar = rng.random((2, bsz)) + 0.5
    tu, ts = T(u2d).requires_grad_(True), T(tshift).requires_grad_(True)
    wt, wu = t_marg(tu, T(tg), T(ug), t_make_density_1d(T(ft), T(xt)),
                    t_make_density_1d(T(fu), T(xu)), p=2, tshift=ts)
    gu, gs = torch.autograd.grad((T(wbar[0]) * wt + T(wbar[1]) * wu).sum(), (tu, ts))

    def jloss(u, s, b):
        jt, ju = j_marg(u, jnp.asarray(tg[b]), jnp.asarray(ug[b]),
                        j_make_density_1d(jnp.asarray(ft[b]), jnp.asarray(xt[b])),
                        j_make_density_1d(jnp.asarray(fu[b]), jnp.asarray(xu[b])),
                        2, tshift=s)
        return wbar[0, b] * jt + wbar[1, b] * ju, (jt, ju)

    for b in range(bsz):
        (_, (jt, ju)), (jgu, jgs) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(u2d[b]), tshift[b], b)
        np.testing.assert_allclose([wt[b].item(), wu[b].item()],
                                   [float(jt), float(ju)], rtol=1e-12)
        np.testing.assert_allclose(gu[b].numpy(), np.asarray(jgu), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(gs[b].item(), float(jgs), rtol=1e-12, atol=1e-14)


def test_wasserstein_1d_rejects_bad_order():
    x = torch.ones(1, 3, dtype=torch.float64)
    with pytest.raises(t_errors.UnknownOTDistanceTypeError):
        t_wasserstein_1d(x, x, x, x, p=3)


def test_error_taxonomy_mirrors_jax():
    names = [n for n in dir(j_errors) if isinstance(getattr(j_errors, n), type)
             and issubclass(getattr(j_errors, n), Exception)]
    for n in names:
        assert issubclass(getattr(t_errors, n), t_errors.OTError), n
    assert t_errors.FMMlibraryError is t_errors.FMMLibraryError


def test_import_does_not_load_jax():
    code = ("import sys, waveform_ot_torch, waveform_ot_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('waveform_ot_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """With no nvcc anywhere the build raises a clear error, not a stub."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "_CUDA_DEFAULT_HOME", tmp_path / "no-cuda")
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build("distance_field")
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


def test_build_key_covers_source_and_flags(monkeypatch):
    a = _build.library_path("distance_field")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    b = _build.library_path("distance_field")
    assert a != b and a.parent == b.parent and a.name.startswith("distance_field-")
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes on the CPU; it raises."""
    v = torch.zeros(1, 3, 2, dtype=torch.float64)
    g = torch.zeros(1, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_distance.distance_field_cuda(v, g, g)
