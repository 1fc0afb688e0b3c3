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

import waveform_ot_torch.ops as t_ops
import waveform_ot_tpu.ops as j_ops
from waveform_ot_torch import _build, convert
from waveform_ot_torch.inversion.pipeline import grid6_to_window
from waveform_ot_torch.models.layered import (
    fukuoka_model, layered_model_from_table, uniform_model,
)
from waveform_ot_torch.models.seismo import MediumConfig, moment_tensor_from_sdr
from waveform_ot_torch.ops import cuda_distance
from waveform_ot_torch.ops import errors as t_errors
from waveform_ot_torch.ops.fingerprint import make_window
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


@pytest.mark.parametrize("distfunc", ["W1", "W2", "W12"])
def test_ops_wasser_is_the_function_and_matches_jax(distfunc):
    """``waveform_ot_torch.ops.wasser`` is the reference-style function, as
    ``waveform_ot_tpu.ops.wasser`` is (each package's ops/__init__ binds the
    name over the submodule): on the same densities of unequal support
    sizes, each W_p^p within 1e-12 relative of the JAX package's."""
    assert callable(t_ops.wasser) and callable(j_ops.wasser)
    rng = np.random.default_rng(7)
    f, g = rng.random(14) + 0.05, rng.random(19) + 0.05
    xf, xg = np.sort(rng.standard_normal(14)), np.sort(rng.standard_normal(19))
    got = t_ops.wasser(t_make_density_1d(T(f), T(xf)), t_make_density_1d(T(g), T(xg)),
                       distfunc)
    ref = j_ops.wasser(j_make_density_1d(jnp.asarray(f), jnp.asarray(xf)),
                       j_make_density_1d(jnp.asarray(g), jnp.asarray(xg)), distfunc)
    assert len(got) == len(ref) == (2 if distfunc == "W12" else 1)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-12, atol=0)


def test_density_1d_n_matches_jax():
    """Density1D.n is the support size, pdf's last dimension, as JAX's: for
    one density and for a batch of them (JAX's by vmap)."""
    rng = np.random.default_rng(4)
    f, x = rng.random((3, 11)) + 0.01, np.sort(rng.standard_normal((3, 11)), axis=-1)
    one = j_make_density_1d(jnp.asarray(f[0]), jnp.asarray(x[0]))
    batch = jax.vmap(j_make_density_1d)(jnp.asarray(f), jnp.asarray(x))
    assert t_make_density_1d(T(f[0]), T(x[0])).n == one.n == 11
    assert t_make_density_1d(T(f), T(x)).n == batch.n == 11


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


# the port's entry points beside the package: chip_smoke.py and the example scripts
PORT_SCRIPTS = ["chip_smoke.py"] + sorted(
    f"examples/{name}" for name in os.listdir(os.path.join(REPO, "examples"))
    if name.startswith("torch_") and name.endswith(".py"))
IMPORTED = ["waveform_ot_torch", "waveform_ot_torch.entry", "waveform_ot_torch.bench",
            *PORT_SCRIPTS]


def _import_check(module: str) -> str:
    """Python code that imports ``module`` (the package and its convert, a
    module of the package, or a script by path, without running its main)
    and exits 1 if any jax*, optax*, waveform_ot_tpu* or __graft_entry__
    module got loaded."""
    if module.endswith(".py"):
        load = ("import importlib.util, sys; spec = importlib.util.spec_from_file_location("
                f"'under_test', {module!r}); "
                "spec.loader.exec_module(importlib.util.module_from_spec(spec)); ")
    elif module == "waveform_ot_torch":
        load = "import sys, waveform_ot_torch, waveform_ot_torch.convert; "
    else:
        load = f"import sys, {module}; "
    return (load + "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'optax', "
            "'__graft_entry__') or m.startswith('waveform_ot_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")


@pytest.fixture(scope="module")
def import_runs():
    """Each module of IMPORTED imported in a fresh interpreter of its own,
    all started together: {module: (exit code, output)}."""
    procs = {m: subprocess.Popen([sys.executable, "-c", _import_check(m)], cwd=REPO,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for m in IMPORTED}
    runs = {}
    try:
        for m, proc in procs.items():
            out, _ = proc.communicate(timeout=180)
            runs[m] = (proc.returncode, out)
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    return runs


@pytest.mark.parametrize("module", IMPORTED)
def test_import_does_not_load_jax(import_runs, module):
    """Importing the package, its entry module, its bench module,
    chip_smoke.py or a port example script loads no jax*, optax*,
    waveform_ot_tpu* or __graft_entry__ module."""
    rc, out = import_runs[module]
    assert rc == 0, out


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


def test_package_data_ships_every_compiled_source():
    """pyproject.toml's package-data covers every C, C++ and CUDA source of
    waveform_ot_torch, among them the two that _build compiles (the CUDA
    kernel and the native solvers), so a non-editable install can build
    them."""
    import tomllib
    from pathlib import Path

    from waveform_ot_torch import native

    repo = Path(REPO)
    with open(repo / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    shipped = {src for pkg, patterns in data.items() for pat in patterns
               for src in (repo / pkg.replace(".", "/")).glob(pat)}
    pkg = repo / "waveform_ot_torch"
    sources = {src for ext in ("*.cu", "*.cuh", "*.cpp", "*.cc", "*.c", "*.h")
               for src in pkg.rglob(ext) if "_build" not in src.parts}
    compiled = {native._SRC.resolve(), *(p.resolve() for p in _build._SRC_DIR.glob("*.cu"))}
    assert compiled <= {s.resolve() for s in sources} and len(compiled) == 2
    assert {s.resolve() for s in sources} <= {s.resolve() for s in shipped}


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


class _FakeJaxObject:
    """Stands in for any JAX problem object that convert reads: every field
    is another such object and reads as a length-2 array."""

    def __getattr__(self, name):
        if name.startswith("__"):        # numpy's array protocols
            raise AttributeError(name)
        return _FakeJaxObject()

    def __array__(self, dtype=None, copy=None):
        return np.zeros(2)

    def __iter__(self):
        return iter((0.0, 1.0))

    def __float__(self):
        return 0.0


_FAKE = _FakeJaxObject()
DEFAULT_DEVICE_ENTRY_POINTS = {
    "convert.tensor": lambda: convert.tensor(np.zeros(2)),
    "convert.targets": lambda: convert.targets(_FAKE),
    "convert.window": lambda: convert.window(_FAKE),
    "convert.loc_cmt_problem": lambda: convert.loc_cmt_problem(_FAKE),
    "convert.ricker_problem": lambda: convert.ricker_problem(_FAKE),
    "make_window": lambda: make_window(0.0, 1.0, -1.0, 1.0),
    "grid6_to_window": lambda: grid6_to_window((0.0, 1.0, -1.0, 1.0, 3, 4))[0],
    "moment_tensor_from_sdr": lambda: moment_tensor_from_sdr(30.0, 60.0, 45.0),
    "MediumConfig.default": MediumConfig.default,
    "convert.layered_model": lambda: convert.layered_model(_FAKE),
    "fukuoka_model": fukuoka_model,
    "uniform_model": uniform_model,
    "layered_model_from_table": lambda: layered_model_from_table([(1.0, 6.0, 3.5, 2.7)]),
}


@pytest.mark.parametrize("name", list(DEFAULT_DEVICE_ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """Without ``device`` the tensors go to the card: where torch has no CUDA
    the call raises, and it never lands silently on the CPU."""
    try:
        out = DEFAULT_DEVICE_ENTRY_POINTS[name]()
    except (AssertionError, RuntimeError) as e:   # torch built without CUDA
        assert not torch.cuda.is_available(), e
        assert "CUDA" in str(e) or "cuda" in str(e)
        return
    leaves = [out] if isinstance(out, torch.Tensor) else list(_tensors(out))
    assert leaves and all(x.is_cuda for x in leaves)


def _tensors(tree):
    for x in tree:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, tuple):
            yield from _tensors(x)


@pytest.mark.parametrize("shape,expected", [
    ((192, 79, 61, 60), 1),       # loc/CMT batch: enough groups alone
    ((1, 80, 512, 255), 8),       # Ricker: the segments split 8 ways
    ((1, 800, 600, 625), 4),      # 800x600 fingerprint: long lanes split
    ((3, 79, 61, 60), 4),         # one station: floor of 8 segments per lane
    ((12, 79, 61, 60), 4),
    ((48, 79, 61, 60), 2),        # 16 stations: the card fills at S = 2
    ((1, 9, 7, 3), 1),            # too few segments to split
    ((5, 7, 3, 1), 1),            # short rows, one segment
    ((3, 33, 257, 1499), 16),     # filled at 16, lanes too short to go on
    ((1, 1, 1, 5000), 32),        # at most one warp per point group
    ((192, 79, 61, 20000), 32),   # full card, but lanes of 625 segments
])
def test_kernel_plan(shape, expected):
    """S, the lanes per point group of the distance-field kernel, on a
    132-SM card."""
    assert cuda_distance.plan(*shape, sms=132) == expected
