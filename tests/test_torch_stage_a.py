"""Stage A of the layered forward: the CUDA kernel
(``waveform_ot_torch/csrc/surface_operator.cu``) and the rule that picks it
over the plain version (``layered._band_operator``).

The CPU tests hold the rule (CPU tensors take the plain version; every
band on the card takes the kernel, whose outputs are assembled as the plain
version's, a differentiated depth getting its derivatives from the depth
tangent; a differentiated model and a complex64 band are refused there) and
the wrapper's argument checks. The tests marked ``cuda`` hold the kernel
against the plain version and against the recursion in long double on the
card, and skip without one. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_stage_a.py
"""

import math

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import ld_surface
from waveform_ot_torch.models import cuda_surface
from waveform_ot_torch.models import layered as TL

CPU, F64 = torch.device("cpu"), torch.float64
STF = ("clp_step", 0.05, 0.2)
# a string condition is evaluated when each test runs, not at import
on_card = pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, for the decision alone."""

    @property
    def is_cuda(self):
        return True


def _grid(nk, device, nt=61, kmax=2.5, hp_below=math.inf):
    plan = TL._synth_plan(nt, 1.0, 2, STF, nk, kmax, hp_below)
    return [TL._band_grid(band, plan.k_np, 0.023, device) for band in plan.bands]


def _fields(op, dop):
    """Every field of a surface operator (and its tangent) by name."""
    out = dict(zip(TL._Reverb._fields, op.rev))
    out.update(zip(TL._SourceLayer._fields, op.src))
    if dop is not None:
        out.update(("d" + n, v) for n, v in zip(TL._Reverb._fields, dop))
    return out


def _plain_as_kernel(calls, model, grid):
    """A stand-in for the kernel that records its arguments and returns the
    plain version's fields (of ``model`` on ``grid``) in the kernel's (rev,
    src, drev) form."""

    def fake(k, om_c, iface, vp, vs, rho, z, free_surface, tangent):
        calls.append(dict(k=k, om_c=om_c, iface=iface, vp=vp, z=z, tangent=tangent))
        op, dop = TL._surface_operator(model, z, grid, free_surface, tangent)
        return tuple(op.rev), tuple(op.src), (tuple(dop) if tangent else None)

    return fake


def _refuse(*a, **k):
    raise AssertionError("the kernel was launched")


# --- which calls take the kernel (CPU) -------------------------------------------------

@pytest.mark.parametrize("tangent", [False, True])
def test_cpu_stage_a_takes_the_plain_version(monkeypatch, tangent):
    monkeypatch.setattr(cuda_surface, "surface_operator_cuda", _refuse)
    launches = cuda_surface.LAUNCHES
    stages = TL.make_layered_stages(model=TL.fukuoka_model(device=CPU), nk=16)
    z = torch.tensor([3.5, 12.0], dtype=F64)
    out = stages.stage_a(z, tangent=tangent)
    ops = out[0] if tangent else out
    assert ops[0].rev.W2.shape == (2, 26, 16, 2, 2)
    assert cuda_surface.LAUNCHES == launches


Z_DIFF = (0.001, 3.5, 12.0, 40.0)    # the depth floor, two layers and the half-space
Z_DOT = (1.0, -2.0, 0.5, 3.0)


def _weights(fields):
    """A fixed real linear functional of complex fields: their real and
    imaginary parts against random weights, each field scaled to its
    largest entry."""
    gen = torch.Generator().manual_seed(3)
    return [torch.randn(*f.shape, 2, dtype=F64, generator=gen) / f.detach().abs().max()
            for f in fields]


def _functional(fields, weights):
    return sum((torch.view_as_real(f) * w).sum() for f, w in zip(fields, weights))


@pytest.mark.parametrize("tangent", [False, True])
def test_differentiated_depth_takes_the_kernel(monkeypatch, tangent):
    """A depth that autograd differentiates takes the kernel too, in one
    launch: its gradient is the depth tangent contracted with the
    cotangents, the kernel's own where the call computed it, else the
    closed form on the kernel's outputs (here the stand-in's plain fields,
    so both equal the plain version's closed-form tangent); the
    source-layer fields carry no gradient."""
    calls = []
    model = TL.fukuoka_model(device=CPU)
    (grid,) = _grid(16, CPU)
    monkeypatch.setattr(cuda_surface, "surface_operator_cuda",
                        _plain_as_kernel(calls, model, grid))
    z = torch.tensor(Z_DIFF, dtype=F64).as_subclass(_OnCard).requires_grad_(True)
    op, dop = TL._band_operator(model, z, grid, True, tangent)
    assert all(f.requires_grad for f in op.rev) and not any(f.requires_grad for f in op.src)
    weights = _weights(op.rev)
    (g,) = torch.autograd.grad(_functional(op.rev, weights), z)
    assert [c["tangent"] for c in calls] == [tangent]
    _, drev = TL._surface_operator(model, z.detach(), grid, True, True)
    want = sum(((torch.view_as_real(d) * w).sum(dim=tuple(range(1, d.dim() + 1))))
               for d, w in zip(drev, weights))
    assert g.dtype == F64 and torch.allclose(g, want, rtol=1e-13, atol=0)


def test_differentiated_depth_matches_autograd_of_the_plain_version(monkeypatch):
    """The kernel's z-gradient and z-tangent against autograd and forward
    mode through the plain version, on the fields whose closed-form
    tangent is well conditioned (inner2 and innersh cancel digits near
    the surface, where the two part by rounding magnified)."""
    model = TL.fukuoka_model(device=CPU)
    (grid,) = _grid(16, CPU)
    monkeypatch.setattr(cuda_surface, "surface_operator_cuda",
                        _plain_as_kernel([], model, grid))
    names = ("W2", "RA2", "RB2", "Wsh", "RAsh", "RBsh")
    pick = lambda op: [getattr(op.rev, n) for n in names]
    got, want = {}, {}
    for key, on_card in (("kernel", True), ("plain", False)):
        z = torch.tensor(Z_DIFF, dtype=F64)
        z = (z.as_subclass(_OnCard) if on_card else z).requires_grad_(True)
        fields = pick(TL._band_operator(model, z, grid, True, False)[0])
        (got[key],) = torch.autograd.grad(_functional(fields, _weights(fields)), z)
        with fwAD.dual_level():
            zd = torch.tensor(Z_DIFF, dtype=F64)
            zd = fwAD.make_dual(zd.as_subclass(_OnCard) if on_card else zd,
                                torch.tensor(Z_DOT, dtype=F64))
            fields = pick(TL._band_operator(model, zd, grid, True, False)[0])
            want[key] = [fwAD.unpack_dual(f).tangent for f in fields]
    assert torch.allclose(got["kernel"], got["plain"], rtol=1e-12, atol=0)
    for name, a, b in zip(names, want["kernel"], want["plain"]):
        assert (a - b).abs().max() <= 1e-12 * b.abs().max(), name


def test_tangent_of_a_differentiated_depth_has_no_derivative(monkeypatch):
    """With ``tangent`` the tangent comes back, and a gradient through it or
    a forward-mode depth raises: the kernel has no second derivative."""
    model = TL.fukuoka_model(device=CPU)
    (grid,) = _grid(16, CPU)
    monkeypatch.setattr(cuda_surface, "surface_operator_cuda",
                        _plain_as_kernel([], model, grid))
    z = torch.tensor(Z_DIFF, dtype=F64).as_subclass(_OnCard).requires_grad_(True)
    _, dop = TL._band_operator(model, z, grid, True, True)
    with pytest.raises(RuntimeError, match="no derivative of its own"):
        torch.autograd.grad(dop.W2.real.sum(), z)
    with fwAD.dual_level(), pytest.raises(RuntimeError, match="no derivative of its own"):
        zd = fwAD.make_dual(torch.tensor(Z_DIFF, dtype=F64).as_subclass(_OnCard),
                            torch.tensor(Z_DOT, dtype=F64))
        TL._band_operator(model, zd, grid, True, True)


@pytest.mark.parametrize("how", ["requires_grad", "dual"])
def test_differentiated_model_on_the_card_is_refused(monkeypatch, how):
    """The kernel differentiates in z only: a model that autograd or forward
    mode differentiates raises on the card, before any launch; under
    no_grad a model that requires grad is a constant and takes the kernel."""
    calls = []
    model = TL.fukuoka_model(device=CPU)
    (grid,) = _grid(16, CPU)
    monkeypatch.setattr(cuda_surface, "surface_operator_cuda",
                        _plain_as_kernel(calls, model, grid))
    z = torch.tensor([3.5, 12.0], dtype=F64).as_subclass(_OnCard)
    with fwAD.dual_level():
        vp = model.vp.clone()
        vp = vp.requires_grad_(True) if how == "requires_grad" else \
            fwAD.make_dual(vp, torch.ones_like(vp))
        with pytest.raises(ValueError, match="source depth only"):
            TL._band_operator(model._replace(vp=vp), z, grid, True, False)
    assert calls == []
    if how == "requires_grad":
        with torch.no_grad():
            TL._band_operator(model._replace(vp=vp), z, grid, True, False)
        assert len(calls) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int64],
                         ids=["f32", "f64", "int"])
@pytest.mark.parametrize("tangent", [False, True])
def test_card_inputs_take_the_kernel(monkeypatch, tangent, dtype):
    """A band of a stage-A call on the card goes to the kernel once, with
    the plain version's grids, the model's interface depths and the depths
    as contiguous float64 (a strided view included), and comes back as the
    plain version's operator."""
    calls = []
    model = TL.fukuoka_model(device=CPU)
    (grid,) = _grid(16, CPU)
    monkeypatch.setattr(cuda_surface, "surface_operator_cuda",
                        _plain_as_kernel(calls, model, grid))
    z = torch.tensor([[0.001, 9.0], [2.0, 9.0], [3.5, 9.0], [40.0, 9.0]]).to(dtype)[:, 0]
    got = _fields(*TL._band_operator(model, z.as_subclass(_OnCard), grid, True, tangent))
    want = _fields(*TL._surface_operator(model, z, grid, True, tangent))
    (call,) = calls
    assert call["k"] is grid.k and call["om_c"] is grid.om_c
    assert call["z"].dtype == F64 and call["z"].is_contiguous()
    assert torch.equal(call["iface"], model.interfaces())
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert torch.equal(got[name], w.expand(got[name].shape)), name


def test_complex64_band_takes_the_plain_version(monkeypatch):
    """With ``hp_below`` the band above runs in complex64: on the CPU it
    takes the plain version, and the card, whose kernel computes in
    complex128 only, refuses it before any launch."""
    calls = []
    model = TL.fukuoka_model(device=CPU)
    grids = _grid(16, CPU, hp_below=0.5)
    assert [g.cdtype for g in grids] == [torch.complex128, torch.complex64]
    monkeypatch.setattr(cuda_surface, "surface_operator_cuda",
                        _plain_as_kernel(calls, model, grids[0]))
    z = torch.tensor([3.5], dtype=F64)
    op, _ = TL._band_operator(model, z, grids[1], True, True)
    assert op.rev.W2.dtype == torch.complex64 and calls == []
    TL._band_operator(model, z.as_subclass(_OnCard), grids[0], True, True)
    with pytest.raises(ValueError, match="complex128 only"):
        TL._band_operator(model, z.as_subclass(_OnCard), grids[1], True, True)
    assert len(calls) == 1


def _kernel_args(**change):
    """Valid arguments of ``surface_operator_cuda`` (CPU tensors, z marked
    as on the card) with ``change`` applied."""
    model = TL.fukuoka_model(device=CPU)
    (grid,) = _grid(8, CPU)
    args = dict(k=grid.k, om_c=grid.om_c, iface=model.interfaces(), vp=model.vp, vs=model.vs,
                rho=model.rho, z=torch.tensor([3.5, 12.0], dtype=F64).as_subclass(_OnCard))
    args.update({n: f(args) for n, f in change.items()})
    return args


BAD_ARGS = {
    "z_on_cpu": (dict(z=lambda a: torch.tensor([3.5], dtype=F64)), ValueError),
    "z_int": (dict(z=lambda a: torch.tensor([3], dtype=torch.int64).as_subclass(_OnCard)),
              TypeError),
    "z_f32": (dict(z=lambda a: a["z"].float()), TypeError),
    "z_strided": (dict(z=lambda a: torch.stack([a["z"], a["z"]], 1)[:, 0]), ValueError),
    "z_2d": (dict(z=lambda a: a["z"][None]), ValueError),
    "no_sources": (dict(z=lambda a: a["z"][:0]), ValueError),
    "k_f32": (dict(k=lambda a: a["k"].float()), TypeError),
    "k_strided": (dict(k=lambda a: torch.stack([a["k"], a["k"]], 1)[:, 0]), ValueError),
    "om_c_real": (dict(om_c=lambda a: a["om_c"].real.contiguous()), TypeError),
    "iface_short": (dict(iface=lambda a: a["iface"][1:]), ValueError),
    "vs_short": (dict(vs=lambda a: a["vs"][1:]), ValueError),
    "rho_2d": (dict(rho=lambda a: a["rho"][:, None]), ValueError),
}


@pytest.mark.parametrize("case", list(BAD_ARGS))
def test_wrapper_rejects_bad_arguments(case):
    change, error = BAD_ARGS[case]
    launches = cuda_surface.LAUNCHES
    with pytest.raises(error):
        cuda_surface.surface_operator_cuda(**_kernel_args(**change), free_surface=True,
                                           tangent=True)
    assert cuda_surface.LAUNCHES == launches


# --- the kernel on the card ------------------------------------------------------------

LAYER_DEPTHS = (0.05, 1.0, 3.5, 10.0, 25.0, 40.0)    # inside each Fukuoka layer and below
FLOOR = 0.001                                        # the inversions' depth floor
ULPS = 16
"""The well-conditioned fields (SH scalars, ga, gb, chi and their tangents)
against the plain version on the card: within 16 ulps of each field's
largest entry. PyTorch's elementwise kernels contract mul+add pairs into
FMAs where the kernel (built with -fmad=false) does not, and the kernel
inverts a 2x2 block or solves an SH interface by one reciprocal where the
plain version divides each entry (measured at most 9.7 ulps on an H100)."""
ACCURACY = 4.0
"""The P-SV fields: their error against the recursion in long double at
most 4x the plain version's own, plus 64 ulps of the field, per source and
lane. On the low-frequency lanes the recursion magnifies rounding (up to
4% of a field on lane 0 for the shallow sources), so the two float64
versions part there by as much as each is off; measured at most 2.2x the plain version's error, on
every case below (H100)."""


def _depths(model, k):
    """k source depths: the interfaces themselves, each layer, the depth
    floor and the half-space, then evenly down to 45 km."""
    if k == 1:
        return torch.tensor([3.5], dtype=torch.float32)    # as the float32 problems pass it
    special = torch.cat([model.interfaces().cpu(),
                         torch.tensor((FLOOR,) + LAYER_DEPTHS, dtype=F64)])
    fill = torch.linspace(FLOOR, 45.0, max(k - special.shape[0], 0), dtype=F64)
    return torch.cat([special, fill])[:k]


def _ulps(got, want, scale=None):
    scale = want.abs().max() if scale is None else scale
    return ((got - want).abs().max() / (scale * torch.finfo(F64).eps)).item() if scale > 0 else \
        (got - want).abs().max().item()


@pytest.mark.cuda
@on_card
@pytest.mark.parametrize("tangent", [False, True])
@pytest.mark.parametrize("free_surface", [True, False])
@pytest.mark.parametrize("k", [1, 4, 64])
def test_kernel_matches_plain_version(k, free_surface, tangent):
    """Every field at the plain version's shape, dtype and layout; the
    source layer's vs and rho bit for bit (a source on an interface lands
    in the layer the plain version puts it in); the well-conditioned fields
    within :data:`ULPS`; each source of a batch bit for bit as the same
    source alone (one thread per point, whatever the batch)."""
    dev = torch.device("cuda")
    model = TL.fukuoka_model(device=dev)
    (grid,) = _grid(1024, dev)
    z = _depths(model, k).to(dev)
    launches = cuda_surface.LAUNCHES
    got = _fields(*TL._band_operator(model, z, grid, free_surface, tangent))
    want = _fields(*TL._surface_operator(model, z, grid, free_surface, tangent))
    torch.cuda.synchronize()
    assert cuda_surface.LAUNCHES == launches + 1 and got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_contiguous(), name
        assert torch.isfinite(torch.view_as_real(g) if g.is_complex() else g).all(), name
    for name in ("vs", "rho"):
        assert torch.equal(got[name], want[name]), name
    smooth = ["ga", "gb", "chi", "Wsh", "RAsh", "RBsh", "innersh"]
    smooth += ["dWsh", "dRAsh", "dRBsh"] if tangent else []
    for name in smooth:
        assert _ulps(got[name], want[name]) <= ULPS, (name, _ulps(got[name], want[name]))
    if tangent:
        # d(innersh)/dz is 0 in exact arithmetic (dRA RB + RA dRB cancels):
        # both versions hold rounding, measured on the scale of its terms
        w = want
        scale = (w["innersh"].abs() ** 2 * (w["dRAsh"] * w["RBsh"]).abs()).max()
        assert _ulps(got["dinnersh"], w["dinnersh"], scale) <= ULPS
    for j in {0, k // 2, k - 1}:
        alone = _fields(*TL._band_operator(model, z[j:j + 1], grid, free_surface, tangent))
        for name, v in alone.items():
            assert torch.equal(v, got[name][j:j + 1]), (j, name)


CASES = {f"fukuoka_z{z:g}": ("fukuoka", z) for z in (FLOOR,) + LAYER_DEPTHS}
CASES.update({f"fukuoka_iface{i}": ("fukuoka", i) for i in range(5)})
CASES.update({"uniform_z3": ("uniform", 3.0)})


@pytest.mark.cuda
@on_card
@pytest.mark.parametrize("free_surface", [True, False], ids=["surface", "buried"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_as_accurate_as_plain_version(case, free_surface):
    """The P-SV fields and their tangents (:data:`ACCURACY`), for a source
    inside each Fukuoka layer, on each interface, at the depth floor, in
    the half-space, and in a one-layer uniform model (whose RB is 0)."""
    dev = torch.device("cuda")
    kind, z = CASES[case]
    model = TL.fukuoka_model(device=dev) if kind == "fukuoka" else TL.uniform_model(device=dev)
    zt = model.interfaces()[z:z + 1] if isinstance(z, int) else \
        torch.tensor([z], dtype=F64, device=dev)
    (grid,) = _grid(1024, dev)
    got = _fields(*TL._band_operator(model, zt, grid, free_surface, True))
    plain = _fields(*TL._surface_operator(model, zt, grid, free_surface, True))
    om = grid.om_c.cpu().numpy().astype(ld_surface.LD)[:, None]
    exact = ld_surface.surface_operator(model, np.longdouble(zt.item()),
                                        grid.k.cpu().numpy().astype(np.longdouble), om,
                                        free_surface, tangent=True)
    if kind == "uniform":
        for name in ("RB2", "RBsh", "dRB2", "dRBsh"):
            assert torch.equal(got[name], torch.zeros_like(got[name])), name
        assert torch.equal(got["inner2"], torch.eye(2, dtype=got["inner2"].dtype,
                                                    device=dev).expand_as(got["inner2"]))
    for name, want in exact.items():
        scale = np.abs(want).max(axis=(-3, -2, -1))               # per lane
        scale = np.where(scale > 0, scale, 1.0)
        err = lambda v: np.abs(v[0].cpu().numpy() - want).max(axis=(-3, -2, -1)) / scale
        ours, theirs = err(got[name]), err(plain[name].expand_as(got[name]))
        bound = ACCURACY * theirs + 64 * np.finfo(np.float64).eps
        assert (ours <= bound).all(), (name, np.flatnonzero(ours > bound), ours.max(),
                                       theirs.max())


@pytest.mark.cuda
@on_card
def test_stage_a_launches_once_per_band():
    """One launch per band of each stage-A call on the card, tangent or not,
    and none for a gradient in its depth; a complex64 band raises before its
    own launch, a differentiated model before any."""
    dev = torch.device("cuda")
    z = torch.tensor([3.5, 12.0], dtype=F64, device=dev)
    stages = TL.make_layered_stages(nk=256)
    l0 = cuda_surface.LAUNCHES
    stages.stage_a(z)
    stages.stage_a(z, tangent=True)
    assert cuda_surface.LAUNCHES == l0 + 2
    zg = z.clone().requires_grad_(True)
    (op,) = stages.stage_a(zg)
    torch.autograd.grad(op.rev.W2.real.sum(), zg)
    assert cuda_surface.LAUNCHES == l0 + 3
    with pytest.raises(ValueError, match="complex128 only"):     # after the complex128 band
        TL.make_layered_stages(nk=256, hp_below=0.5).stage_a(z, tangent=True)
    assert cuda_surface.LAUNCHES == l0 + 4
    model = TL.fukuoka_model(device=dev)
    vp = model.vp.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="source depth only"):
        TL.make_layered_stages(model._replace(vp=vp), nk=256).stage_a(z)
    assert cuda_surface.LAUNCHES == l0 + 4


@pytest.mark.cuda
@on_card
@pytest.mark.parametrize("mode", ["reverse", "func_grad", "forward_ad", "func_jvp"])
def test_kernel_depth_derivative_is_its_tangent(mode):
    """z's derivative through the kernel on the card (autograd,
    ``torch.func.grad``, forward mode, ``torch.func.jvp``): every
    ``_Reverb`` field's is the closed-form depth tangent on the kernel's own
    outputs (contracted with the cotangents, or scaled by z's tangent),
    which is the kernel's tangent output to rounding; and the SH fields'
    equal the plain version's derivative within 1e-12 of the largest (the
    P-SV fields part from it by the rounding the low lanes magnify, held in
    the tests above). The plain version's own custom Functions predate
    ``torch.func``, so it is differentiated by autograd or forward mode."""
    dev = torch.device("cuda")
    model = TL.fukuoka_model(device=dev)
    (grid,) = _grid(1024, dev)
    z0 = torch.tensor(Z_DIFF, dtype=F64, device=dev)
    zdot = torch.tensor(Z_DOT, dtype=F64, device=dev)
    op, drev = TL._band_operator(model, z0, grid, True, True)
    closed = TL._depth_tangent(op.rev, op.src)
    for name, c, d in zip(TL._Reverb._fields, closed, drev):
        if name not in ("inner2", "innersh"):      # their tangents cancel digits
            assert _ulps(c, d) <= ULPS, (name, _ulps(c, d))
    weights = [w.to(dev) for w in _weights([d.cpu() for d in closed])]

    def derivative(fn, mode):
        rev = lambda z: tuple(fn(model, z, grid, True, False)[0].rev)
        if mode == "reverse":
            z = z0.clone().requires_grad_(True)
            return torch.autograd.grad(_functional(rev(z), weights), z)[0]
        if mode == "func_grad":
            return torch.func.grad(lambda z: _functional(rev(z), weights))(z0)
        if mode == "forward_ad":
            with fwAD.dual_level():
                return [fwAD.unpack_dual(f).tangent for f in rev(fwAD.make_dual(z0, zdot))]
        return torch.func.jvp(rev, (z0,), (zdot,))[1]

    got = derivative(TL._band_operator, mode)
    plain = derivative(TL._surface_operator,
                       {"func_grad": "reverse", "func_jvp": "forward_ad"}.get(mode, mode))
    if mode in ("reverse", "func_grad"):
        want = sum((torch.view_as_real(c) * w).sum(dim=tuple(range(1, c.dim() + 1)))
                   for c, w in zip(closed, weights))
        assert torch.allclose(got, want, rtol=1e-12, atol=0)
        return
    for name, g, c, p in zip(TL._Reverb._fields, got, closed, plain):
        assert torch.equal(g, c * zdot.reshape(-1, *(1,) * (c.dim() - 1))), name
        if name in ("Wsh", "RAsh", "RBsh"):
            assert (g - p).abs().max() <= 1e-12 * p.abs().max(), name
