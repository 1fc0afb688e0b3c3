# Frozen copy of waveform_ot_torch/models/layered.py at commit 8a4dc96ec9d6dabe20c4e556e247ff8cb21fb737,
# the port's f-k forward, kept for the benchmark's float64 reference so that a
# later change to the port does not change what it is held to. Trimmed to what
# the reference reaches, plain autograd through everything: the closed-form
# depth tangent and its link (the port's structured_vjp), the Jacobian, the
# whole-space oracle, layered_seismograms, the model presets, the buried
# receivers (free_surface=False), the complex64 band (hp_below) and forward-mode
# rules are left out; its one import takes the frozen far-field copy beside it.
# What stays is unchanged.
"""Layered-medium seismograms: differentiable frequency-wavenumber synthesis.

Counterpart of waveform_ot_tpu.models.layered, the pyprop8 replacement the
reference's Figs 9-12 run on: a plane-layered elastic half-space response to
a point moment-tensor source, from

  * the per-(frequency, wavenumber) Kennett reflection-matrix recursion in
    closed-form 2x2 complex block algebra (P-SV) and scalars (SH);
  * source up/down-going amplitudes from the plane-wave decomposition of the
    whole-space moment-tensor field;
  * the azimuthal reduction to Bessel integrals J0..J3 over wavenumber
    (midpoint rule on a fixed k grid) and complex-frequency damping;
  * inverse-FFT synthesis with the reference's cosine low-pass source filter.

The stack algebra runs in native complex128 whatever the working dtype; the
Bessel assembly and the FFT run in the working dtype (float32 or float64 of
the stations). Sources come in a leading batch, and the synthesis splits into
a depth-only stage A (the surface operators, :func:`make_layered_stages`) and
a per-source stage B. Conventions: (x=North, y=East, z=Up) for inputs and
outputs, source depth ``z`` positive downward, components (ux, uy, uz-up),
shape (..., nr, 3, nt).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from otbench.reference.farfield import StationSet

# ---------------------------------------------------------------------------
# Bessel functions J0..J3 of a real argument x >= 0: power series below the
# crossover, Hankel asymptotics above, gradient by dJ_m/dx = (J_{m-1} -
# J_{m+1})/2 (J_{-1} = -J_1).
# ---------------------------------------------------------------------------

_BESSEL_CROSSOVER = 14.0       # float64: series/asymptotic switch point
_BESSEL_CROSSOVER_F32 = 8.0    # float32: the series' cancellation outgrows
# float32's headroom near x ~ 14, and the Hankel branch is float32-exact by 8
_SERIES_TERMS = 36
_ASYM_TERMS = 9


def _bessel_orders(x: torch.Tensor, n: int) -> torch.Tensor:
    """(n, *x.shape): J_0(x) .. J_{n-1}(x), every order in one stacked pass."""
    shape = (n,) + (1,) * x.dim()
    col = lambda vals: torch.tensor(vals, dtype=x.dtype, device=x.device).reshape(shape)
    xc = _BESSEL_CROSSOVER_F32 if x.dtype == torch.float32 else _BESSEL_CROSSOVER
    below = x < xc
    # ascending series sum_j (-1)^j (x/2)^(2j+m) / (j! (j+m)!), by Horner in q
    half = 0.5 * torch.where(below, x, 0.0)
    q = half * half
    acc = torch.zeros((n,) + x.shape, dtype=x.dtype, device=x.device)
    for j in range(_SERIES_TERMS - 1, -1, -1):
        c = col([(-1.0) ** j / (math.factorial(j) * math.factorial(j + m)) for m in range(n)])
        acc = acc * q + c
    h2 = half * half
    powers = [torch.ones_like(half), half, h2, h2 * half, h2 * h2][:n]   # as integer powers
    series = acc * torch.stack(powers)
    # Hankel expansion J_m = sqrt(2/(pi x)) [P cos X - Q sin X],
    # X = x - (2m+1) pi/4 (Abramowitz & Stegun 9.2.5-9.2.10)
    xa = torch.clamp_min(x, xc)
    inv8x = 1.0 / (8.0 * xa)
    mu = col([4.0 * m * m for m in range(n)])
    p = torch.ones_like(acc)
    qs = torch.zeros_like(acc)
    term = torch.ones_like(acc)
    for k in range(1, 2 * _ASYM_TERMS):
        term = term * (mu - (2 * k - 1) ** 2) * inv8x / k
        if k % 2 == 1:
            qs = qs + term * (-1.0) ** ((k - 1) // 2)
        else:
            p = p + term * (-1.0) ** (k // 2)
    chi = xa - col([(2 * m + 1) * math.pi / 4.0 for m in range(n)])
    asym = torch.sqrt(2.0 / (math.pi * xa)) * (p * torch.cos(chi) - qs * torch.sin(chi))
    return torch.where(below, series, asym)


def _bessel_slopes(j: torch.Tensor) -> torch.Tensor:
    """(4, ...) J'_0 .. J'_3 from (5, ...) J_0 .. J_4."""
    return torch.stack([-j[1], 0.5 * (j[0] - j[2]), 0.5 * (j[1] - j[3]), 0.5 * (j[2] - j[4])])


class _BesselJ0123(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        j = _bessel_orders(x, 5 if ctx.needs_input_grad[0] else 4)
        ctx.save_for_backward(j)
        return j[:4].clone()

    @staticmethod
    def backward(ctx, g):
        (j,) = ctx.saved_tensors
        return (g * _bessel_slopes(j)).sum(0)



def bessel_j0123(x: torch.Tensor) -> torch.Tensor:
    """Stacked (4, ...) J0(x), J1(x), J2(x), J3(x) for x >= 0, differentiable
    in reverse mode by the exact recurrence, so derivatives are
    as accurate as the values."""
    return _BesselJ0123.apply(x)


# ---------------------------------------------------------------------------
# complex square root with the decaying-phase branch
# ---------------------------------------------------------------------------


class _CSqrt(torch.autograd.Function):
    """Principal sqrt with the Im >= 0 side of the cut: sqrt(-x) = +i sqrt(x)
    for an imaginary part of +0.0 and of -0.0 alike (torch.sqrt gives
    -i sqrt(x) at -0.0). Stable two-branch form, no cancellation for re < 0.
    Derivative dz / (2 sqrt(z)), finite wherever z != 0."""

    @staticmethod
    def forward(ctx, z):
        re, im = z.real, z.imag
        t = torch.sqrt(0.5 * (torch.hypot(re, im) + re.abs()))
        t_safe = torch.where(t == 0.0, 1.0, t)
        ge0 = re >= 0.0
        s = torch.complex(torch.where(ge0, t, 0.5 * im.abs() / t_safe),
                          torch.where(ge0, 0.5 * im / t_safe,
                                      torch.where(im >= 0.0, t, -t)))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g / (2.0 * s.conj())


def csqrt(z: torch.Tensor) -> torch.Tensor:
    """sqrt of a complex tensor with Im(result) >= 0 on the negative real axis."""
    return _CSqrt.apply(z)


# ---------------------------------------------------------------------------
# model container
# ---------------------------------------------------------------------------


class LayeredModel(NamedTuple):
    """Plane-layered elastic model, (nlay,) tensors. The last entry is the
    half-space; its ``thickness`` is ignored. Units km, km/s, Mg/m^3."""

    thickness: torch.Tensor
    vp: torch.Tensor
    vs: torch.Tensor
    rho: torch.Tensor

    @property
    def nlayers(self) -> int:
        return self.thickness.shape[0]

    def interfaces(self) -> torch.Tensor:
        """Depths of the nlay-1 internal interfaces (cumulative thicknesses)."""
        return torch.cumsum(self.thickness[:-1], 0)

    def to(self, device, dtype) -> "LayeredModel":
        return LayeredModel(*(v.to(device=device, dtype=dtype) for v in self))


def layered_model_from_table(table, dtype=torch.float64, device="cuda") -> LayeredModel:
    """From the reference's (nlay, 4) [thickness, vp, vs, rho] rows (last row
    thickness inf), on ``device``."""
    col = lambda i: torch.tensor([float(row[i]) for row in table], dtype=dtype, device=device)
    t = col(0)
    return LayeredModel(thickness=torch.where(torch.isfinite(t), t, 0.0),
                        vp=col(1), vs=col(2), rho=col(3))


# ---------------------------------------------------------------------------
# frequency synthesis. Fields carry e^{-i omega t}; U(omega) = int u e^{+i
# omega t} dt, so u(t_j) = irfft(conj(U))/dt. Spectra are taken at omega_n +
# i sigma and the series multiplied by e^{+sigma t} after the inverse FFT.
# ---------------------------------------------------------------------------


def clp_filter(om, om1, om2):
    """Cosine low-pass: 1 below om1, tapering to 0 at om2 (pyprop8's
    clp_filter, the reference's source filter)."""
    om = om.abs()
    ramp = 0.5 * (1.0 + torch.cos(math.pi * (om - om1) / (om2 - om1)))
    return torch.where(om <= om1, 1.0, torch.where(om >= om2, 0.0, ramp))


def stf_spectrum(om_real, om_c, stf, dtype=torch.float64):
    """Moment time-function spectrum at the complex synthesis frequencies.

    ("gauss", fc): M(t) = exp(-(pi fc)^2 t^2), complex128 for ``dtype``
    float64 and complex64 otherwise; ("clp_step", f1, f2): a step
    band-limited by clp_filter(om, 2 pi f1, 2 pi f2), in om_c's dtype."""
    if stf[0] == "gauss":
        a = (math.pi * stf[1]) ** 2
        s = math.sqrt(math.pi / a) * torch.exp(-(om_c * om_c) / (4.0 * a))
        return s.to(torch.complex128 if dtype == torch.float64 else torch.complex64)
    if stf[0] == "clp_step":
        band = clp_filter(om_real, 2.0 * math.pi * stf[1], 2.0 * math.pi * stf[2])
        return band * (1j / om_c)
    raise ValueError(f"unknown stf kind: {stf[0]!r}")


def _synthesize(U, nt: int, dt, sigma, nfft: int):
    """Spectra (..., nf) at omega_n + i sigma -> time series (..., nt)."""
    u = torch.fft.irfft(U.conj(), n=nfft, dim=-1) / dt
    tt = dt * torch.arange(nt, dtype=u.dtype, device=u.device)
    return u[..., :nt] * torch.exp(sigma * tt)


def _flip_z(dtype, device) -> torch.Tensor:
    """(3, 3) sign pattern taking M between the z-up and z-down frames."""
    return torch.tensor([[1.0, 1.0, -1.0], [1.0, 1.0, -1.0], [-1.0, -1.0, 1.0]],
                        dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# per-(omega, k) machinery. P-SV fields are potential-amplitude 2-vectors
# (P, SV); the motion-stress blocks are the columns of the 4x4 eigenvector
# matrix split into displacement (u_x', u_z) and traction (szz, sxz) rows for
# the down- and up-going pairs (down-going e^{+i gamma z}, z down, Im gamma >
# 0 so every layer phase decays). Matrices are (..., 2, 2) complex tensors.
# ---------------------------------------------------------------------------


def _mat2(a, b, c, d):
    """(..., 2, 2) from four broadcastable complex (..) tensors."""
    a, b, c, d = torch.broadcast_tensors(a, b, c, d)
    return torch.stack([torch.stack([a, b], -1), torch.stack([c, d], -1)], -2)


def _mm(*ms):
    """Product of (..., 2, 2) complex matrices, left to right, written out
    elementwise: as a batched GEMM of 2x2 tiles cuBLAS runs its 32x16 tiles
    almost empty (measured 93% of the layered call's device time)."""
    out = ms[0]
    for b in ms[1:]:
        out = out[..., :, :1] * b[..., :1, :] + out[..., :, 1:] * b[..., 1:, :]
    return out


def _inv2(m):
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    return _mat2(m[..., 1, 1], -m[..., 0, 1], -m[..., 1, 0], m[..., 0, 0]) / det[..., None, None]


class _Blocks(NamedTuple):
    """Eigenblocks of every layer, (nlay, nf, nk, 2, 2), and its vertical
    wavenumbers (nlay, nf, nk); i*ga and i*gb for the layer phases."""

    Ud: torch.Tensor
    Uu: torch.Tensor
    Sd: torch.Tensor
    Su: torch.Tensor
    ga: torch.Tensor
    gb: torch.Tensor
    iga: torch.Tensor
    igb: torch.Tensor


def _psv_blocks(k, om_c, vp, vs, rho) -> _Blocks:
    """Blocks for layers (vp, vs, rho) (nlay,) over om_c (nf,) x k (nk,)."""
    k = k[None, None, :]
    w2 = (om_c * om_c)[None, :, None]
    vp, vs, rho = (v[:, None, None] for v in (vp, vs, rho))
    ga = csqrt(w2 / (vp * vp) - k * k)
    gb = csqrt(w2 / (vs * vs) - k * k)
    mu = rho * vs * vs
    chi = 2.0 * k * k - w2 / (vs * vs)
    ik = 1j * k
    iga, igb = 1j * ga, 1j * gb
    Ud = _mat2(ik, -igb, iga, ik)
    Uu = _mat2(ik, igb, -iga, ik)
    Sd = _mat2(mu * chi, (-2.0 * mu) * (k * gb), (-2.0 * mu) * (k * ga), -mu * chi)
    Su = _mat2(mu * chi, (2.0 * mu) * (k * gb), (2.0 * mu) * (k * ga), -mu * chi)
    return _Blocks(Ud, Uu, Sd, Su, ga, gb, iga, igb)


class _Stack(NamedTuple):
    """Two-port R/T response of a welded stack: (..., 2, 2) P-SV matrices or
    (...) SH scalars."""

    RD: torch.Tensor
    TD: torch.Tensor
    RU: torch.Tensor
    TU: torch.Tensor


def _eye2(dtype, device):
    return torch.eye(2, dtype=dtype, device=device)


def _stack2_identity(dtype, device) -> _Stack:
    zero, eye = torch.zeros(2, 2, dtype=dtype, device=device), _eye2(dtype, device)
    return _Stack(RD=zero, TD=eye, RU=zero, TU=eye)


def _stacksh_identity(dtype, device) -> _Stack:
    zero, one = (torch.tensor(v, dtype=dtype, device=device) for v in (0.0, 1.0))
    return _Stack(RD=zero, TD=one, RU=zero, TU=one)


def _stack2_compose(s1: _Stack, s2: _Stack) -> _Stack:
    """Kennett composition of stack s1 on top of stack s2 (all internal
    multiples summed by the (I - R R)^{-1} reverberators)."""
    eye = _eye2(s1.RD.dtype, s1.RD.device)
    x = _inv2(eye - _mm(s1.RU, s2.RD))
    # push-through identity: (I - R2 R1)^{-1} = I + R2 (I - R1 R2)^{-1} R1,
    # one 2x2 solve per composition
    y = eye + _mm(s2.RD, x, s1.RU)
    return _Stack(RD=s1.RD + _mm(s1.TU, s2.RD, x, s1.TD),
                  TD=_mm(s2.TD, x, s1.TD),
                  RU=s2.RU + _mm(s2.TD, s1.RU, y, s2.TU),
                  TU=_mm(s1.TU, y, s2.TU))


def _stacksh_compose(s1: _Stack, s2: _Stack) -> _Stack:
    x = 1.0 / (1.0 - s1.RU * s2.RD)
    return _Stack(RD=s1.RD + s1.TU * s2.RD * x * s1.TD,
                  TD=s2.TD * x * s1.TD,
                  RU=s2.RU + s2.TD * s1.RU * x * s2.TU,
                  TU=s1.TU * x * s2.TU)


def _phase(ig, h):
    """e^{i g h} for i*g (nf, nk) and per-source thicknesses h (K,)."""
    return torch.exp(ig * h[:, None, None])


def _stack2_compose_phase(s: _Stack, iga, igb, h) -> _Stack:
    """compose(s, phase layer): the phase layer's two-port has R = 0 and T =
    diag(e_a, e_b), so the composition is four diagonal scalings."""
    e = torch.stack([_phase(iga, h), _phase(igb, h)], -1)
    row = lambda m: m * e[..., :, None]                   # diag(e) @ m
    col = lambda m: m * e[..., None, :]                   # m @ diag(e)
    return _Stack(RD=s.RD, TD=row(s.TD), RU=row(col(s.RU)), TU=col(s.TU))


def _stacksh_compose_phase(s: _Stack, igb, h) -> _Stack:
    e = _phase(igb, h)
    return _Stack(RD=s.RD, TD=e * s.TD, RU=e * s.RU * e, TU=s.TU * e)


def _interface2(b1: _Blocks, b2: _Blocks) -> _Stack:
    """P-SV interface R/T between medium 1 (above) and medium 2 (below), from
    continuity of (u_x', u_z, szz, sxz) by 2x2 block elimination."""
    iUd2 = _inv2(b2.Ud)
    iUu1 = _inv2(b1.Uu)
    RD = _mm(_inv2(b1.Su - _mm(b2.Sd, iUd2, b1.Uu)), _mm(b2.Sd, iUd2, b1.Ud) - b1.Sd)
    TD = _mm(iUd2, b1.Ud + _mm(b1.Uu, RD))
    RU = _mm(_inv2(b2.Sd - _mm(b1.Su, iUu1, b2.Ud)), _mm(b1.Su, iUu1, b2.Uu) - b2.Su)
    TU = _mm(iUu1, b2.Uu + _mm(b2.Ud, RU))
    return _Stack(RD=RD, TD=TD, RU=RU, TU=TU)


def _interfacesh(mu1, gb1, mu2, gb2) -> _Stack:
    """SH interface: impedance forms z_i = mu_i gb_i."""
    z1, z2 = mu1 * gb1, mu2 * gb2
    den = z1 + z2
    return _Stack(RD=(z1 - z2) / den, TD=2.0 * z1 / den,
                  RU=(z2 - z1) / den, TU=2.0 * z2 / den)


def _where_stack(mask, a: _Stack, b: _Stack, nbatch: int) -> _Stack:
    """Per source (mask (K,)), stack ``a`` where True and ``b`` elsewhere;
    ``nbatch`` trailing dims follow the source axis."""
    m = mask.reshape(mask.shape + (1,) * nbatch)
    return _Stack(*(torch.where(m, x, y) for x, y in zip(a, b)))


# ---------------------------------------------------------------------------
# source terms: up/down-going amplitudes radiated by a point moment tensor,
# per azimuthal channel (m0, m1 cos, m1 sin, m2 cos, m2 sin) from
#   a0 = (Mxx+Myy)/2, a0z = Mzz, a1c = Mxz, a1s = Myz, a2c = (Mxx-Myy)/2,
#   a2s = Mxy (z-down frame), common factor -1/(4 pi^2 rho_s) applied later.
# ---------------------------------------------------------------------------


def _psv_sources(k, om_c, ga, gb, chi, a):
    """(sigma_up, sigma_down), (G, nf, 5, nk, 2) P-SV potential amplitudes
    for the source-layer (G, nf, nk) wavenumbers and a coefficients (G, 1, 1)."""
    a0, a0z, a1c, a1s, a2c, a2s = a
    w2 = (om_c * om_c)[:, None]
    pm0 = -1j * ((k * k * a0 + ga * ga * a0z) / (2.0 * ga * w2))
    sv0 = 1j * ((k * (a0z - a0)) / (2.0 * w2))
    p2 = -1j * ((k * k) / (2.0 * ga * w2))
    sv1 = -1j * (chi / (2.0 * gb * w2))
    sv2 = -1j * (k / (2.0 * w2))
    p1 = 1j * (k / w2)
    pair = lambda p, s: torch.stack(torch.broadcast_tensors(p, s), -1)
    up = [pair(pm0, sv0), pair(p1 * a1c, sv1 * a1c), pair(p1 * a1s, sv1 * a1s),
          pair(p2 * a2c, sv2 * a2c), pair(p2 * a2s, sv2 * a2s)]
    down = [pair(pm0, -sv0), pair(-p1 * a1c, sv1 * a1c), pair(-p1 * a1s, sv1 * a1s),
            pair(p2 * a2c, -sv2 * a2c), pair(p2 * a2s, -sv2 * a2s)]
    return torch.stack(up, 2), torch.stack(down, 2)


def _sh_sources(k, gb, beta, a):
    """(sigma_up, sigma_down), (G, nf, 4, nk) SH amplitudes of channels m1c,
    m1s, m2c, m2s (a symmetric M radiates no axisymmetric SH)."""
    _, _, a1c, a1s, a2c, a2s = a
    b2 = 2.0 * beta * beta
    kk = k / (b2 * gb)
    const = lambda v: (v / b2).expand(gb.shape).to(gb.dtype)
    up = [const(-a1s), const(a1c), kk * a2s, -kk * a2c]
    down = [const(a1s), const(-a1c), kk * a2s, -kk * a2c]
    return torch.stack(up, 2), torch.stack(down, 2)


# ---------------------------------------------------------------------------
# stage A: the moment-independent surface operator. The source may sit in any
# layer; which one is known per source, so the A-stack (free surface down to
# the source level) and the B-stack (source level down to the half-space) are
# built with every interface present, masked to the identity two-port on the
# wrong side of the source, and with the layer phases limited to the partial
# thickness on the right side. Smooth in depth within a layer.
# ---------------------------------------------------------------------------


class _Reverb(NamedTuple):
    """The depth-smooth part of the surface operator, per source (K, nf, nk)."""

    W2: torch.Tensor     # (.., 2, 2) upgoing at the source -> surface displacement
    RA2: torch.Tensor    # (.., 2, 2) reflection looking up from the source level
    RB2: torch.Tensor    # (.., 2, 2) reflection looking down from the source level
    inner2: torch.Tensor  # (.., 2, 2) (I - RA RB)^-1 source-level reverberator
    Wsh: torch.Tensor
    RAsh: torch.Tensor
    RBsh: torch.Tensor
    innersh: torch.Tensor


class _SourceLayer(NamedTuple):
    """Source-layer material, piecewise constant in depth (no gradient)."""

    ga: torch.Tensor     # (K, nf, nk)
    gb: torch.Tensor
    chi: torch.Tensor    # 2 k^2 - om^2 / vs^2
    vs: torch.Tensor     # (K,)
    rho: torch.Tensor    # (K,)


class _SurfaceOperator(NamedTuple):
    rev: _Reverb
    src: _SourceLayer


class _Band(NamedTuple):
    """One frequency band's grids and complex dtype of its stack algebra."""

    om: np.ndarray       # (nf_band,) angular frequencies, float64
    cdtype: torch.dtype


def _surface_operator(model: LayeredModel, z, band: _Band, k_np, alpha_damp):
    """The surface operator of one band for source depths z (K,).

    The layer eigenblocks and the interface R/T depend on the model and the
    grids only: they are solved once per call, outside the layer loops,
    which hold only the partial thicknesses, the masks and the stack
    compositions."""
    cdtype, device = band.cdtype, z.device
    rdtype = torch.float64 if cdtype == torch.complex128 else torch.float32
    model = model.to(device, rdtype)
    z = z.to(rdtype)
    k = torch.as_tensor(k_np, dtype=rdtype, device=device)
    om = torch.as_tensor(band.om, dtype=rdtype, device=device)
    om_c = torch.complex(om, torch.full_like(om, alpha_damp))
    nlay = model.nlayers
    iface_depth = model.interfaces()
    tops = torch.cat([iface_depth.new_zeros(1), iface_depth])
    zbot = torch.cat([iface_depth, iface_depth.new_full((1,), math.inf)])

    blk = _psv_blocks(k, om_c, model.vp, model.vs, model.rho)
    head = _Blocks(*(b[:-1] for b in blk))
    tail = _Blocks(*(b[1:] for b in blk))
    ifaces2 = _interface2(head, tail)                       # (nlay-1, nf, nk, 2, 2)
    mu = model.rho * model.vs ** 2
    ifacessh = _interfacesh(mu[:-1, None, None], blk.gb[:-1],
                            mu[1:, None, None], blk.gb[1:])
    ident2 = _stack2_identity(cdtype, device)
    identsh = _stacksh_identity(cdtype, device)
    eye = _eye2(cdtype, device)
    Ud0, Uu0 = blk.Ud[0], blk.Uu[0]
    RF2 = -_mm(_inv2(blk.Sd[0]), blk.Su[0])                 # traction-free surface
    rfsh = 1.0
    WF2 = Uu0 + _mm(Ud0, RF2)

    def reverb(zs):
        h_above = torch.clamp_min(torch.minimum(zbot, zs[:, None]) - tops, 0.0)
        h_below = torch.clamp_min(torch.clamp_max(zbot, 1e9) - torch.maximum(tops, zs[:, None]),
                                  0.0)
        in_a = iface_depth <= zs[:, None]                   # (K, nlay-1)
        SA2, SAsh = ident2, identsh
        for i in range(nlay):
            if i > 0:
                SA2 = _stack2_compose(SA2, _where_stack(
                    in_a[:, i - 1], _Stack(*(f[i - 1] for f in ifaces2)), ident2, 4))
                SAsh = _stacksh_compose(SAsh, _where_stack(
                    in_a[:, i - 1], _Stack(*(f[i - 1] for f in ifacessh)), identsh, 2))
            SA2 = _stack2_compose_phase(SA2, blk.iga[i], blk.igb[i], h_above[:, i])
            SAsh = _stacksh_compose_phase(SAsh, blk.igb[i], h_above[:, i])
        # B-stack; the half-space's own phase cannot change RD seen from above
        SB2, SBsh = ident2, identsh
        for i in range(nlay - 1):
            SB2 = _stack2_compose_phase(SB2, blk.iga[i], blk.igb[i], h_below[:, i])
            SBsh = _stacksh_compose_phase(SBsh, blk.igb[i], h_below[:, i])
            SB2 = _stack2_compose(SB2, _where_stack(
                ~in_a[:, i], _Stack(*(f[i] for f in ifaces2)), ident2, 4))
            SBsh = _stacksh_compose(SBsh, _where_stack(
                ~in_a[:, i], _Stack(*(f[i] for f in ifacessh)), identsh, 2))
        # receiver map: upgoing at the source level -> displacement at z = 0,
        # with the free-surface conversion and the A-stack reverberations
        rev2 = _inv2(eye - _mm(SA2.RD, RF2))
        W2 = _mm(WF2, rev2, SA2.TU)
        RA2 = SA2.RU + _mm(SA2.TD, RF2, rev2, SA2.TU)
        revsh = 1.0 / (1.0 - SAsh.RD * rfsh)
        Wsh = (1.0 + rfsh) * revsh * SAsh.TU
        RAsh = SAsh.RU + SAsh.TD * rfsh * revsh * SAsh.TU
        # a one-layer model has no interface below the source: RB = 0
        RB2, RBsh = SB2.RD.expand(RA2.shape), SBsh.RD.expand(RAsh.shape)
        return _Reverb(W2=W2, RA2=RA2, RB2=RB2, inner2=_inv2(eye - _mm(RA2, RB2)),
                       Wsh=Wsh, RAsh=RAsh, RBsh=RBsh, innersh=1.0 / (1.0 - RAsh * RBsh))

    ls = torch.searchsorted(iface_depth, z.detach().contiguous(), right=True)
    vs_s = model.vs[ls]
    src = _SourceLayer(ga=blk.ga[ls], gb=blk.gb[ls],
                       chi=2.0 * k * k - (om_c * om_c)[:, None] / (vs_s * vs_s)[:, None, None],
                       vs=vs_s, rho=model.rho[ls])
    return _SurfaceOperator(reverb(z), src)


# ---------------------------------------------------------------------------
# stage B: moment coefficients -> surface response -> Bessel assembly over
# wavenumber -> receiver spectra -> seismograms
# ---------------------------------------------------------------------------


def _moment_coeffs(mxyz):
    """Moment tensor (..., 3, 3) in the (x=N, y=E, z=Up) frame -> the six
    azimuthal coefficients (a0, a0z, a1c, a1s, a2c, a2s), (...) each, in
    the z-down frame. Linear in ``mxyz``."""
    m = mxyz * _flip_z(mxyz.dtype, mxyz.device)
    return ((m[..., 0, 0] + m[..., 1, 1]) / 2.0, m[..., 2, 2], m[..., 0, 2],
            m[..., 1, 2], (m[..., 0, 0] - m[..., 1, 1]) / 2.0, m[..., 0, 1])


def _response(rev: _Reverb, src: _SourceLayer, k, om_c, a):
    """Surface displacements per channel: P-SV (G, nf, 5, nk, 2) (u along
    k-hat, u_z down) and SH (G, nf, 4, nk); common factor -1/(4 pi^2 rho_s)
    not yet applied."""
    su, sd = _psv_sources(k, om_c, src.ga, src.gb, src.chi, a)
    apply = lambda m, v: m[:, :, None, ..., 0] * v[..., :1] + m[:, :, None, ..., 1] * v[..., 1:]
    rhs = sd + apply(rev.RA2, su)
    db = apply(rev.inner2, rhs)
    ua = su + apply(rev.RB2, db)
    u2 = apply(rev.W2, ua)
    sush, sdsh = _sh_sources(k, src.gb, src.vs[:, None, None], a)
    sh = lambda f: f[:, :, None]
    rhssh = sdsh + sh(rev.RAsh) * sush
    dbsh = sh(rev.innersh) * rhssh
    uash = sush + sh(rev.RBsh) * dbsh
    ush = sh(rev.Wsh) * uash
    return u2, ush


def _contract(mat, vec):
    """sum_k mat[g, r, k] vec[g, f, c, k] -> (g, r, f, c): one real matrix
    product over the wavenumbers, in float64 whatever the working dtype, so
    it is exact to float64 rounding and out of reach of the TF32 switch."""
    g, nf, nc, nk = vec.shape
    v = torch.view_as_real(vec.permute(0, 3, 1, 2)).reshape(g, nk, nf * nc * 2)
    out = (mat.double() @ v.double()).to(mat.dtype)
    return torch.view_as_complex(out.reshape(g, mat.shape[1], nf, nc, 2))


# (P-SV channel indices, SH channel indices) of azimuthal order m
_ORDER_CHANNELS = {0: ([0], []), 1: ([1, 2], [0, 1]), 2: ([3, 4], [2, 3])}


def _ipow(z, p: int):
    """i**p * z."""
    return (z, 1j * z, -z, -1j * z)[p % 4]


def _assemble(u2, ush, r, phi, rho_s, k, dk):
    """Channel responses (G, nf, 5, nk, 2) and (G, nf, 4, nk) at receivers
    (G, R) offsets r and azimuths phi -> (G, R, 3, nf) cartesian (x, y,
    z-down) spectra. Per unit k weight, with P = J'_m(kr), Q = m J_m/(kr),
    Z = J_m(kr):
      cos-type: u_r = i^{m+1}[-P h cos - Q s sin], u_phi = i^{m+1}[Q h sin -
                P s cos], u_z = i^m Z v cos  (of m phi);
      sin-type: u_r = i^{m+1}[-P h sin + Q s cos], u_phi = i^{m+1}[-Q h cos -
                P s sin], u_z = i^m Z v sin."""
    x = r[..., None] * k                                   # (G, R, nk)
    j = bessel_j0123(x)
    xs = torch.where(x > 1e-12, x, 1.0)
    jp = (-j[1], 0.5 * (j[0] - j[2]), 0.5 * (j[1] - j[3]))
    jq = (None, j[1] / xs, 2.0 * j[2] / xs)
    w = k * dk                                             # midpoint weights
    hw, vw, sw = u2[..., 0] * w, u2[..., 1] * w, ush * w
    ur = uphi = uz = 0.0
    for m, (ic, isx) in _ORDER_CHANNELS.items():
        hs = torch.cat([hw[:, :, ic], sw[:, :, isx]], 2) if isx else hw[:, :, ic]
        Pc = _contract(jp[m], hs)
        Qc = _contract(jq[m], hs) if isx else None
        Zc = _contract(j[m], vw[:, :, ic])
        cm, sm = torch.cos(m * phi)[..., None], torch.sin(m * phi)[..., None]
        for n, c in enumerate(ic):
            Ph, Zv = Pc[..., n], Zc[..., n]
            if not isx:                                    # m = 0: no Q, no SH
                ur = ur + _ipow(-Ph * cm, m + 1)
                uz = uz + _ipow(Zv * cm, m)
                continue
            Qh, Ps, Qs = Qc[..., n], Pc[..., len(ic) + n], Qc[..., len(ic) + n]
            if c in (1, 3):                                # cos-type
                ur = ur + _ipow(-Ph * cm - Qs * sm, m + 1)
                uphi = uphi + _ipow(Qh * sm - Ps * cm, m + 1)
                uz = uz + _ipow(Zv * cm, m)
            else:
                ur = ur + _ipow(-Ph * sm + Qs * cm, m + 1)
                uphi = uphi + _ipow(-Qh * cm - Ps * sm, m + 1)
                uz = uz + _ipow(Zv * sm, m)
    # the sign is pinned by the whole-space oracle
    pref = (1.0 / (2.0 * math.pi * rho_s))[:, None, None]
    ur, uphi, uz = pref * ur, pref * uphi, pref * uz
    cp, sp = torch.cos(phi)[..., None], torch.sin(phi)[..., None]
    return torch.stack([ur * cp - uphi * sp, ur * sp + uphi * cp, uz], -2)


def _stf_cutoff(stf, om_max: float) -> float:
    """Angular-frequency support bound of the source time function."""
    if stf[0] == "clp_step":
        return min(om_max, 2.0 * math.pi * float(stf[2]))
    if stf[0] == "gauss":
        a = (math.pi * float(stf[1])) ** 2
        return min(om_max, 2.0 * math.sqrt(a * math.log(1e12)))
    return om_max


class _SynthPlan(NamedTuple):
    """Frequency/wavenumber layout, numpy float64."""

    om_np: np.ndarray      # (nf,) the rfft angular-frequency grid
    nfft: int
    k_np: np.ndarray       # (nk,) wavenumber midpoints
    dk: float
    bands: tuple           # the one _Band of active (STF-supported) frequencies


def _synth_plan(nt, dt, pad, stf, nk, kmax) -> _SynthPlan:
    """The active frequencies in one complex128 band."""
    nfft = int(pad * nt)
    dom = 2.0 * math.pi / (nfft * dt)
    om_np = np.arange(nfft // 2 + 1, dtype=np.float64) * dom
    n_act = min(om_np.shape[0], int(_stf_cutoff(stf, dom * (nfft // 2)) / dom) + 2)
    bands = (_Band(om_np[:n_act], torch.complex128),)
    dk = kmax / nk
    return _SynthPlan(om_np=om_np, nfft=nfft, k_np=(np.arange(nk, dtype=np.float64) + 0.5) * dk,
                      dk=dk, bands=bands)


def _finish_synthesis(spec, plan: _SynthPlan, nt, dt, stf, alpha_damp, t0):
    """Active-band spectra (..., 3, n_act) -> (..., 3, nt) seismograms: zero
    fill to the full rfft grid, source spectrum and origin-time shift,
    inverse FFT with the damping removed, z-down -> z-up."""
    dtype = spec.real.dtype
    if dtype != torch.float64:
        # Im U(omega = 0) is 0 exactly for a real signal's spectrum; pin it
        spec = torch.complex(spec.real, torch.cat([torch.zeros_like(spec.imag[..., :1]),
                                                   spec.imag[..., 1:]], -1))
    om = torch.as_tensor(plan.om_np, dtype=dtype, device=spec.device)
    spec = torch.cat([spec, spec.new_zeros(spec.shape[:-1] + (om.shape[0] - spec.shape[-1],))], -1)
    om_cw = torch.complex(om, torch.full_like(om, alpha_damp))
    s = stf_spectrum(om, om_cw, stf, dtype) * torch.exp(1j * om_cw * (-t0))
    u = _synthesize(spec * s, nt, dt, alpha_damp, plan.nfft)
    return u * torch.tensor([1.0, 1.0, -1.0], dtype=dtype, device=u.device)[:, None]


def _band_responses(ops, a, plan: _SynthPlan, alpha_damp, dtype):
    """Channel responses (:func:`_response`) of every band, in the complex
    dtype of ``dtype``, the bands concatenated over frequency."""
    cwork = torch.complex128 if dtype == torch.float64 else torch.complex64
    device = ops[0].src.rho.device
    parts = []
    for op, band in zip(ops, plan.bands):
        rdtype = band.cdtype.to_real()
        kb = torch.as_tensor(plan.k_np, dtype=rdtype, device=device)
        om_c = torch.complex(torch.as_tensor(band.om, dtype=rdtype, device=device),
                             torch.full((len(band.om),), alpha_damp, dtype=rdtype, device=device))
        u2, ush = _response(op.rev, op.src, kb, om_c, a)
        parts.append((u2.to(cwork), ush.to(cwork)))
    return tuple(torch.cat(p, 1) for p in zip(*parts))


def _k(plan: _SynthPlan, like) -> torch.Tensor:
    """The wavenumber midpoints in the dtype and on the device of ``like``."""
    return torch.as_tensor(plan.k_np, dtype=torch.float64, device=like.device).to(like.dtype)


def _offsets(stns: StationSet, x, y):
    """Range r (clamped at 1e-6) and azimuth phi of the stations from sources
    (..., 1) at x, y: (..., nr) each."""
    dxr = stns.x - x
    dyr = stns.y - y
    return torch.clamp_min(torch.sqrt(dxr * dxr + dyr * dyr), 1e-6), torch.atan2(dyr, dxr)


def _as_sources(x, y, z, like):
    """x, y, z as tensors of the dtype and device of ``like``, at least 1-D."""
    arr = lambda v: torch.atleast_1d(torch.as_tensor(v, dtype=like.dtype, device=like.device))
    return arr(x), arr(y), arr(z)


def make_layered_stages(model: LayeredModel, nt: int = 61,
                        dt: float = 1.0, stf=("clp_step", 0.05, 0.2),
                        alpha_damp: float = 0.023, pad: int = 2,
                        t0: float = 0.0, nk: int = 1024, kmax: float = 2.5):
    """The two halves of the synthesis:

      * ``stage_a(z)`` -> ops: the moment-independent surface operators of K
        source depths z (K,) (the stack recursion, the expensive stage).
      * ``stage_b(ops, x, y, z, a, stations)`` -> seismograms: moment
        coefficients ``a`` (:func:`_moment_coeffs`, () or (K,) each)
        applied, the Bessel assembly and the FFT synthesis. Sources x, y, z
        are (K,), one per operator, giving (K, nr, 3, nt), or (K, n), n
        sources sharing each operator, giving (K, n, nr, 3, nt). ``z`` picks
        nothing (the operator holds its layer).

    The stack algebra runs in complex128; stage B runs in the stations'
    dtype. Returns ``(stage_a, stage_b)``.
    """
    plan = _synth_plan(nt, dt, pad, stf, nk, kmax)

    def stage_a(z):
        return tuple(_surface_operator(model, torch.atleast_1d(z), band, plan.k_np, alpha_damp)
                     for band in plan.bands)

    def stage_b(ops, x, y, z, a, stns: StationSet):
        like = stns.x
        dtype = like.dtype
        x, y, z = _as_sources(x, y, z, like)
        grouped = x.dim() == 2
        if not grouped:
            x, y, z = x[:, None], y[:, None], z[:, None]
        g, n = x.shape
        nr = like.shape[0]
        a = tuple(torch.as_tensor(ai).reshape(-1, 1, 1) for ai in a)
        u2, ush = _band_responses(ops, a, plan, alpha_damp, dtype)
        r, phi = _offsets(stns, x[..., None], y[..., None])
        spec = _assemble(u2, ush, r.reshape(g, n * nr), phi.reshape(g, n * nr),
                         ops[0].src.rho.to(dtype), _k(plan, like), plan.dk).reshape(g, n, nr, 3, -1)
        u = _finish_synthesis(spec, plan, nt, dt, stf, alpha_damp, t0)
        return u if grouped else u[:, 0]

    return stage_a, stage_b


def make_layered_forward(stations: StationSet, model: LayeredModel, nt: int = 61,
                         dt: float = 1.0, **kw):
    """The layered physics as ``forward(x, y, z, mxyz) -> (k, nr, 3, nt)``
    for sources (k,) (``(nr, 3, nt)`` for scalars), differentiable by plain
    autograd through everything, the stack algebra of stage A included.
    Extra keywords go to :func:`make_layered_stages` (nk, kmax, stf,
    alpha_damp, t0, ...)."""
    stage_a, stage_b = make_layered_stages(model=model, nt=nt, dt=dt, **kw)

    def forward(x, y, z, mxyz):
        like = stations.x
        single = torch.as_tensor(x).dim() == 0
        x, y, z = _as_sources(x, y, z, like)
        u = stage_b(stage_a(z), x, y, z, _moment_coeffs(torch.as_tensor(mxyz, dtype=like.dtype,
                                                                        device=like.device)),
                    stations)
        return u[0] if single else u

    return forward
