"""Layered-medium seismograms: differentiable frequency-wavenumber synthesis.

Counterpart of waveform_ot_tpu.models.layered, the pyprop8 replacement the
reference's Figs 9-12 run on: a plane-layered elastic half-space response to
a point moment-tensor source, from

  * the per-(frequency, wavenumber) Kennett reflection-matrix recursion in
    closed-form 2x2 complex block algebra (P-SV) and scalars (SH);
  * source up/down-going amplitudes from the plane-wave decomposition of the
    whole-space moment-tensor field (checked against
    :func:`wholespace_seismograms`);
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
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from waveform_ot_torch.models.seismo import StationSet, mxyz_from_upper

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
        ctx.save_for_forward(x)
        return j[:4].clone()

    @staticmethod
    def backward(ctx, g):
        (j,) = ctx.saved_tensors
        return (g * _bessel_slopes(j)).sum(0)

    @staticmethod
    def jvp(ctx, gx):
        (x,) = ctx.saved_tensors
        return _bessel_slopes(_bessel_orders(x, 5)) * gx


def bessel_j0123(x: torch.Tensor) -> torch.Tensor:
    """Stacked (4, ...) J0(x), J1(x), J2(x), J3(x) for x >= 0, differentiable
    in reverse and forward mode by the exact recurrence, so derivatives are
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


def fukuoka_model(dtype=torch.float64, device="cuda") -> LayeredModel:
    """The six-layer crust of the reference's Fukuoka-earthquake example
    (source_location_cmt_W2L2_Figs_9_10_11.ipynb cell 10)."""
    return layered_model_from_table(
        [(0.1, 3.2, 2.0, 2.1),
         (1.9, 5.15, 2.85, 2.5),
         (3.0, 5.5, 3.2, 2.6),
         (13.0, 6.0, 3.46, 2.7),
         (14.0, 6.7, 3.87, 2.8),
         (float("inf"), 7.7, 4.3, 3.3)], dtype, device)


def uniform_model(vp=6.0, vs=3.46, rho=2.7, nlayers: int = 1,
                  thickness: float = 5.0, dtype=torch.float64,
                  device="cuda") -> LayeredModel:
    """Uniform half-space, optionally split into identical layers."""
    full = lambda v: torch.full((nlayers,), v, dtype=dtype, device=device)
    return LayeredModel(thickness=full(thickness), vp=full(vp), vs=full(vs), rho=full(rho))


# ---------------------------------------------------------------------------
# frequency synthesis. Fields carry e^{-i omega t}; U(omega) = int u e^{+i
# omega t} dt, so u(t_j) = irfft(conj(U))/dt. Spectra are taken at omega_n +
# i sigma and the series multiplied by e^{+sigma t} after the inverse FFT.
# ---------------------------------------------------------------------------


def _synthesis_grid(nt: int, dt, pad: int = 2, dtype=torch.float64, device="cuda"):
    """(omega_real (nf,), nfft) for an rfft grid padded ``pad`` x."""
    nfft = int(pad * nt)
    om = 2.0 * math.pi * torch.arange(nfft // 2 + 1, dtype=dtype, device=device) / (nfft * dt)
    return om, nfft


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
# whole-space oracle
# ---------------------------------------------------------------------------


def _radial_derivatives(om_c, c, r):
    """f', f'' and f''' of f(r) = e^{i kc r}/r, kc = om_c/c: (nr, nf) each."""
    kc = (om_c / c)[None, :]
    r = r[:, None]
    e = torch.exp(1j * kc * r)
    f1 = e * (1j * kc / r - 1.0 / r ** 2)
    f2 = e * (-kc * kc / r - 2j * kc / r ** 2 + 2.0 / r ** 3)
    f3 = e * (-1j * kc ** 3 / r + 3.0 * kc * kc / r ** 2 + 6j * kc / r ** 3 - 6.0 / r ** 4)
    return f1, f2, f3


def wholespace_seismograms(x, y, z, mxyz, stations: StationSet, nt: int = 61,
                           dt: float = 1.0, vp=6.0, vs=3.46, rho=2.7,
                           stf=("gauss", 0.08), alpha_damp: float = 0.023,
                           pad: int = 2, t0: float = 0.0):
    """Closed-form whole-space moment-tensor seismograms (t (nt,), u (nr, 3,
    nt)) for one source, near + intermediate + far field, with the synthesis
    conventions of :func:`layered_seismograms`: the oracle that the layered
    forward with ``free_surface=False`` on a uniform model reproduces.

    u_i = -(1/(4 pi rho omega^2)) [kb^2 (M grad g_b)_i + d_i (grad^T M grad)
    (g_b - g_a)], g_c = e^{i omega |x|/c}/|x|, with the derivatives of the
    radial function written out (the JAX package takes them by autodiff)."""
    dtype, device = stations.x.dtype, stations.x.device
    om, nfft = _synthesis_grid(nt, dt, pad=pad, dtype=dtype, device=device)
    om_c = torch.complex(om, torch.full_like(om, alpha_damp))
    m_int = torch.as_tensor(mxyz, dtype=dtype, device=device) * _flip_z(dtype, device)
    src = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    xrel = torch.stack([stations.x - src(x), stations.y - src(y),
                        (-src(z)).expand(stations.x.shape)], -1)      # (nr, 3) z-down
    r = torch.linalg.vector_norm(xrel, dim=-1)
    gam = (xrel / r[:, None])[:, None, :]                             # (nr, 1, 3)
    mg = (gam[..., None, :] * m_int).sum(-1)                          # (M gamma)_i
    msg = (gam[..., None, :] * (m_int + m_int.T)).sum(-1)             # ((M + M^T) gamma)_i
    gmg = (mg * gam).sum(-1, keepdim=True)                            # (nr, 1, 1)
    trm = torch.diagonal(m_int).sum()
    rr = r[:, None, None]

    def d_hessian_sum(c):
        """d_l sum_ij M_ij d_i d_j g_c, (nr, nf, 3)."""
        f1, f2, f3 = (f[..., None] for f in _radial_derivatives(om_c, c, r))
        d = f2 - f1 / rr
        return ((f3 - f2 / rr + f1 / rr ** 2) * gam * gmg
                + d * (msg - 2.0 * gam * gmg) / rr
                + (f2 / rr - f1 / rr ** 2) * gam * trm)

    f1b = _radial_derivatives(om_c, vs, r)[0][..., None]
    mdg = f1b * mg                                                    # M grad g_b
    third = d_hessian_sum(vs) - d_hessian_sum(vp)
    kb2 = ((om_c / vs) ** 2)[:, None]
    spec = -(kb2 * mdg + third) / (4.0 * math.pi * rho * (om_c * om_c)[:, None])
    s = stf_spectrum(om, om_c, stf, dtype) * torch.exp(1j * om_c * (-t0))
    u = _synthesize(spec.movedim(-1, 1) * s, nt, dt, alpha_damp, nfft)
    u = u * torch.tensor([1.0, 1.0, -1.0], dtype=dtype, device=device)[:, None]
    return t0 + dt * torch.arange(nt, dtype=dtype, device=device), u


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


def _surface_operator(model: LayeredModel, z, band: _Band, k_np, alpha_damp,
                      free_surface: bool, tangent: bool):
    """The surface operator of one band for source depths z (K,), and with
    ``tangent`` its derivative in z (:func:`_depth_tangent`), else None.

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
    if free_surface:
        RF2 = -_mm(_inv2(blk.Sd[0]), blk.Su[0])             # traction-free surface
        rfsh = 1.0
    else:
        RF2 = torch.zeros_like(Ud0)
        rfsh = 0.0
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
    rev = reverb(z)
    return _SurfaceOperator(rev, src), (_depth_tangent(rev, src) if tangent else None)


def _depth_tangent(rev: _Reverb, src: _SourceLayer) -> _Reverb:
    """d(rev)/dz in closed form. The depth enters only through the source
    layer's two partial phases, E_a = diag(e^{i ga h_a}, e^{i gb h_a}) with
    h_a = z - top above the source and E_b with h_b = bottom - z below it:
    every other phase and interface is fixed or masked. The A-stack ends
    in E_a and the B-stack starts with E_b, so W2 = W E_a, RA2 = E_a RA E_a
    and RB2 = E_b RB E_b (SH alike, with e^{i gb h}), and d/dz multiplies by
    iG = diag(i ga, i gb) from the sides (with a minus sign below)."""
    ig = torch.stack([1j * src.ga, 1j * src.gb], -1)
    sides = lambda m: ig[..., :, None] * m + m * ig[..., None, :]    # iG m + m iG
    dRA2, dRB2 = sides(rev.RA2), -sides(rev.RB2)
    igb = 1j * src.gb
    dRAsh, dRBsh = 2.0 * igb * rev.RAsh, -2.0 * igb * rev.RBsh
    return _Reverb(
        W2=rev.W2 * ig[..., None, :], RA2=dRA2, RB2=dRB2,
        inner2=_mm(rev.inner2, _mm(dRA2, rev.RB2) + _mm(rev.RA2, dRB2), rev.inner2),
        Wsh=igb * rev.Wsh, RAsh=dRAsh, RBsh=dRBsh,
        innersh=rev.innersh * rev.innersh * (dRAsh * rev.RBsh + rev.RAsh * dRBsh))


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


def _response(rev: _Reverb, src: _SourceLayer, k, om_c, a, drev: _Reverb | None = None):
    """Surface displacements per channel: P-SV (G, nf, 5, nk, 2) (u along
    k-hat, u_z down) and SH (G, nf, 4, nk); common factor -1/(4 pi^2 rho_s)
    not yet applied. With ``drev`` also their derivative along it (the
    response is linear in each operator field), else None."""
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
    if drev is None:
        return u2, ush, None
    with torch.no_grad():
        ddb = apply(drev.inner2, rhs) + apply(rev.inner2, apply(drev.RA2, su))
        du2 = apply(drev.W2, ua) + apply(rev.W2, apply(drev.RB2, db) + apply(rev.RB2, ddb))
        ddbsh = sh(drev.innersh) * rhssh + sh(rev.innersh) * sh(drev.RAsh) * sush
        dush = sh(drev.Wsh) * uash + sh(rev.Wsh) * (sh(drev.RBsh) * dbsh + sh(rev.RBsh) * ddbsh)
    return u2, ush, (du2, dush)


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


class _DepthLink(torch.autograd.Function):
    """``value`` unchanged; the source depth ``z`` gets <grad, tangent>, where
    ``tangent`` is d(value)/dz: the value's dependence on z linearized, so z's
    gradient costs no reverse sweep of the stack algebra."""

    @staticmethod
    def forward(ctx, value, z, tangent):
        ctx.save_for_backward(tangent)
        ctx.zdim = z.dim()
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        (tangent,) = ctx.saved_tensors
        gz = (g * tangent.conj()).real
        return g, gz.sum(dim=tuple(range(ctx.zdim, gz.dim()))), None


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
    bands: tuple           # _Band per band of active (STF-supported) frequencies


def _synth_plan(nt, dt, pad, stf, nk, kmax, hp_below) -> _SynthPlan:
    """The active frequencies split at ``hp_below`` (rad/s) into a complex128
    band below and a complex64 band above (either may be empty)."""
    nfft = int(pad * nt)
    dom = 2.0 * math.pi / (nfft * dt)
    om_np = np.arange(nfft // 2 + 1, dtype=np.float64) * dom
    n_act = min(om_np.shape[0], int(_stf_cutoff(stf, dom * (nfft // 2)) / dom) + 2)
    n_lo = n_act if math.isinf(hp_below) else min(n_act, max(0, int(math.ceil(hp_below / dom))))
    bands = tuple(_Band(om_np[lo:hi], cd) for lo, hi, cd in
                  ((0, n_lo, torch.complex128), (n_lo, n_act, torch.complex64)) if hi > lo)
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


def _band_responses(ops, dops, a, plan: _SynthPlan, alpha_damp, dtype):
    """Channel responses (:func:`_response`) of every band, in the complex
    dtype of ``dtype``, the bands concatenated over frequency; given the
    operators' z-derivatives ``dops``, the responses' z-derivatives follow
    as a second half."""
    cwork = torch.complex128 if dtype == torch.float64 else torch.complex64
    device = ops[0].src.rho.device
    parts, dparts = [], []
    for op, band, drev in zip(ops, plan.bands, dops if dops is not None else [None] * len(ops)):
        rdtype = band.cdtype.to_real()
        kb = torch.as_tensor(plan.k_np, dtype=rdtype, device=device)
        om_c = torch.complex(torch.as_tensor(band.om, dtype=rdtype, device=device),
                             torch.full((len(band.om),), alpha_damp, dtype=rdtype, device=device))
        u2, ush, dresp = _response(op.rev, op.src, kb, om_c, a, drev)
        parts.append((u2.to(cwork), ush.to(cwork)))
        if dresp is not None:
            dparts.append(tuple(v.to(cwork) for v in dresp))
    return tuple(torch.cat(p, 1) for p in zip(*(parts + dparts)))


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


class LayeredStages(NamedTuple):
    """The closures of :func:`make_layered_stages`."""
    stage_a: Callable
    stage_b: Callable
    jacobian: Callable


def make_layered_stages(model: LayeredModel | None = None, nt: int = 61,
                        dt: float = 1.0, stf=("clp_step", 0.05, 0.2),
                        alpha_damp: float = 0.023, pad: int = 2,
                        t0: float = 0.0, nk: int = 1024, kmax: float = 2.5,
                        free_surface: bool = True,
                        hp_below: float | None = None):
    """The two halves of the synthesis, for depth-amortized use, and the
    Jacobian built on them:

      * ``stage_a(z, tangent=False)`` -> ops: the moment-independent surface
        operators of K source depths z (K,) (the stack recursion, the
        expensive stage); with ``tangent=True`` it returns (ops, dops), dops
        the z-derivative of their depth-smooth part, in closed form.
      * ``stage_b(ops, x, y, z, a, stations, dops=None)`` -> seismograms:
        moment coefficients ``a`` (:func:`_moment_coeffs`, () or (K,) each)
        applied, the Bessel assembly and the FFT synthesis. Sources x, y, z
        are (K,), one per operator, giving (K, nr, 3, nt), or (K, n), n
        sources sharing each operator, giving (K, n, nr, 3, nt). ``z`` picks
        nothing (the operator holds its layer); given ``dops``, each source's
        z gets its gradient as <its spectra's cotangent, their z-derivative>,
        with the linearization after the Bessel assembly, where it is per
        source and cheap.
      * ``jacobian(x, y, z, mxyz, stations, loc=True, mt=True)`` -> (u
        (nr, 3, nt), jac (n, nr, 3, nt)): the seismograms of one source (x,
        y, z scalars, ``mxyz`` (3, 3)) and their Jacobian, column by column
        from the structure of the two stages, with no finite differences
        and no autograd through the stack algebra. The columns are d/dx,
        d/dy, d/dz (z the depth, positive down) when ``loc``, then, when
        ``mt``, d/dm6[k] for the six upper-triangular entries (Mxx, Mxy,
        Mxz, Myy, Myz, Mzz), each off-diagonal entry moving both of its
        places (:func:`mxyz_from_upper`). Stage A runs once per call, with
        its closed-form depth tangent when ``loc``, and the depth column is
        the synthesis of the spectra that tangent gives. x and y reach the
        seismograms only through each station's range and azimuth in the
        Bessel assembly: forward-mode derivatives of the assembly alone,
        both directions in one pass over two copies of the stations. The
        seismograms are linear in M: the six moment columns are stage B at
        the six unit tensors on the same operators.

    The stack algebra runs in complex128 (complex64 above ``hp_below``
    rad/s); stage B runs in the stations' dtype. ``model`` defaults to
    :func:`fukuoka_model` on the device of the sources. Returns
    ``LayeredStages(stage_a, stage_b, jacobian)``.
    """
    plan = _synth_plan(nt, dt, pad, stf, nk, kmax, math.inf if hp_below is None else hp_below)

    def stage_a(z, tangent: bool = False):
        mdl = fukuoka_model(device=z.device) if model is None else model
        out = [_surface_operator(mdl, torch.atleast_1d(z), band, plan.k_np, alpha_damp,
                                 free_surface, tangent) for band in plan.bands]
        ops = tuple(o for o, _ in out)
        return (ops, tuple(d for _, d in out)) if tangent else ops

    def stage_b(ops, x, y, z, a, stns: StationSet, dops=None):
        like = stns.x
        dtype = like.dtype
        x, y, z = _as_sources(x, y, z, like)
        grouped = x.dim() == 2
        if not grouped:
            x, y, z = x[:, None], y[:, None], z[:, None]
        g, n = x.shape
        nr = like.shape[0]
        a = tuple(torch.as_tensor(ai).reshape(-1, 1, 1) for ai in a)
        u2, ush = _band_responses(ops, dops, a, plan, alpha_damp, dtype)
        r, phi = _offsets(stns, x[..., None], y[..., None])
        spec = _assemble(u2, ush, r.reshape(g, n * nr), phi.reshape(g, n * nr),
                         ops[0].src.rho.to(dtype), _k(plan, like), plan.dk).reshape(g, n, nr, 3, -1)
        if dops is not None:
            nf = spec.shape[-1] // 2
            spec = _DepthLink.apply(spec[..., :nf], z, spec[..., nf:].detach())
        u = _finish_synthesis(spec, plan, nt, dt, stf, alpha_damp, t0)
        return u if grouped else u[:, 0]

    def jacobian(x, y, z, mxyz, stns: StationSet, loc: bool = True, mt: bool = True):
        like = stns.x
        dtype, nr = like.dtype, like.shape[0]
        x, y, z = _as_sources(x, y, z, like)
        ops, dops = stage_a(z.detach(), tangent=True) if loc else (stage_a(z.detach()), None)
        rho, k = ops[0].src.rho.to(dtype), _k(plan, like)
        mxyz = torch.as_tensor(mxyz, dtype=dtype, device=like.device)
        a = tuple(c.reshape(1, 1, 1) for c in _moment_coeffs(mxyz))
        with torch.no_grad():
            if loc:
                u2, ush = _band_responses(ops, dops, a, plan, alpha_damp, dtype)
                nf = u2.shape[1] // 2
                with fwAD.dual_level():
                    basis = torch.eye(2, dtype=dtype, device=like.device)
                    xd = fwAD.make_dual(x.expand(2, 1).clone(), basis[:, :1])
                    yd = fwAD.make_dual(y.expand(2, 1).clone(), basis[:, 1:])
                    r, phi = _offsets(stns, xd, yd)                  # (2, nr)
                    spec = fwAD.unpack_dual(_assemble(u2, ush, r.reshape(1, 2 * nr),
                                                      phi.reshape(1, 2 * nr), rho, k, plan.dk))
                val, tan = spec.primal[0], spec.tangent[0]         # (2 nr, 3, 2 nf)
                specs = [val[:nr, ..., :nf], tan[:nr, ..., :nf], tan[nr:, ..., :nf],
                         val[:nr, ..., nf:]]
            else:
                u2, ush = _band_responses(ops, None, a, plan, alpha_damp, dtype)
                r, phi = _offsets(stns, x[:, None], y[:, None])      # (1, nr)
                specs = [_assemble(u2, ush, r, phi, rho, k, plan.dk)[0]]
            if mt:
                units = _moment_coeffs(mxyz_from_upper(torch.eye(6, dtype=dtype,
                                                                 device=like.device)))
                u2, ush = _band_responses(tuple(_expand_operator(op, 6) for op in ops), None,
                                          tuple(c.reshape(6, 1, 1) for c in units), plan,
                                          alpha_damp, dtype)
                r, phi = _offsets(stns, x[:, None], y[:, None])
                specs += list(_assemble(u2, ush, r.expand(6, nr), phi.expand(6, nr),
                                        rho.expand(6), k, plan.dk))
            u = _finish_synthesis(torch.stack(specs), plan, nt, dt, stf, alpha_damp, t0)
        return u[0], u[1:]

    return LayeredStages(stage_a, stage_b, jacobian)


def _expand_operator(op: _SurfaceOperator, g: int) -> _SurfaceOperator:
    """A one-depth surface operator as a view over g sources."""
    grow = lambda nt_: type(nt_)(*(v.expand(g, *v.shape[1:]) for v in nt_))
    return _SurfaceOperator(grow(op.rev), grow(op.src))


def layered_seismograms(x, y, z, mxyz, stations: StationSet,
                        model: LayeredModel | None = None, nt: int = 61,
                        dt: float = 1.0, stf=("clp_step", 0.05, 0.2),
                        alpha_damp: float = 0.023, pad: int = 2,
                        t0: float = 0.0, nk: int = 1024, kmax: float = 2.5,
                        free_surface: bool = True,
                        hp_below: float | None = None):
    """Layered-medium three-component seismograms, (t (nt,), u).

    The pyprop8 replacement: differentiable by autograd in the source
    position (x, y, z) and moment tensor ``mxyz``, components (ux=North,
    uy=East, uz=Up), z the source depth in km (positive down). One source
    (x, y, z scalars, ``mxyz`` (3, 3)) gives u (nr, 3, nt); a batch (x, y, z
    (k,), ``mxyz`` (3, 3) shared or (k, 3, 3)) gives (k, nr, 3, nt).
    ``free_surface=False`` buries the receivers in an unbounded medium above
    (the whole-space parity mode). The stack algebra runs in complex128 for
    float32 and float64 stations alike (complex64 above ``hp_below`` rad/s);
    the Bessel assembly and the FFT in the stations' dtype.
    """
    stage_a, stage_b, _ = make_layered_stages(
        model=model, nt=nt, dt=dt, stf=stf, alpha_damp=alpha_damp, pad=pad, t0=t0,
        nk=nk, kmax=kmax, free_surface=free_surface, hp_below=hp_below)
    like = stations.x
    single = torch.as_tensor(x).dim() == 0
    x, y, z = _as_sources(x, y, z, like)
    u = stage_b(stage_a(z), x, y, z, _moment_coeffs(torch.as_tensor(mxyz, dtype=like.dtype,
                                                                    device=like.device)),
                stations)
    tt = t0 + dt * torch.arange(nt, dtype=like.dtype, device=like.device)
    return tt, (u[0] if single else u)


def make_layered_forward(stations: StationSet | None = None,
                         model: LayeredModel | None = None, nt: int = 61,
                         dt: float = 1.0, structured_vjp: bool = True, **kw):
    """The layered physics in the pluggable-forward signature of the
    inversion layer, ``forward(x, y, z, mxyz) -> (k, nr, 3, nt)`` for
    sources (k,) (``(nr, 3, nt)`` for scalars); ``stations=None`` gives the
    station-dynamic ``forward(x, y, z, mxyz, stations)``. Extra keywords go
    to :func:`layered_seismograms` (nk, kmax, stf, alpha_damp, t0, ...).

    ``structured_vjp=True`` (default): stage A depends on the source through
    its depth only, x and y enter only the Bessel assembly and M only the
    linear source terms. So x, y and M get their gradients by reverse mode
    through stage B, and z through the depth derivative of stage A, in
    closed form (:func:`_depth_tangent`), carried to the spectra and
    contracted with their cotangent: no reverse sweep of the stack algebra. The values equal those of
    ``structured_vjp=False``, plain autograd through everything, bit for
    bit; the gradients agree to rounding.
    """
    stage_a, stage_b, _ = make_layered_stages(model=model, nt=nt, dt=dt, **kw)

    def forward(x, y, z, mxyz, stns):
        like = stns.x
        single = torch.as_tensor(x).dim() == 0
        x, y, z = _as_sources(x, y, z, like)
        if not structured_vjp:
            ops, dops = stage_a(z), None
        elif torch.is_grad_enabled() and z.requires_grad:
            ops, dops = stage_a(z.detach(), tangent=True)
        else:
            ops, dops = stage_a(z.detach()), None
        u = stage_b(ops, x, y, z, _moment_coeffs(torch.as_tensor(mxyz, dtype=like.dtype,
                                                                 device=like.device)),
                    stns, dops)
        return u[0] if single else u

    if stations is None:
        return forward
    return lambda x, y, z, mxyz: forward(x, y, z, mxyz, stations)
