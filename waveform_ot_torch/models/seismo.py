"""Far-field point-source seismograms (counterpart of waveform_ot_tpu.models.seismo).

Batched over a leading axis of sources where the JAX package used
``jax.vmap``. Differentiable in the source position and moment tensor
through autograd; no custom rule is needed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# symmetric 3x3 from (Mxx, Mxy, Mxz, Myy, Myz, Mzz)
_SYM_INDEX = ((0, 1, 2), (1, 3, 4), (2, 4, 5))
_TRIU = ((0, 0, 0, 1, 1, 2), (0, 1, 2, 1, 2, 2))


def mxyz_from_upper(vals: torch.Tensor) -> torch.Tensor:
    """Symmetric (..., 3, 3) from the 6 upper-triangle entries (..., 6) in
    row-major order (Mxx, Mxy, Mxz, Myy, Myz, Mzz)."""
    return vals[..., torch.tensor(_SYM_INDEX, device=vals.device)]


def upper_from_mxyz(m: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`mxyz_from_upper`: (..., 3, 3) -> (..., 6)."""
    return m[..., _TRIU[0], _TRIU[1]]


def moment_tensor_from_sdr(strike, dip, rake, m0=1.0, degrees=True,
                           dtype=torch.float64, device="cuda") -> torch.Tensor:
    """Double-couple moment tensor (x=North, y=East, z=Up) on ``device`` from
    strike/dip/rake (Aki & Richards eqn 4.88-4.89, rotated to cartesian)."""
    arr = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    strike, dip, rake = arr(strike), arr(dip), arr(rake)
    if degrees:
        strike, dip, rake = (torch.deg2rad(v) for v in (strike, dip, rake))
    ss, cs = torch.sin(strike), torch.cos(strike)
    s2s, c2s = torch.sin(2 * strike), torch.cos(2 * strike)
    sd, cd = torch.sin(dip), torch.cos(dip)
    s2d, c2d = torch.sin(2 * dip), torch.cos(2 * dip)
    sr, cr = torch.sin(rake), torch.cos(rake)
    mxx = -(sd * cr * s2s + s2d * sr * ss * ss)
    mxy = sd * cr * c2s + 0.5 * s2d * sr * s2s
    mxz = -(cd * cr * cs + c2d * sr * ss)
    myy = sd * cr * s2s - s2d * sr * cs * cs
    myz = -(cd * cr * ss - c2d * sr * cs)
    mzz = s2d * sr
    return m0 * torch.stack([torch.stack([mxx, mxy, mxz]),
                             torch.stack([mxy, myy, myz]),
                             torch.stack([mxz, myz, mzz])])


class StationSet(NamedTuple):
    """Receiver coordinates at the surface, (nr,) each."""

    x: torch.Tensor
    y: torch.Tensor


class MediumConfig(NamedTuple):
    """Homogeneous-medium parameters (scalar tensors)."""

    vp: torch.Tensor
    vs: torch.Tensor
    rho: torch.Tensor

    @staticmethod
    def default(dtype=torch.float64, device="cuda") -> "MediumConfig":
        arr = lambda v: torch.tensor(v, dtype=dtype, device=device)
        return MediumConfig(vp=arr(6.0), vs=arr(3.46), rho=arr(2.7))


def _stf_velocity(tau, fc):
    """Derivative-of-Gaussian source pulse."""
    a = (math.pi * fc) ** 2
    return -2.0 * a * tau * torch.exp(-a * tau * tau)


def synthetic_seismograms(x, y, z, mxyz, stations: StationSet, nt: int = 61,
                          dt=1.0, medium: MediumConfig | None = None,
                          fc=0.08, t0=0.0):
    """Three-component far-field seismograms: (t (nt,), u (..., nr, 3, nt)).

    The source is one point (x, y, z scalars, ``mxyz`` (3, 3)) or a batch of
    k (x, y, z of shape (k,), ``mxyz`` (3, 3) shared or (k, 3, 3)), which
    gives u (nr, 3, nt) or (k, nr, 3, nt).

    u_P = gamma (gamma.M.gamma) / (4 pi rho vp^3 r) * s(t - r/vp)
    u_S = (M.gamma - gamma (gamma.M.gamma)) / (4 pi rho vs^3 r) * s(t - r/vs)
    """
    xs = stations.x
    if medium is None:
        medium = MediumConfig.default(xs.dtype, xs.device)
    src = lambda v: torch.as_tensor(v, dtype=xs.dtype, device=xs.device)[..., None]
    t = t0 + dt * torch.arange(nt, dtype=xs.dtype, device=xs.device)
    dx = xs - src(x)                                             # (..., nr)
    dy = stations.y - src(y)
    dz = torch.broadcast_to(src(z), dx.shape)
    r = torch.sqrt(dx * dx + dy * dy + dz * dz)
    gam = torch.stack([dx, dy, dz], dim=-1) / r[..., None]       # (..., nr, 3)
    # gam @ mxyz as an explicit sum: the (nr,3)@(3,3) product stays in full
    # precision whatever the TF32 matmul setting
    mg = (gam[..., :, :, None] * mxyz[..., None, :, :]).sum(dim=-2)  # (..., nr, 3)
    gmg = (mg * gam).sum(dim=-1)                                 # (..., nr)
    four_pi_rho = 4.0 * math.pi * medium.rho
    amp_p = gmg / (four_pi_rho * medium.vp ** 3 * r)
    vec_s = mg - gam * gmg[..., None]
    amp_s = 1.0 / (four_pi_rho * medium.vs ** 3 * r)
    tau_p = t - (r / medium.vp)[..., None]                       # (..., nr, nt)
    tau_s = t - (r / medium.vs)[..., None]
    wp = _stf_velocity(tau_p, fc)
    ws = _stf_velocity(tau_s, fc)
    u = (gam[..., None] * (amp_p[..., None] * wp)[..., None, :]
         + vec_s[..., None] * (amp_s[..., None] * ws)[..., None, :])
    return t, u


def moment_tensor_ls(xyz, stations: StationSet, seis_obs, nt: int = 61,
                     dt=1.0, medium: MediumConfig | None = None, fc=0.08,
                     forward=None):
    """Linear least-squares moment tensor (6 upper-triangle entries) at the
    fixed location ``xyz`` (3,).

    Seismograms are linear in M, so M solves (G^T G) m = G^T d, where G's
    six rows are the forwards of the six unit upper-triangle tensors, run
    as one batch of 6 sources. ``forward`` maps that (6, 6) batch of
    upper-triangle entries to seismograms (6, nr, 3, nt); the default is
    :func:`synthetic_seismograms` at ``xyz``. The products are explicit
    sums (out of TF32) and the solve is in the dtype of ``seis_obs``;
    differentiable w.r.t. ``xyz`` through autograd.
    """
    if forward is None:
        def forward(m6):
            k = m6.shape[0]
            return synthetic_seismograms(
                xyz[0].expand(k), xyz[1].expand(k), xyz[2].expand(k),
                mxyz_from_upper(m6), stations, nt=nt, dt=dt, medium=medium,
                fc=fc)[1]
    basis = torch.eye(6, dtype=seis_obs.dtype, device=seis_obs.device)
    g = forward(basis).reshape(6, -1)                            # (6, nr*3*nt)
    gtd = (g * seis_obs.reshape(1, -1)).sum(dim=-1)
    gtg = (g[:, None, :] * g[None, :, :]).sum(dim=-1)
    return torch.linalg.solve(gtg, gtd)
