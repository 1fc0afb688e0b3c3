# Frozen copy of waveform_ot_torch/models/seismo.py at commit 8a4dc96ec9d6dabe20c4e556e247ff8cb21fb737,
# the port's far-field forward, kept for the benchmark's float64 reference so
# that a later change to the port does not change what it is held to. Trimmed
# to what the reference reaches: the moment-tensor least squares, the
# upper-triangle helpers and MediumConfig.default are left out (``medium`` is
# given); what stays is unchanged.
"""Far-field point-source seismograms (counterpart of waveform_ot_tpu.models.seismo).

Batched over a leading axis of sources where the JAX package used
``jax.vmap``. Differentiable in the source position and moment tensor
through autograd; no custom rule is needed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

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


def _stf_velocity(tau, fc):
    """Derivative-of-Gaussian source pulse."""
    a = (math.pi * fc) ** 2
    return -2.0 * a * tau * torch.exp(-a * tau * tau)


def synthetic_seismograms(x, y, z, mxyz, stations: StationSet, nt: int = 61,
                          dt=1.0, *, medium: MediumConfig,
                          fc=0.08, t0=0.0):
    """Three-component far-field seismograms: (t (nt,), u (..., nr, 3, nt)).

    The source is one point (x, y, z scalars, ``mxyz`` (3, 3)) or a batch of
    k (x, y, z of shape (k,), ``mxyz`` (3, 3) shared or (k, 3, 3)), which
    gives u (nr, 3, nt) or (k, nr, 3, nt).

    u_P = gamma (gamma.M.gamma) / (4 pi rho vp^3 r) * s(t - r/vp)
    u_S = (M.gamma - gamma (gamma.M.gamma)) / (4 pi rho vs^3 r) * s(t - r/vs)
    """
    xs = stations.x
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

