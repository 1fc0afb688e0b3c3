"""Discrete 1-D densities (counterpart of waveform_ot_tpu.ops.otpdf).

Densities carry an explicit leading batch dimension where the JAX package
used ``jax.vmap``: every field has shape (..., n) or (...,) for ``amp``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Density1D(NamedTuple):
    """A batch of 1-D discrete densities with cached CDFs.

    amp: (...,)   raw total mass (sum of unnormalized amplitudes)
    pdf: (..., n) normalized amplitudes (each row sums to 1)
    x:   (..., n) support locations
    cdf: (..., n) cumulative distribution, renormalized so cdf[..., -1] == 1
    """

    amp: torch.Tensor
    pdf: torch.Tensor
    x: torch.Tensor
    cdf: torch.Tensor


def make_density_1d(f: torch.Tensor, x: torch.Tensor) -> Density1D:
    """Densities from unnormalized amplitudes ``f`` (..., n) and locations.

    pdf = f / sum(f); cdf = cumsum(pdf) renormalized by its last entry, as
    waveform_ot_tpu.ops.otpdf.make_density_1d (per row of the batch).
    """
    amp = f.sum(dim=-1)
    pdf = f / amp[..., None]
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = cdf / cdf[..., -1:]
    return Density1D(amp=amp, pdf=pdf, x=x, cdf=cdf)


def marginals_raw(pdf2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Axis sums of (..., nu, ntg) fields: (time marginal (..., ntg),
    amplitude marginal (..., nu))."""
    return pdf2d.sum(dim=-2), pdf2d.sum(dim=-1)
