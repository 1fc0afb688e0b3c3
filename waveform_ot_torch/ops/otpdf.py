"""Discrete 1-D and 2-D densities (counterpart of waveform_ot_tpu.ops.otpdf).

Densities may carry leading batch dimensions where the JAX package used
``jax.vmap``: 1-D fields have shape (..., n) and ``amp`` (...,); 2-D fields
(..., nx, ny) with locations (..., nx, ny, 2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from waveform_ot_torch.ops import errors


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

    @property
    def n(self) -> int:
        """The support size, pdf's last dimension."""
        return self.pdf.shape[-1]


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


class Density2D(NamedTuple):
    """A 2-D discrete density over a structured grid.

    amp: (...,)          raw total mass
    pdf: (..., nx, ny)   normalized amplitudes
    x:   (..., nx, ny, 2) grid coordinates; x[..., 0] varies along axis 1
         (the reference's time axis), x[..., 1] along axis 0 (amplitude)
    """

    amp: torch.Tensor
    pdf: torch.Tensor
    x: torch.Tensor

    @property
    def nx(self) -> int:
        return self.pdf.shape[-2]

    @property
    def ny(self) -> int:
        return self.pdf.shape[-1]

    @property
    def n(self) -> int:
        return self.nx * self.ny


def make_density_2d(f: torch.Tensor, x: torch.Tensor) -> Density2D:
    """A 2-D density from unnormalized amplitudes f (..., nx, ny) and
    locations x (..., nx, ny, 2)."""
    amp = f.sum(dim=(-2, -1))
    return Density2D(amp=amp, pdf=f / amp[..., None, None], x=x)


def make_density(f: torch.Tensor, x: torch.Tensor):
    """Dispatch on rank like the reference OTpdf constructor: a rank-2
    ``f`` is one 2-D density, any other rank a (batch of) 1-D densities."""
    if f.dim() == 2:
        return make_density_2d(f, x)
    return make_density_1d(f, x)


def validate_density(f, x) -> None:
    """The reference OTpdf constructor's checks: PDFSignError for a negative
    amplitude, PDFShapeError for amplitudes and locations of other shapes
    (a 2-D ``f`` against the first two axes of ``x``). Takes arrays or
    tensors; reads one value back from the device."""
    f, x = torch.as_tensor(f), torch.as_tensor(x)
    if bool(f.min() < 0.0):
        raise errors.PDFSignError()
    if f.dim() == 2:
        if f.shape != x.shape[:2]:
            raise errors.PDFShapeError(
                f"2-D pdf shape {tuple(f.shape)} != location grid {tuple(x.shape[:2])}")
    elif f.shape != x.shape:
        raise errors.PDFShapeError(
            f"1-D pdf shape {tuple(f.shape)} != location shape {tuple(x.shape)}")


def marginals(density: Density2D) -> tuple[Density1D, Density1D]:
    """(time marginal, amplitude marginal) of 2-D densities, renormalized:
    the first sums over axis -2 and lives on x[..., 0, :, 0], the second
    sums over axis -1 and lives on x[..., :, 0, 1] (reference setMarginals)."""
    f0, f1 = marginals_raw(density.pdf)
    return (make_density_1d(f0, density.x[..., 0, :, 0]),
            make_density_1d(f1, density.x[..., :, 0, 1]))


def marginals_raw(pdf2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Axis sums of (..., nu, ntg) fields: (time marginal (..., ntg),
    amplitude marginal (..., nu))."""
    return pdf2d.sum(dim=-2), pdf2d.sum(dim=-1)
