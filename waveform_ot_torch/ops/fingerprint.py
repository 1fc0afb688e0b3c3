"""Waveform fingerprints: nearest-distance fields over time-amplitude windows.

Counterpart of waveform_ot_tpu.ops.fingerprint, batched over a leading
trace dimension B where the JAX package used ``jax.vmap``:

  verts (B, nt, 2), tgrid (B, ntg), ugrid (B, nu)  ->  fields (B, nu, ntg)

The distance field has two implementations behind :func:`distance_field`:
the plain PyTorch version :func:`distance_field_torch` (CPU tensors) and
the hand-written CUDA kernel in ``csrc/distance_field.cu``
(:mod:`waveform_ot_torch.ops.cuda_distance`, CUDA tensors). Both compute,
for every grid point p and segment (x0, c), with il = 1/|c|^2 once per
segment (as the TPU kernel's ``_pack_segments`` stages it),

    b = p - x0;  lam = clip(b.c * il, 0, 1);  dsq = |b - lam*c|^2

with the same operations in the same order, keep the first minimum
(np.argmin ties), and return d, the winning segment, its lam and the
offset p - x*. They part only at a zero-length segment, whose lam is NaN:
``torch.clamp`` keeps it and lets it win the argmin, as JAX does, while the
kernel takes lam = 0 (float32) or skips the segment (float64), which gives
the same d. The backward pass is the envelope rule of the JAX module
(see :func:`_distance_vjp`), in plain PyTorch on both devices.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from waveform_ot_torch.ops import cuda_distance, errors

# point-segment pairs per chunk of the plain distance field: bounds its
# (B, chunk, nseg) temporaries to a few tens of MB each
_PAIRS_PER_CHUNK = 1 << 22


# ---------------------------------------------------------------------------
# window geometry
# ---------------------------------------------------------------------------


class Window(NamedTuple):
    """Time-amplitude window parameters: tensors of shape () or (B,)."""

    t0: torch.Tensor
    t1: torch.Tensor
    u0: torch.Tensor
    u1: torch.Tensor
    tantheta: torch.Tensor


def make_window(t0, t1, u0, u1, theta: float | None = None,
                tantheta: float | None = None, dtype=torch.float64,
                device="cuda") -> Window:
    """Build a Window on ``device`` (the card unless asked otherwise);
    ``tantheta`` takes precedence over ``theta`` (degrees). Default is 45
    degrees given as tantheta = 1."""
    arr = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    if tantheta is None:
        tantheta = 1.0 if theta is None else torch.tan(torch.deg2rad(arr(theta)))
    return Window(arr(t0), arr(t1), arr(u0), arr(u1), arr(tantheta))


def window_from_waveform(t, w, pad: float = 0.3) -> Window:
    """Auto window of waveforms w (..., nt) on times t (..., nt): the time
    span, and the amplitude range padded by ``pad`` times itself on both
    sides (pad 0.3 as loc_cmt_util.buildFingerprintwindows, 0.2 as
    ricker_util.BuildOTobjfromWaveform). Fields are (...,), on w's device."""
    lo, hi = w.amin(dim=-1), w.amax(dim=-1)
    du = hi - lo
    return make_window(t.amin(dim=-1), t.amax(dim=-1), lo - pad * du, hi + pad * du,
                       dtype=w.dtype, device=w.device)


@dataclasses.dataclass(frozen=True)
class FingerprintSpec:
    """Static grid dimensions along the amplitude (nu) and time (ntg) axes."""

    nu: int
    ntg: int


def _col(x):
    """Append a unit axis to a tensor so it broadcasts against (..., n)."""
    return x.unsqueeze(-1) if isinstance(x, torch.Tensor) else x


def linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """(..., num) evenly spaced points with jnp.linspace's arithmetic.

    start*(1 - i/div) + stop*(i/div), with the last entry exactly ``stop``.
    torch.linspace rounds differently, and grid coordinates that differ by
    an ulp from the JAX package's can move nearest-segment winners at ties.
    """
    start = _col(start)
    stop = _col(stop)
    if num == 1:
        return start
    div = num - 1
    step = torch.arange(div, dtype=start.dtype, device=start.device) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.expand(out.shape[:-1] + (1,))], dim=-1)


def normalize_vertices(t, w, win: Window) -> torch.Tensor:
    """Waveform vertices in window coordinates, (B, nt, 2).

    pn = ((t - t0) / (tantheta*(t1 - t0)), (w - u0) / (u1 - u0)); ``t`` is
    (nt,) or (B, nt), ``w`` is (B, nt).
    """
    delt = win.tantheta * (win.t1 - win.t0)
    tn = (t - _col(win.t0)) / _col(delt)
    wn = (w - _col(win.u0)) / _col(win.u1 - win.u0)
    return torch.stack(torch.broadcast_tensors(tn, wn), dim=-1)


def grid_axes(t, win: Window, spec: FingerprintSpec, fpbox=None):
    """Normalized grid axes (tgrid (..., ntg), ugrid (..., nu)).

    By default the time axis spans the waveform's normalized time range and
    the amplitude axis spans (0, 1). ``fpbox`` = (fp_t0, fp_t1, fp_u0,
    fp_u1) in physical coordinates gives the box instead, normalized by the
    window (the reference's fpgrid).
    """
    delt = win.tantheta * (win.t1 - win.t0)
    if fpbox is None:
        tlo = (t[..., 0] - win.t0) / delt
        thi = (t[..., -1] - win.t0) / delt
        ulo, uhi = torch.zeros_like(tlo), torch.ones_like(tlo)
    else:
        fp_t0, fp_t1, fp_u0, fp_u1 = fpbox
        tlo = (fp_t0 - win.t0) / delt
        thi = (fp_t1 - win.t0) / delt
        ulo = (fp_u0 - win.u0) / (win.u1 - win.u0)
        uhi = (fp_u1 - win.u0) / (win.u1 - win.u0)
    return linspace(tlo, thi, spec.ntg), linspace(ulo, uhi, spec.nu)


# ---------------------------------------------------------------------------
# distance field
# ---------------------------------------------------------------------------


class DistanceField(NamedTuple):
    """Nearest-distance field and its argmin data, each batched over B.

    d:      (B, nu, ntg) nearest distance from each grid point to the polyline
    iclose: (B, nu, ntg) int32 index of the nearest segment (first-min ties)
    lam:    (B, nu, ntg) clipped projection parameter on that segment
    dvec:   (B, nu, ntg, 2) offset p - x* from the nearest polyline point
    """

    d: torch.Tensor
    iclose: torch.Tensor
    lam: torch.Tensor
    dvec: torch.Tensor


@torch.no_grad()
def distance_field_torch(verts, tgrid, ugrid) -> DistanceField:
    """Plain PyTorch distance field, the twin of ``_distance_field_jnp``.

    Materializes (B, chunk, nseg) over chunks of grid points, never
    segments, so each point's argmin sees every segment at once and keeps
    the first minimum exactly as np.argmin does.
    """
    bsz, nt, _ = verts.shape
    nu, ntg = ugrid.shape[-1], tgrid.shape[-1]
    n = nu * ntg
    x0x, x0y = verts[:, :-1, 0], verts[:, :-1, 1]            # (B, nseg)
    cx = verts[:, 1:, 0] - x0x
    cy = verts[:, 1:, 1] - x0y
    il = torch.reciprocal(cx * cx + cy * cy)
    x0x, x0y, cx, cy, il = (v[:, None, :] for v in (x0x, x0y, cx, cy, il))
    pt = tgrid[:, None, :].expand(bsz, nu, ntg).reshape(bsz, n)
    pu = ugrid[:, :, None].expand(bsz, nu, ntg).reshape(bsz, n)

    d = verts.new_empty(bsz, n)
    iclose = torch.empty(bsz, n, dtype=torch.int32, device=verts.device)
    lam_out = verts.new_empty(bsz, n)
    dvec = verts.new_empty(bsz, n, 2)
    chunk = max(1, _PAIRS_PER_CHUNK // (bsz * (nt - 1)))
    for k0 in range(0, n, chunk):
        k1 = min(n, k0 + chunk)
        bx = pt[:, k0:k1, None] - x0x                          # (B, c, nseg)
        by = pu[:, k0:k1, None] - x0y
        bc = bx * cx + by * cy
        lam = torch.clamp(bc * il, 0.0, 1.0)
        dx = bx - lam * cx
        dy = by - lam * cy
        dsq = dx * dx + dy * dy
        idx = torch.argmin(dsq, dim=-1, keepdim=True)          # first minimum
        d[:, k0:k1] = torch.sqrt(torch.gather(dsq, -1, idx)[..., 0])
        iclose[:, k0:k1] = idx[..., 0].to(torch.int32)
        lam_out[:, k0:k1] = torch.gather(lam, -1, idx)[..., 0]
        dvec[:, k0:k1, 0] = torch.gather(dx, -1, idx)[..., 0]
        dvec[:, k0:k1, 1] = torch.gather(dy, -1, idx)[..., 0]
    shape = (bsz, nu, ntg)
    return DistanceField(d.reshape(shape), iclose.reshape(shape),
                         lam_out.reshape(shape), dvec.reshape(shape + (2,)))


def distance_field(verts, tgrid, ugrid) -> DistanceField:
    """Nearest distance from every grid point to each trace's polyline.

    verts (B, nt, 2), tgrid (B, ntg), ugrid (B, nu). CPU tensors take the
    plain version; CUDA tensors launch the CUDA kernel, which raises if it
    cannot be built or launched. There is no fallback between the two.
    """
    if verts.device.type == "cpu":
        return distance_field_torch(verts, tgrid, ugrid)
    if verts.device.type == "cuda":
        return DistanceField(*cuda_distance.distance_field_cuda(verts, tgrid, ugrid))
    raise errors.FingerprintMethodError(f"no distance field for device {verts.device}")


def _distance_vjp(nt: int, fld: DistanceField, gbar):
    """Envelope-form backward pass (waveform_ot_tpu.ops.fingerprint._distance_vjp).

    dd/d(vertex i) = (1 - lam) (x* - p)/d, dd/d(vertex i+1) = lam (x* - p)/d,
    dd/d(grid point) = (p - x*)/d; the winning segment and the clip of lam
    are locally constant. The segment scatter is ``scatter_add_`` into
    (B, nseg, 4) where the TPU used a one-hot matmul.
    """
    d, iclose, lam, dvec = fld
    bsz = d.shape[0]
    pos = d > 0
    safe_d = torch.where(pos, d, torch.ones_like(d))
    gdir = -dvec / safe_d[..., None]
    gdir = torch.where(pos[..., None], gdir, torch.zeros_like(gdir))
    gv = gbar[..., None] * gdir                                # (B, nu, ntg, 2)
    w01 = torch.cat([(1.0 - lam)[..., None] * gv, lam[..., None] * gv],
                    dim=-1).reshape(bsz, -1, 4)
    idx = iclose.reshape(bsz, -1, 1).long().expand(-1, -1, 4)
    gseg = w01.new_zeros(bsz, nt - 1, 4).scatter_add_(1, idx, w01)
    gverts = w01.new_zeros(bsz, nt, 2)
    gverts[:, :-1] += gseg[..., 0:2]
    gverts[:, 1:] += gseg[..., 2:4]
    gp = -gv                                                   # dd/dp
    return gverts, gp[..., 0].sum(dim=1), gp[..., 1].sum(dim=2)


class DistanceFieldDiff(torch.autograd.Function):
    """Differentiable distance field (d only) with the envelope backward."""

    @staticmethod
    def forward(ctx, verts, tgrid, ugrid):
        fld = distance_field(verts.contiguous(), tgrid.contiguous(),
                             ugrid.contiguous())
        ctx.nt = verts.shape[1]
        ctx.save_for_backward(*fld)
        return fld.d

    @staticmethod
    def backward(ctx, gbar):
        return _distance_vjp(ctx.nt, DistanceField(*ctx.saved_tensors), gbar)


def distance_field_diff(verts, tgrid, ugrid) -> torch.Tensor:
    """d (B, nu, ntg), differentiable w.r.t. verts and both grid axes."""
    return DistanceFieldDiff.apply(verts, tgrid, ugrid)


# ---------------------------------------------------------------------------
# density
# ---------------------------------------------------------------------------


def density_from_distance(d, lambdav, q: int | None = None) -> torch.Tensor:
    """q=None or 1: exp(-|d|/lambda); q=2: exp(-d**2/lambda)."""
    if q is None or q == 1:
        return torch.exp(-torch.abs(d) / lambdav)
    if q == 2:
        return torch.exp(-(d * d) / lambdav)
    raise errors.FingerprintMethodError(f"q={q}")


def fingerprint_density(t, w, win: Window, spec: FingerprintSpec,
                        lambdav: float = 0.04, q: int | None = None, fpbox=None):
    """Waveforms (B, nt) -> fingerprint densities (B, nu, ntg).

    Returns (pdf2d, (tgrid (B, ntg), ugrid (B, nu))). Gradients flow to
    ``w``, ``t`` and every Window field through the envelope backward.
    ``fpbox`` is passed to :func:`grid_axes`.
    """
    verts = normalize_vertices(t, w, win)
    tgrid, ugrid = grid_axes(t, win, spec, fpbox=fpbox)
    bsz = verts.shape[0]
    tgrid = tgrid.expand(bsz, spec.ntg)
    ugrid = ugrid.expand(bsz, spec.nu)
    d = distance_field_diff(verts, tgrid, ugrid)
    return density_from_distance(d, lambdav, q=q), (tgrid, ugrid)


# ---------------------------------------------------------------------------
# point queries and the vertex-NN field (reference utilities)
# ---------------------------------------------------------------------------


def _segment_terms(c, lsq, b):
    """(dsq, lam, ds) of offsets b = p - x0 from segments (x0, c) with
    |c|^2 = lsq: lam = clip(b.c / lsq, 0, 1), ds = b - lam c, as the JAX
    module's point queries write it (a division, where the distance field
    multiplies by 1/|c|^2)."""
    lam = torch.clamp((b[..., 0] * c[..., 0] + b[..., 1] * c[..., 1]) / lsq, 0.0, 1.0)
    ds = b - c * lam[..., None]
    return ds[..., 0] * ds[..., 0] + ds[..., 1] * ds[..., 1], lam, ds


def nearest_segment(verts, points):
    """(dsq, iclose, lam) of the nearest polyline segment to each point.

    verts (..., nt, 2), points (..., k, 2) -> (..., k) each; iclose is the
    first minimum (np.argmin ties). Chunked over points, so the (chunk,
    nseg) temporaries stay within _PAIRS_PER_CHUNK pairs.
    """
    x0 = verts[..., :-1, :]
    c = verts[..., 1:, :] - x0
    lsq = c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]
    x0, c, lsq = x0[..., None, :, :], c[..., None, :, :], lsq[..., None, :]
    nseg = c.shape[-2]
    k = points.shape[-2]
    nb = max(1, points[..., 0, 0].numel())
    chunk = max(1, _PAIRS_PER_CHUNK // (nb * nseg))
    dsq, iclose, lam = [], [], []
    for k0 in range(0, k, chunk):
        b = points[..., k0:k0 + chunk, None, :] - x0            # (..., c, nseg, 2)
        dq, lm, _ = _segment_terms(c, lsq, b)
        idx = torch.argmin(dq, dim=-1, keepdim=True)           # first minimum
        dsq.append(torch.gather(dq, -1, idx)[..., 0])
        lam.append(torch.gather(lm, -1, idx)[..., 0])
        iclose.append(idx[..., 0])
    return torch.cat(dsq, -1), torch.cat(iclose, -1), torch.cat(lam, -1)


def nearest_vertex(verts, points) -> torch.Tensor:
    """Index (..., k) of the nearest vertex of verts (..., nv, 2) to each of
    points (..., k, 2), the first minimum of the squared distance; chunked
    over points within _PAIRS_PER_CHUNK point-vertex pairs."""
    nb = max(1, points[..., 0, 0].numel())
    chunk = max(1, _PAIRS_PER_CHUNK // (nb * verts.shape[-2]))
    out = []
    for k0 in range(0, points.shape[-2], chunk):
        dv = points[..., k0:k0 + chunk, None, :] - verts[..., None, :, :]   # (..., c, nv, 2)
        out.append(torch.argmin(dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1], dim=-1))
    return torch.cat(out, dim=-1)


def point_distance(verts, points) -> torch.Tensor:
    """Nearest distance (..., k) from points (..., k, 2) to the polyline
    verts (..., nt, 2) (the reference's wavedist/wavedistv)."""
    return torch.sqrt(nearest_segment(verts, points)[0])


def resolve_adjacent(verts, points, segp, segm):
    """The nearer of two candidate segments of the polyline verts (..., nt, 2)
    for each of points (..., k, 2): segp and segm (..., k) index segments
    (the two adjacent to a nearest vertex). Returns (dsq, iclose, lam, ds),
    each (..., k) (ds (..., k, 2)); ties keep segm, the lower segment, as
    the reference does."""
    x0 = verts[..., :-1, :]
    c = verts[..., 1:, :] - x0
    lsq = c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]

    def terms(seg):
        rows = seg[..., None].expand(seg.shape + (2,))
        return _segment_terms(torch.gather(c, -2, rows), torch.gather(lsq, -1, seg),
                              points - torch.gather(x0, -2, rows))

    dp, lamp, dsp = terms(segp)
    dm, lamm, dsm = terms(segm)
    take_p = dp < dm
    return (torch.where(take_p, dp, dm), torch.where(take_p, segp, segm),
            torch.where(take_p, lamp, lamm), torch.where(take_p[..., None], dsp, dsm))


def distance_field_nn(verts, tgrid, ugrid) -> DistanceField:
    """Vertex-NN distance field (the reference's wdistNN): the nearest
    polyline *vertex* of each grid point (first minimum), then the nearer
    of its two adjacent segments (ties keep the lower segment).

    verts (B, nt, 2), tgrid (B, ntg), ugrid (B, nu) -> fields (B, nu, ntg).
    It differs from :func:`distance_field` only where the true nearest
    segment is not adjacent to the nearest vertex. The vertex search is
    chunked over grid points (within _PAIRS_PER_CHUNK point-vertex pairs).
    """
    bsz, nt, _ = verts.shape
    nu, ntg = ugrid.shape[-1], tgrid.shape[-1]
    p = torch.stack([tgrid[:, None, :].expand(bsz, nu, ntg),
                     ugrid[:, :, None].expand(bsz, nu, ntg)], dim=-1).reshape(bsz, nu * ntg, 2)
    ivert = nearest_vertex(verts, p)
    dsq, iclose, lam, ds = resolve_adjacent(verts, p, torch.clamp(ivert, 0, nt - 2),
                                            torch.clamp(ivert - 1, 0, nt - 2))
    shape = (bsz, nu, ntg)
    return DistanceField(torch.sqrt(dsq).reshape(shape), iclose.to(torch.int32).reshape(shape),
                         lam.reshape(shape), ds.reshape(shape + (2,)))
