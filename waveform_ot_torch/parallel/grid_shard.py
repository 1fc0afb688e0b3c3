"""Sequence-parallel fingerprints: the grid's time axis sharded over a mesh
(counterpart of waveform_ot_tpu.parallel.grid_shard).

The reference's "sequence" axis is the fingerprint grid's ntg columns. When
one fingerprint grid is the unit of work (the 800x600 demo grid of
FingerprintLib, or denser), its columns are split into contiguous blocks,
one per shard, and the polyline (O(nt), small) is replicated. No halo is
needed: the nearest-segment search is global over the replicated polyline,
so each shard computes the exact distance field of its column block, in one
kernel launch on the card. Then, on the lead device:

  * the time marginal is gathered (the shards' column sums concatenated),
  * the amplitude marginal is summed (the psum of the shards' row sums),

and ``wasserstein_1d`` runs once on the whole marginals. The backward pass
reverses the collectives through autograd: each shard's block of the time
marginal's cotangent goes back to it, the amplitude marginal's cotangent to
every shard, and the replicated polyline and amplitude axis get the sum of
the shards' cotangents (the psum that JAX's ``_to_varying`` stands for).

Where the signatures part from JAX's: ``impl`` is gone, the device decides.
"""

from __future__ import annotations

from typing import Callable

import torch

from waveform_ot_torch.ops.fingerprint import (
    _col, density_from_distance, distance_field_diff,
)
from waveform_ot_torch.ops.otpdf import Density1D
from waveform_ot_torch.ops.wasser import wasserstein_1d
from waveform_ot_torch.parallel.mesh import Mesh, Sharded, _Copies, _devices, _place


def shard_grid_axis(tgrid, mesh: Mesh, axis_name: str | None = None) -> Sharded:
    """The (ntg,) time axis split into contiguous column blocks over the mesh
    axis ``axis_name`` (the mesh's first by default), each block contiguous on
    its shard's device, made once here and reused by every call. ntg must
    divide by the axis size."""
    axis_name = axis_name or mesh.axis_names[0]
    n = mesh.axis_size(axis_name)
    if tgrid.dim() != 1 or tgrid.shape[0] % n:
        raise ValueError(f"the time axis {tuple(tgrid.shape)} does not split into {n} "
                         f"column blocks")
    return _place(tgrid, mesh, axis_name, 0)


def _grid_blocks(tgrid, mesh: Mesh, axis_name: str) -> Sharded:
    """``tgrid`` as column blocks over ``axis_name``: as given, or split here."""
    if isinstance(tgrid, Sharded):
        if tgrid.axis_name != axis_name or tgrid.axes != 0:
            raise ValueError(f"the time axis must be split over {axis_name!r} "
                             f"(shard_grid_axis)")
        return tgrid
    return shard_grid_axis(tgrid, mesh, axis_name)


def _block_fields(mesh: Mesh, shards, verts, tg: Sharded, ugrid, lambdav, q):
    """Each listed shard's density block (B, nu, ntg/ns) of the polylines
    ``verts`` (B, nt, 2) on the amplitude axis ``ugrid`` (nu,): one
    distance-field evaluation per shard, on its device."""
    copies = _Copies()
    out = []
    for i, v in zip(shards, verts):
        dev = mesh.devices[i]
        v = copies.on(v, dev)
        bsz = v.shape[0]
        blk = tg.parts[i]
        d = distance_field_diff(v, blk.expand(bsz, blk.shape[0]),
                                copies.on(ugrid, dev).expand(bsz, ugrid.shape[-1]))
        out.append(density_from_distance(d, lambdav, q=q))
    return out


def _marginals(blocks, lead: torch.device):
    """(time marginal (B, ntg), amplitude marginal (B, nu)) on the lead
    device of one set of traces' density blocks (B, nu, blk), in column
    order: each shard's column sums gathered, its row sums added."""
    f_t = torch.cat([u.sum(dim=-2).to(lead) for u in blocks], dim=-1)
    f_u = blocks[0].sum(dim=-1).to(lead)
    for u in blocks[1:]:
        f_u = f_u + u.sum(dim=-1).to(lead)
    return f_t, f_u


def _marg_misfit(f_t, f_u, tfull, ugrid, target_t: Density1D, target_u: Density1D,
                 tshift, p: int):
    """(W_p^p of the time marginals (B,), of the amplitude marginals (B,)),
    once on the marginals' device; a target's rows (n,) serve every trace."""
    dev, bsz = f_t.device, f_t.shape[0]
    rows = lambda a: a.to(dev).expand(bsz, a.shape[-1])
    if isinstance(tshift, torch.Tensor):
        tshift = tshift.to(dev)
    wt = wasserstein_1d(f_t, rows(tfull + _col(tshift)), rows(target_t.pdf),
                        rows(target_t.x), p)
    wu = wasserstein_1d(f_u, rows(ugrid), rows(target_u.pdf), rows(target_u.x), p)
    return wt, wu


def grid_sharded_marg_misfit(mesh: Mesh, *, lambdav: float, q: int | None = None,
                             p: int = 2, axis_name: str | None = None) -> Callable:
    """Build the grid-sharded marginal misfit over ``mesh``.

    Returns ``f(verts, tgrid, ugrid, target_t, target_u, tshift) -> (wt, wu)``:

      * ``verts`` the polyline (nt, 2), replicated;
      * ``tgrid`` (ntg,) the uniform time axis in column blocks over the mesh
        axis (:func:`shard_grid_axis`, or a tensor split at each call); ntg
        must divide by its size;
      * ``ugrid`` (nu,) the amplitude axis, replicated;
      * ``target_t`` / ``target_u`` the observed marginals (Density1D, (n,)),
        used on the lead device;
      * ``tshift`` a rigid shift of the time support (scalar), whose gradient
        is the reference's window-origin derivative dwg.

    (wt, wu) are W_p^p of the time and amplitude marginals on the lead
    device, as ``ops.marginal.marg_wasserstein_value`` of the unsharded
    field; differentiable w.r.t. verts, ugrid and tshift.
    """
    an = axis_name or mesh.axis_names[0]
    line = mesh.line(an)

    def f(verts, tgrid, ugrid, target_t, target_u, tshift):
        tg = _grid_blocks(tgrid, mesh, an)
        blocks = _block_fields(mesh, line, [verts[None]] * len(line), tg, ugrid, lambdav, q)
        wt, wu = _marg_misfit(*_marginals(blocks, mesh.lead), tg.gather(), ugrid,
                              target_t, target_u, tshift, p)
        return wt[0], wu[0]

    return f


def grid_sharded_density(mesh: Mesh, *, lambdav: float, q: int | None = None,
                         axis_name: str | None = None) -> Callable:
    """Build ``f(verts, tgrid, ugrid) -> pdf2d``: the (nu, ntg) density of the
    polyline (nt, 2) as a :class:`Sharded` of column blocks, each on its
    shard; no gather (``.gather()`` concatenates the columns on the lead
    device)."""
    an = axis_name or mesh.axis_names[0]

    def f(verts, tgrid, ugrid):
        tg = _grid_blocks(tgrid, mesh, an)
        blocks = _block_fields(mesh, range(mesh.size), [verts[None]] * mesh.size, tg, ugrid,
                               lambdav, q)
        return Sharded(mesh, tuple(u[0] for u in blocks), 1, an)

    return f


def dp_sp_marg_misfit(mesh: Mesh, *, lambdav: float, q: int | None = None,
                      p: int = 2, alpha: float = 0.5, batch_axis: str = "batch",
                      seq_axis: str = "seq") -> Callable:
    """Data-parallel traces x sequence-parallel grid columns on one (nb, ns)
    mesh (:func:`make_mesh_2d`).

    Returns ``f(verts_b, tgrid, ugrid, target_t_b, target_u_b, tshift) ->
    total``: ``verts_b`` (ntr, nt, 2) split into nb trace blocks over
    ``batch_axis`` (a tensor, or a :class:`Sharded` from
    ``shard_leading_axis(verts_b, mesh, batch_axis)``), ``tgrid`` (ntg,) in
    column blocks over ``seq_axis``, ``ugrid`` (nu,) replicated, the targets
    Density1D with a leading (ntr,) axis and ``tshift`` (ntr,). Shard (b, s)
    computes the field of trace block b on column block s, in one kernel
    launch on the card; the marginals of all traces meet on the lead device,
    where W_p^p runs once and ``total = sum_traces alpha*wt + (1-alpha)*wu``.
    Differentiable end to end. ntr must divide by nb and ntg by ns.
    """
    nb = mesh.axis_size(batch_axis)
    # each row's shards in column order (row-major: shard b*ns + s)
    rows = [[i for i in range(mesh.size) if mesh.coord(i, batch_axis) == b]
            for b in range(nb)]
    whole = lambda x: x.gather() if isinstance(x, Sharded) else x

    def f(verts_b, tgrid, ugrid, target_t_b, target_u_b, tshift):
        tg = _grid_blocks(tgrid, mesh, seq_axis)
        if isinstance(verts_b, Sharded):
            part = lambda i: verts_b.parts[i]
        else:
            if verts_b.shape[0] % nb:
                raise ValueError(f"{verts_b.shape[0]} traces do not split into {nb} rows")
            size = verts_b.shape[0] // nb
            part = lambda i: verts_b.narrow(0, mesh.coord(i, batch_axis) * size, size)
        marg = [_marginals(_block_fields(mesh, row, [part(i) for i in row], tg, ugrid,
                                         lambdav, q), mesh.lead) for row in rows]
        wt, wu = _marg_misfit(torch.cat([m[0] for m in marg]), torch.cat([m[1] for m in marg]),
                              tg.gather(), ugrid, whole(target_t_b), whole(target_u_b),
                              whole(tshift), p)
        return (alpha * wt + (1.0 - alpha) * wu).sum()

    return f


def make_mesh_2d(nb: int, ns: int, batch_axis: str = "batch", seq_axis: str = "seq",
                 device=None) -> Mesh:
    """(nb, ns) mesh for :func:`dp_sp_marg_misfit`, row-major: shard (b, s)
    is number b*ns + s. Without ``device``: the first nb*ns CUDA cards, and a
    ValueError if there are fewer; with ``device``, nb*ns shards on it (as
    :func:`waveform_ot_torch.parallel.make_mesh`)."""
    return Mesh(_devices(nb * ns, device), (batch_axis, seq_axis), (nb, ns))
