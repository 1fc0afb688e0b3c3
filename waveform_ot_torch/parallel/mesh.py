"""Meshes of devices and sharding over them (counterpart of
waveform_ot_tpu.parallel.mesh).

JAX's ``shard_map`` is single-controller: one process drives a mesh of local
devices. The port keeps that, with no partitioner and no torch.distributed:

  * a :class:`Mesh` is an ordered tuple of torch devices, one per shard, its
    axis names and its shape (1-D, or (nb, ns) from
    :func:`waveform_ot_torch.parallel.make_mesh_2d`);
  * a tree placed on a mesh is a :class:`Sharded`: one tree per shard, each
    on its shard's device, and the axis along which each leaf is split;
  * the collectives are explicit and end on the lead device (the first
    shard's): psum moves the per-shard partials there and adds them, the
    tiled all_gather concatenates there. Autograd carries the backward
    through ``.to(device)``, which gives the transposes that JAX's
    docstrings promise: the gather's cotangent is sliced back to the shards,
    and a replicated primal gets the sum of its per-shard cotangents.

Shards may repeat one device: a virtual mesh, the counterpart of XLA's
forced host device count. ``make_mesh(8, device="cpu")`` is the tests'
8-shard CPU mesh, ``make_mesh(4, device="cuda:0")`` four shards on one card.
Shards run one after another in the calling thread; kernel launches do not
wait for the card, so shards on distinct cards still overlap.
:func:`waveform_ot_torch.inversion.minimize_multi_start_sharded`, whose
solver reads a flag from the device every iteration, gives each distinct
device a thread of its own instead.

Where the signatures part from JAX's:

  * :func:`make_mesh` takes ``device``, which stands in for JAX's flag
    ``--xla_force_host_platform_device_count``: without it the mesh takes the
    first ``n_devices`` CUDA cards and raises if there are fewer.
  * :func:`sharded_sum` and :func:`sharded_map` take a BATCHED function,
    ``fn(batch, *rest)`` with the shard's slice of the batch (the port's
    functions take an explicit leading batch), where JAX vmaps a per-item
    function: each shard calls it once, so a shard evaluates its slice in one
    kernel launch.
  * Results that stay on the shards are :class:`Sharded`;
    :meth:`Sharded.gather` concatenates them on the lead device. Reduced
    results (psum) are tensors on the lead device.
  * :func:`pjit_batched_misfit` evaluates per shard and adds, where GSPMD
    partitions any function: see its docstring for how it splits the
    problem.
  * These functions take a 1-D mesh (the parallel layer's 2-D mesh serves
    :func:`waveform_ot_torch.parallel.dp_sp_marg_misfit`).

Forwards and objectives held by a shard must compute on its device. A
tensor, a tree of tensors or an ``nn.Module`` (whose tensors are parameters
or buffers, e.g. :class:`waveform_ot_torch.inversion.LocCMTObjective`) is
copied to each distinct device by :func:`replicate`; a plain function is
passed as it is and must follow the device of its inputs (as
``make_layered_forward(model=None)`` does: it builds its model on the
sources' device). A closure over tensors of one card cannot run on another.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import torch
from torch import nn
from torch.utils._pytree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# trees (torch's pytrees: NamedTuples, tuples, lists and dicts are nodes,
# anything else, None included, is a leaf)
# ---------------------------------------------------------------------------


def trace_leaves(tree, inside: bool = False):
    """The tree's structure with True at every per-trace leaf: a NamedTuple
    type names its per-trace fields in a ``trace_fields`` class attribute
    (:class:`waveform_ot_torch.inversion.LocCMTProblem` does), and every
    tensor under such a field is split with the problem's traces, but for
    0-d tensors, which every trace shares (a window's tantheta)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        marked = getattr(type(tree), "trace_fields", ())
        return type(tree)(*(trace_leaves(v, inside or name in marked)
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(trace_leaves(v, inside) for v in tree)
    if isinstance(tree, dict):
        return {k: trace_leaves(v, inside) for k, v in tree.items()}
    return inside and isinstance(tree, torch.Tensor) and tree.dim() > 0


# ---------------------------------------------------------------------------
# the mesh and what lives on it
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices of the shards, row-major over ``shape``, and the axis names.
    A device may appear more than once (a virtual mesh)."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        n = 1
        for s in self.shape:
            n *= s
        if len(self.devices) != n or len(self.axis_names) != len(self.shape):
            raise ValueError(f"{len(self.devices)} devices, axes {self.axis_names} and "
                             f"shape {self.shape} do not match")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """The first shard's device, where the collectives end."""
        return self.devices[0]

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The distinct devices, in the order of their first shard."""
        return tuple(dict.fromkeys(self.devices))

    def axis_size(self, axis_name: str) -> int:
        return self.shape[self._axis(axis_name)]

    def coord(self, i: int, axis_name: str) -> int:
        """Shard i's index along ``axis_name``."""
        k = self._axis(axis_name)
        stride = 1
        for s in self.shape[k + 1:]:
            stride *= s
        return (i // stride) % self.shape[k]

    def line(self, axis_name: str) -> list[int]:
        """The shards along ``axis_name`` whose other indices are 0."""
        return [i for i in range(self.size)
                if all(self.coord(i, a) == 0 for a in self.axis_names if a != axis_name)]

    def _axis(self, axis_name: str) -> int:
        if axis_name not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis_name!r}")
        return self.axis_names.index(axis_name)

    def require_1d(self, axis_name: str, what: str) -> int:
        """The size of a 1-D mesh whose axis is ``axis_name``."""
        if self.axis_names != (axis_name,):
            raise ValueError(f"{what} takes a 1-D mesh with axis {axis_name!r}, "
                             f"got axes {self.axis_names}")
        return self.size


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A tree placed on a mesh.

    ``parts`` holds one tree per shard, in the mesh's order, its tensors on
    that shard's device (shards that share a device share its replicated
    copies). ``axes`` is the tree's structure with, at each leaf, the axis
    along which the leaf is split over the mesh axis ``axis_name``, or None
    where every shard holds all of it.
    """

    mesh: Mesh
    parts: tuple
    axes: Any
    axis_name: str

    def gather(self):
        """The whole tree on the lead device: split leaves concatenated along
        their axis from the shards along ``axis_name`` (the tiled
        all_gather), the others the first shard's."""
        lead = self.mesh.lead
        line = [self.parts[i] for i in self.mesh.line(self.axis_name)]

        def join(ax, *leaves):
            if ax is None:
                return _to(leaves[0], lead)
            return torch.cat([leaf.to(lead) for leaf in leaves], ax)

        return tree_map(join, self.axes, *line)


def _to(x, device: torch.device):
    """``x`` on ``device``: a tensor moved by ``.to`` (differentiable), an
    nn.Module deep-copied there unless all its tensors already are (the copy's
    parameters are its own: autograd does not lead them back to the
    original's), anything else (numbers, functions, None) as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, nn.Module):
        tensors = list(x.parameters()) + list(x.buffers())
        if all(t.device == device for t in tensors):
            return x
        return copy.deepcopy(x).to(device)
    return x


class _Copies:
    """Copies of leaves on devices, made once per (leaf, device) in a call."""

    def __init__(self):
        self._held = {}

    def on(self, x, device: torch.device):
        if not isinstance(x, (torch.Tensor, nn.Module)):
            return x
        key = (id(x), device)
        if key not in self._held:
            self._held[key] = (x, _to(x, device))   # x kept alive: its id stays its own
        return self._held[key][1]


def _block(x: torch.Tensor, axis: int, n: int, j: int) -> torch.Tensor:
    """Block j of n equal contiguous blocks of ``x`` along ``axis``."""
    size = x.shape[axis] // n
    return x.narrow(axis, j * size, size)


def _place(tree, mesh: Mesh, axis_name: str, axes) -> Sharded:
    """``tree`` on ``mesh``: each leaf with an axis in ``axes`` split into
    equal blocks along it over the mesh axis ``axis_name``, each block
    contiguous on its shard's device; the other leaves copied once to each
    distinct device."""
    n = mesh.axis_size(axis_name)
    copies = _Copies()
    parts = []
    for i, dev in enumerate(mesh.devices):
        j = mesh.coord(i, axis_name)
        parts.append(tree_map(
            lambda ax, a: copies.on(a, dev) if ax is None
            else _block(a, ax, n, j).to(dev).contiguous(), axes, tree))
    return Sharded(mesh, tuple(parts), axes, axis_name)


def _split_leading(tree, mesh: Mesh, axis_name: str, what: str) -> Sharded:
    """Every tensor of ``tree`` split along its leading axis, which the mesh
    axis must divide (JAX's in_specs=P(axis_name))."""
    n = mesh.axis_size(axis_name)

    def axis(a):
        if not isinstance(a, torch.Tensor):
            return None
        if a.dim() == 0 or a.shape[0] % n:
            raise ValueError(f"{what}: a leaf of shape {tuple(a.shape)} does not split "
                             f"into {n} shards along its leading axis")
        return 0

    return _place(tree, mesh, axis_name, tree_map(axis, tree))


def _as_split(batch, mesh: Mesh, axis_name: str, what: str) -> Sharded:
    """The batch argument of sharded_sum/sharded_map: a Sharded whose every
    tensor is split along its leading axis, or a tree to split so."""
    if not isinstance(batch, Sharded):
        return _split_leading(batch, mesh, axis_name, what)
    for ax, a in zip(tree_leaves(batch.axes), tree_leaves(batch.parts[0])):
        if isinstance(a, torch.Tensor) and ax != 0:
            raise ValueError(f"{what}: every tensor of the batch must be split along "
                             f"its leading axis")
    return batch


def _shard_args(args, mesh: Mesh) -> list[list]:
    """Each shard's arguments: a Sharded argument's part, anything else
    replicated (copied once to each distinct device)."""
    placed = [a if isinstance(a, Sharded) else replicate(a, mesh) for a in args]
    return [[a.parts[i] for a in placed] for i in range(mesh.size)]


def _psum(values: list, mesh: Mesh):
    """The per-shard trees ``values`` added leaf by leaf on the lead device."""
    lead = mesh.lead

    def add(*leaves):
        total = leaves[0].to(lead)
        for v in leaves[1:]:
            total = total + v.to(lead)
        return total

    return tree_map(add, *values)


# ---------------------------------------------------------------------------
# the public names
# ---------------------------------------------------------------------------


def _devices(n: int | None, device) -> tuple[torch.device, ...]:
    """Shard devices: without ``device`` the first n CUDA cards (all by
    default), a ValueError if there are fewer; with it, n shards (1 by
    default) on that one device, "cuda" taking the current card's index."""
    if device is None:
        have = torch.cuda.device_count()
        n = have if n is None else n
        if n < 1 or have < n:
            raise ValueError(f"need {max(n, 1)} devices, have {have}")
        return tuple(torch.device("cuda", i) for i in range(n))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return (dev,) * (1 if n is None else n)


def make_mesh(n_devices: int | None = None, axis_name: str = "batch",
              device=None) -> Mesh:
    """1-D mesh. Without ``device``: the first ``n_devices`` CUDA cards
    (default all), and a ValueError if there are fewer. With ``device``
    (e.g. "cpu" or "cuda:0"): ``n_devices`` shards (default 1) on that one
    device, the port's counterpart of JAX's forced host device count."""
    devs = _devices(n_devices, device)
    return Mesh(devs, (axis_name,), (len(devs),))


def shard_leading_axis(tree, mesh: Mesh, axis_name: str = "batch") -> Sharded:
    """Place a tree on the mesh by JAX's rule: a tensor whose leading axis
    divides by the size of the mesh axis is split along it, any other leaf
    is replicated."""
    n = mesh.axis_size(axis_name)
    axes = tree_map(lambda a: 0 if isinstance(a, torch.Tensor) and a.dim() > 0
                    and a.shape[0] % n == 0 and a.shape[0] >= n else None, tree)
    return _place(tree, mesh, axis_name, axes)


def replicate(tree, mesh: Mesh) -> Sharded:
    """One copy of the tree per distinct device of the mesh; an nn.Module is
    deep-copied there with its tensors, a plain function is kept as it is.
    Tensors stay differentiable through the copies; a module's parameters do
    not: on a mesh of several cards, a gradient w.r.t. them reaches only the
    copies (the module on its own device is not copied)."""
    return _place(tree, mesh, mesh.axis_names[0], tree_map(lambda a: None, tree))


def sharded_sum(fn: Callable, mesh: Mesh, axis_name: str = "batch") -> Callable:
    """``f(batch, *rest)`` -> the sum over the whole batch of the per-item
    outputs of ``fn(batch_slice, *rest)`` (a tree of them), on the lead
    device.

    ``batch``'s tensors are split along their leading axis over the mesh
    (a :class:`Sharded` from :func:`shard_leading_axis`, or a tree to split
    here); ``rest`` is replicated. Each shard calls the batched ``fn`` once on
    its slice and sums its outputs; a psum adds the shards' sums.
    Differentiable: a replicated input tensor's gradient is the sum of its
    per-shard gradients (not so an nn.Module's parameters: see
    :func:`replicate`).
    """
    mesh.require_1d(axis_name, "sharded_sum")

    def wrapper(batch, *rest):
        b = _as_split(batch, mesh, axis_name, "sharded_sum")
        local = [tree_map(torch.sum, fn(b.parts[i], *r))
                 for i, r in enumerate(_shard_args(rest, mesh))]
        return _psum(local, mesh)

    return wrapper


def sharded_map(fn: Callable, mesh: Mesh, axis_name: str = "batch") -> Callable:
    """``f(batch, *rest)`` -> :class:`Sharded` per-item outputs of the
    batched ``fn(batch_slice, *rest)``, split along their leading axis like
    the batch; no communication (``.gather()`` concatenates them on the lead
    device).

    The multi-device form of the reference's two most expensive workloads,
    the misfit-surface scan and the 64-start study: each shard evaluates its
    slice of the model-node or start axis in one call.
    """
    mesh.require_1d(axis_name, "sharded_map")

    def wrapper(batch, *rest):
        b = _as_split(batch, mesh, axis_name, "sharded_map")
        out = [fn(b.parts[i], *r) for i, r in enumerate(_shard_args(rest, mesh))]
        axes = tree_map(lambda a: 0 if isinstance(a, torch.Tensor) else None, out[0])
        return Sharded(mesh, tuple(out), axes, axis_name)

    return wrapper


def pjit_batched_misfit(misfit_fn: Callable, mesh: Mesh,
                        axis_name: str = "batch") -> Callable:
    """``f(*args)`` -> ``misfit_fn(*args)`` on the whole problem, evaluated
    per shard and added on the lead device.

    JAX jits ``misfit_fn`` over inputs placed by :func:`shard_leading_axis`
    and lets GSPMD partition it, which is right whatever the placement. The
    port has no partitioner: it splits the problem by its traces and adds
    the shards' misfits, which is exact for a misfit that is a sum over
    traces. The traces are the per-trace leaves that the problem's type
    declares (:func:`trace_leaves`; ``LocCMTProblem``'s stations, observed
    seismograms, windows and targets). An argument may be a :class:`Sharded`,
    which is gathered whole on the lead device first, or a plain tree; then
    each shard gets its block of the per-trace leaves, which the mesh must
    divide, and every other leaf whole. So a leaf that the caller's placement
    split although it is no trace axis (a time axis ``t`` whose length the
    mesh divides, ``mref`` (3,) on a 3-shard mesh) is never used as a
    fragment. Differentiable like :func:`sharded_sum`.
    """
    n = mesh.require_1d(axis_name, "pjit_batched_misfit")

    def trace_axes(whole):
        """Axis 0 at each per-trace leaf, which the mesh must divide."""
        def axis(m, a):
            if not m:
                return None
            if a.shape[0] % n:
                raise ValueError(f"pjit_batched_misfit: a per-trace leaf of shape "
                                 f"{tuple(a.shape)} does not split into {n} shards")
            return 0
        return tree_map(axis, trace_leaves(whole), whole)

    def wrapper(*args):
        wholes = [a.gather() if isinstance(a, Sharded) else a for a in args]
        axes = [trace_axes(w) for w in wholes]
        if all(ax is None for t in axes for ax in tree_leaves(t)):
            raise ValueError("pjit_batched_misfit: no argument has per-trace leaves to "
                             "split (see trace_leaves)")
        parts = [_place(w, mesh, axis_name, ax).parts for w, ax in zip(wholes, axes)]
        return _psum([misfit_fn(*(p[i] for p in parts)) for i in range(mesh.size)], mesh)

    return wrapper
