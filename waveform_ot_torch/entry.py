"""The system's entry points on the port (counterpart of ``__graft_entry__.py``).

    python -m waveform_ot_torch.entry [--device cuda|cpu]

:func:`entry` gives the flagship step, the loc-only OT misfit and its
gradient through the six-layer Fukuoka f-k forward (4 stations, nt 61,
nk 96, float32); :func:`dryrun_multichip` runs ``__graft_entry__``'s four
mesh steps, each with the same sizes:

  a. a trace-sharded far-field loc value and gradient and one Adam update;
  b. one fingerprint grid sharded over the mesh by time columns
     (sequence-parallel), value and gradient;
  c. traces over one axis and grid columns over the other of a 2-D mesh
     (dp x sp), value and gradient, for an even mesh of 4 or more;
  d. the layered physics with its stations sharded, one Adam update.

The Adam update is ``torch.optim.Adam(lr=1e-2)`` over a plain tensor on the
mesh's lead device: its defaults (betas 0.9/0.999, eps 1e-8 outside the
square root) are ``optax.adam``'s. Everything runs on the card unless a
``device`` is given; there is no fallback to the CPU. Each evaluation
launches the distance-field kernel once per shard on the card (the plain
field on the CPU).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from waveform_ot_torch.inversion import (
    InvOptions, TraceConfig, build_loc_cmt_problem, loc_cmt_misfit, loc_cmt_value_and_grad,
)
from waveform_ot_torch.models import (
    StationSet, fukuoka_model, make_layered_forward, moment_tensor_from_sdr,
    synthetic_seismograms,
)
from waveform_ot_torch.ops import cuda_distance, make_density_1d
from waveform_ot_torch.parallel import (
    Mesh, dp_sp_marg_misfit, grid_sharded_marg_misfit, make_mesh, make_mesh_2d,
    pjit_batched_misfit, shard_grid_axis, shard_leading_axis,
)

LOC = (2.0, -1.5, 12.0)
SDR_M0 = (30.0, 60.0, 45.0, 5.0e6)    # strike, dip, rake (degrees), M0
NT = 61
LOC_ONLY = InvOptions(loc=True, cmt=False, mistype="OT")
ADAM_LR = 1e-2


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _observed(s, dtype, device):
    """s plus 0.002 max|s| of standard normals from numpy default_rng(0)."""
    rng = np.random.default_rng(0)
    return s + 0.002 * float(s.abs().max()) * torch.as_tensor(
        rng.standard_normal(tuple(s.shape)), dtype=dtype, device=device)


def _circle(nr: int, radius: float, dtype, device) -> StationSet:
    ang = np.linspace(0, 2 * np.pi, nr, endpoint=False)
    arr = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return StationSet(x=arr(radius * np.cos(ang)), y=arr(radius * np.sin(ang)))


def _moment(dtype, device):
    strike, dip, rake, m0 = SDR_M0
    return moment_tensor_from_sdr(strike, dip, rake, m0=m0, device=device).to(dtype)


def _build_problem(nr: int, dtype=torch.float32, device=None):
    """The bench's far-field loc/CMT problem (``__graft_entry__:33-57``): nr
    stations on a 60 km circle, source at LOC, strike/dip/rake 30/60/45 with
    M0 5e6, nt 61, 0.002 max|s| noise from numpy default_rng(0), 79x61
    grids, lambda 0.04, W2. Returns (loc, cfg, prob)."""
    device = _device(device)
    stations = _circle(nr, 60.0, dtype, device)
    loc = torch.tensor(LOC, dtype=dtype, device=device)
    mxyz = _moment(dtype, device)
    t, s = synthetic_seismograms(loc[0], loc[1], loc[2], mxyz, stations, nt=NT, dt=1.0)
    cfg = TraceConfig(nu=79, ntg=NT, lambdav=0.04, q=None, p=2)
    return loc, cfg, build_loc_cmt_problem(t, _observed(s, dtype, device), stations, cfg,
                                           mxyz_fixed=mxyz)


def _build_layered_problem(nr: int, nt: int = NT, nk: int = 96, kmax: float = 2.0,
                           model=None, dtype=torch.float32, device=None):
    """The flagship configuration (``__graft_entry__:60-93``): the six-layer
    Fukuoka f-k physics (``model``, default :func:`fukuoka_model` on
    ``device``) at nr stations on a 60 km circle, source at LOC, strike/dip/
    rake 30/60/45 with M0 5e6, observed data from the layered forward plus
    0.002 max|s| noise from numpy default_rng(0), 79 x nt grids, lambda
    0.04, W2. Returns (loc, cfg, prob, forward)."""
    device = _device(device)
    model = fukuoka_model(device=device) if model is None else model
    stations = _circle(nr, 60.0, dtype, device)
    mxyz = _moment(dtype, device)
    forward = make_layered_forward(stations, model=model, nt=nt, dt=1.0, nk=nk, kmax=kmax)
    loc = torch.tensor(LOC, dtype=dtype, device=device)
    with torch.no_grad():
        s = forward(loc[0], loc[1], loc[2], mxyz)
    cfg = TraceConfig(nu=79, ntg=nt, lambdav=0.04, q=None, p=2)
    prob = build_loc_cmt_problem(torch.arange(nt, dtype=dtype, device=device),
                                 _observed(s, dtype, device), stations, cfg, mxyz_fixed=mxyz)
    return loc, cfg, prob, forward


def entry(device=None, dtype=torch.float32):
    """(fn, (m0, prob)): ``fn(m, prob) -> (value, grad)``, the loc-only OT
    misfit and its gradient through the six-layer Fukuoka f-k forward at 4
    stations, nt 61, nk 96 (``__graft_entry__.entry``), from m0 = LOC + 3 km.
    One distance-field launch per call on the card."""
    loc, cfg, prob, forward = _build_layered_problem(4, dtype=dtype, device=device)

    def fn(m, prob):
        return loc_cmt_value_and_grad(m, prob, LOC_ONLY, cfg, forward=forward)

    return fn, (loc + 3.0, prob)


def loc_misfit(prob, cfg: TraceConfig, mesh: Mesh | None = None, forward=None):
    """``m -> value``, the loc-only OT misfit of ``prob`` at one model m (3,):
    unsharded without ``mesh``, else with the problem's traces split over the
    mesh (``pjit_batched_misfit``; ``prob`` a tree or placed by
    ``shard_leading_axis``). ``forward`` is a station-dynamic
    ``forward(x, y, z, mxyz, stations)`` (``make_layered_forward`` with no
    stations), None for the far field."""
    def misfit(m, p):
        fwd = None if forward is None else (
            lambda x, y, z, mx: forward(x, y, z, mx, p.stations))
        return loc_cmt_misfit(m, p, LOC_ONLY, cfg, forward=fwd)

    if mesh is None:
        return lambda m: misfit(m, prob)
    sharded = pjit_batched_misfit(misfit, mesh)
    return lambda m: sharded(m, prob)


def adam(m: torch.Tensor) -> torch.optim.Adam:
    """``optax.adam(1e-2)`` over the plain leaf tensor m (requires_grad)."""
    return torch.optim.Adam([m], lr=ADAM_LR)


def adam_step(misfit, m: torch.Tensor, optimizer: torch.optim.Optimizer):
    """One training step (``__graft_entry__``'s ``train_step``): the value and
    gradient of ``misfit(m)`` at m, then one update of m in place by
    ``optimizer``. Returns (value, grad), both at m before the update."""
    optimizer.zero_grad(set_to_none=True)
    with torch.enable_grad():
        value = misfit(m)
        value.backward()
    grad = m.grad.detach().clone()
    optimizer.step()
    return value.detach(), grad


def _mesh(n: int, device):
    """(1-D mesh, its 2-D (2, n/2) form or None): the first n cards when
    ``device`` is None and there are n, else n shards of ``device`` (None:
    the current card)."""
    if device is None and torch.cuda.device_count() >= n:
        dev = None
    else:
        dev = _device(device)
    mesh2 = make_mesh_2d(2, n // 2, device=dev) if n >= 4 and n % 2 == 0 else None
    return make_mesh(n, device=dev), mesh2


def _launched(fn):
    """(fn(), distance-field kernel launches it made)."""
    before = cuda_distance.LAUNCHES
    out = fn()
    return out, cuda_distance.LAUNCHES - before


def _adam_result(value, grad, m, optimizer, launches) -> dict:
    state = optimizer.state[m]
    return {"value": value.item(), "grad": grad, "m1": m.detach().clone(),
            "exp_avg": state["exp_avg"].clone(), "exp_avg_sq": state["exp_avg_sq"].clone(),
            "launches": launches}


def _step_trace_sharded(mesh: Mesh, dtype) -> dict:
    """Step a (``__graft_entry__:182-215``): max(n, 2) stations x 3 traces
    split over the mesh, value, gradient and one Adam update from LOC + 3."""
    loc, cfg, prob = _build_problem(max(mesh.size, 2), dtype, mesh.lead)
    placed = shard_leading_axis(prob, mesh)
    per_shard = {p.seis_obs.shape[0] for p in placed.parts}
    if per_shard != {prob.seis_obs.shape[0] // mesh.size}:
        raise AssertionError(f"stations not sharded over {mesh.size} shards: {per_shard}")
    m = (loc + 3.0).requires_grad_(True)
    opt = adam(m)
    (value, grad), n = _launched(lambda: adam_step(loc_misfit(placed, cfg, mesh), m, opt))
    return _adam_result(value, grad, m, opt, n)


def _seq_inputs(n: int, dtype, device):
    """Step b's polyline (24, 2) on [0, 1], its 16n x 12 grid axes and target
    marginals from numpy default_rng(1)."""
    nt, ntg, nu = 24, 16 * n, 12
    arr = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    tw = np.linspace(0.0, 1.0, nt)
    verts = arr(np.stack([tw, 0.5 + 0.2 * np.sin(4 * np.pi * tw)], axis=1))
    tgrid, ugrid = arr(np.linspace(0.0, 1.0, ntg)), arr(np.linspace(0.0, 1.0, nu))
    rng = np.random.default_rng(1)
    tt = make_density_1d(arr(rng.random(ntg) + 0.1), tgrid)
    tu = make_density_1d(arr(rng.random(nu) + 0.1), ugrid)
    return verts, tgrid, ugrid, tt, tu


def _value_and_grads(fn, *xs):
    xs = [x.detach().requires_grad_(True) for x in xs]
    with torch.enable_grad():
        v = fn(*xs)
        grads = torch.autograd.grad(v, xs)
    return v.detach(), grads


def _step_seq_parallel(mesh: Mesh, dtype) -> dict:
    """Step b (``__graft_entry__:217-250``): one fingerprint of 16n time
    columns sharded over the mesh, 0.5 W_t + 0.5 W_u and its gradients
    w.r.t. the polyline and the time shift."""
    verts, tgrid, ugrid, tt, tu = _seq_inputs(mesh.size, dtype, mesh.lead)
    fn = grid_sharded_marg_misfit(mesh, lambdav=0.04, q=None, p=2)
    tg = shard_grid_axis(tgrid, mesh)

    def obj(v, ts):
        wt, wu = fn(v, tg, ugrid, tt, tu, ts)
        return 0.5 * wt + 0.5 * wu

    zero = torch.zeros((), dtype=dtype, device=mesh.lead)
    (value, (gv, gt)), n = _launched(lambda: _value_and_grads(obj, verts, zero))
    return {"value": value.item(), "grad_verts": gv, "grad_tshift": gt, "launches": n,
            "columns": tgrid.shape[0]}


def _dp_sp_inputs(ns: int, dtype, device, nb: int = 2):
    """Step c's 2 nb polylines (step b's, each raised by 0.01 k), the 8 ns
    time columns, step b's amplitude axis and the per-trace linear target
    marginals: (verts_b, tgrid, ugrid, target_t, target_u, tshift)."""
    verts, _, ugrid, _, _ = _seq_inputs(1, dtype, device)
    ntr, ntg = 2 * nb, 8 * ns
    arr = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    k = np.arange(ntr)[:, None]
    vb = verts.expand(ntr, *verts.shape) + arr(0.01 * k)[..., None]
    tgrid = arr(np.linspace(0.0, 1.0, ntg))
    tt = make_density_1d(arr(np.linspace(0.5, 1.5, ntg) + 0.1 * k), tgrid.expand(ntr, ntg))
    tu = make_density_1d(arr(np.linspace(1.5, 0.5, ugrid.shape[0]) + 0.1 * k),
                         ugrid.expand(ntr, ugrid.shape[0]))
    return vb, tgrid, ugrid, tt, tu, torch.zeros(ntr, dtype=dtype, device=device)


def _step_dp_sp(mesh2: Mesh, dtype) -> dict:
    """Step c (``__graft_entry__:252-287``): 4 traces over the 2 rows and 8 ns
    time columns over the ns columns of the (2, ns) mesh, the alpha 0.5
    marginal misfit summed over traces and its gradient w.r.t. the
    polylines."""
    nb, ns = mesh2.shape
    vb, tgrid, ugrid, tt, tu, ts = _dp_sp_inputs(ns, dtype, mesh2.lead, nb)
    fn = dp_sp_marg_misfit(mesh2, lambdav=0.04, q=None, p=2, alpha=0.5)
    tg = shard_grid_axis(tgrid, mesh2, axis_name="seq")
    (value, (g,)), n = _launched(lambda: _value_and_grads(
        lambda v: fn(v, tg, ugrid, tt, tu, ts), vb))
    return {"value": value.item(), "grad": g, "launches": n, "traces": vb.shape[0],
            "columns": tgrid.shape[0]}


LAYERED_DRYRUN = dict(nt=16, dt=1.0, nk=24, kmax=1.0)


def _dryrun_layered_problem(nr: int, dtype, device):
    """Step d's problem (``__graft_entry__:301-320``): the six-layer Fukuoka
    model, nr stations on a 30 km circle, source (2, -1.5, 9) (in layer 4),
    nt 16, nk 24, kmax 1, 0.002 max|s| noise from numpy default_rng(0), 15x16
    grids, lambda 0.04, W2. Returns (loc, cfg, prob, forward), ``forward``
    station-dynamic (the Fukuoka model built on the sources' device)."""
    stations = _circle(nr, 30.0, dtype, device)
    mxyz = _moment(dtype, device)
    forward = make_layered_forward(**LAYERED_DRYRUN)
    loc = torch.tensor((2.0, -1.5, 9.0), dtype=dtype, device=device)
    with torch.no_grad():
        s = forward(loc[0], loc[1], loc[2], mxyz, stations)
    nt = LAYERED_DRYRUN["nt"]
    cfg = TraceConfig(nu=15, ntg=nt, lambdav=0.04, q=None, p=2)
    prob = build_loc_cmt_problem(torch.arange(nt, dtype=dtype, device=device),
                                 _observed(s, dtype, device), stations, cfg, mxyz_fixed=mxyz)
    return loc, cfg, prob, forward


LAYERED_START = (1.0, -0.5, 0.5)      # step d's start, from its source


def _step_layered(mesh: Mesh, dtype) -> dict:
    """Step d (``__graft_entry__:289-346``): the layered physics with its n
    stations sharded over the mesh, value, gradient and one Adam update."""
    loc, cfg, prob, forward = _dryrun_layered_problem(mesh.size, dtype, mesh.lead)
    placed = shard_leading_axis(prob, mesh)
    if {p.stations.x.shape[0] for p in placed.parts} != {1}:
        raise AssertionError("layered stations not sharded one per shard")
    m = (loc + torch.tensor(LAYERED_START, dtype=dtype, device=mesh.lead)).requires_grad_(True)
    opt = adam(m)
    (value, grad), n = _launched(lambda: adam_step(
        loc_misfit(placed, cfg, mesh, forward=forward), m, opt))
    return _adam_result(value, grad, m, opt, n)


def dryrun_multichip(n_devices: int, device=None, dtype=torch.float32) -> dict:
    """``__graft_entry__.dryrun_multichip``'s four steps on an n-shard mesh:
    the first n cards if there are n, else n shards of one device (``device``,
    default the current card; "cpu" for n CPU shards). Prints JAX's lines and
    returns {"mesh": (axis sizes), "trace_sharded": ..., "seq_parallel": ...,
    "dp_sp": ... (even n >= 4 only), "layered": ...}, each step's value,
    gradients and kernel launches (the Adam steps also m1 and the moments)."""
    mesh, mesh2 = _mesh(n_devices, device)
    shape = dict(zip(mesh.axis_names, mesh.shape))
    out = {"mesh": shape}

    a = out["trace_sharded"] = _step_trace_sharded(mesh, dtype)
    _check_finite("trace-sharded step", a["value"], a["grad"], a["m1"])
    print(f"dryrun_multichip({n_devices}): misfit={a['value']:.6e} step OK on mesh {shape}")

    b = out["seq_parallel"] = _step_seq_parallel(mesh, dtype)
    _check_finite("seq-parallel step", b["value"], b["grad_verts"], b["grad_tshift"])
    print(f"dryrun_multichip({n_devices}): seq-parallel grid misfit={b['value']:.6e} grad OK "
          f"({b['columns']} columns over {n_devices} devices)")

    if mesh2 is not None:
        c = out["dp_sp"] = _step_dp_sp(mesh2, dtype)
        _check_finite("dp x sp step", c["value"], c["grad"])
        print(f"dryrun_multichip({n_devices}): dp x sp 2-D mesh ({mesh2.shape[0]}x"
              f"{mesh2.shape[1]}) misfit={c['value']:.6e} grad OK ({c['traces']} traces x "
              f"{c['columns']} columns)")

    d = out["layered"] = _step_layered(mesh, dtype)
    _check_finite("layered step", d["value"], d["grad"], d["m1"])
    print(f"dryrun_multichip({n_devices}): LAYERED station-sharded step "
          f"misfit={d['value']:.6e} OK ({n_devices} stations x 3 comps, six-layer Fukuoka "
          f"stack, complex128)")
    return out


def _check_finite(what: str, value: float, *tensors) -> None:
    if not (np.isfinite(value) and all(bool(torch.isfinite(t).all()) for t in tensors)):
        raise AssertionError(f"non-finite {what}: {value}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA cards); 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    fn, (m0, prob) = entry(args.device)
    v, g = fn(m0, prob)
    print("entry:", v.item(), g.cpu().numpy())
    dryrun_multichip(8, device=args.device)


if __name__ == "__main__":
    main()
