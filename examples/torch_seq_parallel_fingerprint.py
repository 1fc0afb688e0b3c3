"""Sequence-parallel fingerprint on the PyTorch port: one grid sharded over a mesh.

The port's counterpart of examples/seq_parallel_fingerprint.py, with the same
workload: FingerprintLib's 626-sample demo waveform on an 800x600 grid, the
grid's 600 time columns split into 8 blocks of 75, one per shard
(waveform_ot_torch.parallel.grid_shard). Each shard computes its block's
distance field (one kernel launch on the card); only the marginals meet on
the lead device. The sharded value and gradient are asserted against the
unsharded pipeline.

The 8 shards share one device (a virtual mesh, the counterpart of the JAX
example's forced 8 CPU devices), so the sharded call is not faster: each
shard adds its own launches.

Run: python examples/torch_seq_parallel_fingerprint.py [--device cpu]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="device of the 8 shards (default cuda)")
    args = ap.parse_args()

    from waveform_ot_torch.ops import (
        Density1D, density_from_distance, distance_field_diff, make_density_1d,
    )
    from waveform_ot_torch.ops.marginal import marg_wasserstein_value
    from waveform_ot_torch.parallel import (
        grid_sharded_marg_misfit, make_mesh, shard_grid_axis,
    )

    dev = torch.device(args.device)
    mesh = make_mesh(8, axis_name="seq", device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"mesh: {mesh.size} shards on {dev} ({name})")

    # the FingerprintLib __main__ demo scale: 626-sample waveform, 800x600, float32
    nt, nu, ntg = 626, 800, 600
    arr = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
    t = np.linspace(0.0, 1.0, nt)
    w = (2 * np.sin(t * 6 * np.pi) - 3 * np.cos((2 * t + 0.30) * 2 * np.pi)) / 6.0 + 0.5
    verts = arr(np.stack([t, w], axis=1))
    tgrid, ugrid = arr(np.linspace(0.0, 1.0, ntg)), arr(np.linspace(0.0, 1.0, nu))
    rng = np.random.default_rng(0)
    target_t = make_density_1d(arr(rng.random(ntg) + 0.1), tgrid)
    target_u = make_density_1d(arr(rng.random(nu) + 0.1), ugrid)
    rows = lambda d: Density1D(*(a[None] for a in d))

    def ref_obj(v, ts):
        u2d = density_from_distance(distance_field_diff(v[None], tgrid[None], ugrid[None]), 0.04)
        wt, wu = marg_wasserstein_value(u2d, tgrid[None], ugrid[None], rows(target_t),
                                        rows(target_u), p=2, tshift=ts)
        return (0.5 * wt + 0.5 * wu)[0]

    fn = grid_sharded_marg_misfit(mesh, lambdav=0.04, q=None, p=2)
    tg_sh = shard_grid_axis(tgrid, mesh)      # each shard's 75 columns, once

    def sharded_obj(v, ts):
        wt, wu = fn(v, tg_sh, ugrid, target_t, target_u, ts)
        return 0.5 * wt + 0.5 * wu

    def value_and_grad(obj):
        v = verts.clone().requires_grad_(True)
        ts = torch.zeros((), dtype=verts.dtype, device=dev, requires_grad=True)
        val = obj(v, ts)
        return val.detach(), torch.autograd.grad(val, (v, ts))

    v0, (g0, _) = value_and_grad(ref_obj)
    v1, (g1, _) = value_and_grad(sharded_obj)
    dv = abs(v1.item() - v0.item()) / abs(v0.item())
    dg = ((g1 - g0).abs().max() / g0.abs().max()).item()
    print(f"misfit   single={v0.item():.10e}  sharded={v1.item():.10e}  rel diff {dv:.2e}")
    print(f"gradient max rel diff {dg:.2e}")
    # float32, as the JAX example: the sharded sums add the marginals in
    # another order than the single-device sums, so they agree to f32 round-off
    assert dv < 1e-6 and dg < 1e-5

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for label, obj in (("single-device", ref_obj), (f"{mesh.size} shards", sharded_obj)):
        value_and_grad(obj)  # warm
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            value_and_grad(obj)
        sync()
        print(f"{label:14s}: {(time.perf_counter() - t0) / 3 * 1e3:8.2f} ms per value+grad "
              f"({nu}x{ntg} grid, {nt - 1} segments, on {dev})")


if __name__ == "__main__":
    main()
