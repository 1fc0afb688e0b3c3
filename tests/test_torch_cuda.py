"""The port's CUDA kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA card and nvcc and skips without them. The file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import compare_fields
from waveform_ot_torch.inversion import InvOptions, loc_cmt_value_and_grad
from waveform_ot_torch.ops import cuda_distance
from waveform_ot_torch.ops import fingerprint as tfp

pytestmark = [
    pytest.mark.cuda,
    # a string condition is evaluated when each test runs, not at import
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card"),
]
TOL = {torch.float64: 1e-12, torch.float32: 1e-6}


def _inputs(bsz, nt, nu, ntg, dtype, seed):
    """Normalized vertices and grids of ``bsz`` noisy traces on the card."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, nt)
    w = (np.sin(7.0 * t[None] + rng.standard_normal((bsz, 1)))
         + 0.05 * rng.standard_normal((bsz, nt)))
    dev = torch.device("cuda")
    arr = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    win = tfp.make_window(0.0, 1.0, 0.0, 0.0, dtype=dtype, device=dev)._replace(
        u0=arr(-1.4 - 0.2 * rng.random(bsz)), u1=arr(1.4 + 0.2 * rng.random(bsz)))
    verts = tfp.normalize_vertices(arr(t), arr(w), win)
    tg, ug = tfp.grid_axes(arr(t), win, tfp.FingerprintSpec(nu=nu, ntg=ntg))
    return (verts.contiguous(), tg.expand(bsz, ntg).contiguous(),
            ug.expand(bsz, nu).contiguous())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bsz,nt,nu,ntg", [
    (192, 61, 79, 61),          # loc/CMT batch
    (1, 256, 80, 512),          # Ricker
    (3, 1500, 33, 257),         # more segments than one shared-memory tile
    (5, 2, 7, 3),               # one segment, grid smaller than a block
])
def test_kernel_matches_plain_version(dtype, bsz, nt, nu, ntg):
    args = _inputs(bsz, nt, nu, ntg, dtype, seed=nt)
    before = cuda_distance.LAUNCHES
    got = tfp.DistanceField(*cuda_distance.distance_field_cuda(*args))
    torch.cuda.synchronize()
    assert cuda_distance.LAUNCHES == before + 1
    assert got.iclose.dtype == torch.int32 and got.dvec.shape == (bsz, nu, ntg, 2)
    ref = tfp.distance_field_torch(*args)
    rep = compare_fields(got, ref, TOL[dtype])
    assert rep["tie_flips"] <= 0.01 * got.d.numel()


def test_dispatcher_launches_the_kernel_for_cuda_tensors():
    args = _inputs(4, 30, 11, 13, torch.float64, seed=1)
    before = cuda_distance.LAUNCHES
    fld = tfp.distance_field(*args)
    assert cuda_distance.LAUNCHES == before + 1 and fld.d.is_cuda


def test_distance_field_diff_backward_on_card_matches_cpu():
    """Envelope backward on the card vs the CPU, float64: scatter_add_ sums
    with atomics in varying order, so 1e-12 relative to the largest entry."""
    args = _inputs(6, 40, 21, 23, torch.float64, seed=2)
    gbar = torch.randn(6, 21, 23, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(0))
    outs = []
    for dev in ("cuda", "cpu"):
        xs = [a.detach().to(dev).requires_grad_(True) for a in args]
        d = tfp.distance_field_diff(*xs)
        outs.append([d.detach().cpu()] + [g.cpu() for g in torch.autograd.grad(
            d, xs, grad_outputs=gbar.to(dev))])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12 * b.abs().max().item())


def test_loc_cmt_on_card_matches_cpu():
    """The whole objective at 8 stations, float64, card vs CPU: cumsum is a
    parallel scan and scatters use atomics on the card, hence 1e-10."""
    from chip_smoke import DM, build_loc64_problem

    res = []
    for dev in (torch.device("cuda"), torch.device("cpu")):
        loc, cfg, prob = build_loc64_problem(8, torch.float64, dev)
        before = cuda_distance.LAUNCHES
        v, g = loc_cmt_value_and_grad(loc + torch.tensor(DM, dtype=torch.float64, device=dev),
                                      prob, InvOptions(), cfg)
        res.append((v.item(), g.cpu().numpy(), cuda_distance.LAUNCHES - before))
    (vc, gc, nc), (vh, gh, nh) = res
    assert nc >= 1 and nh == 0
    np.testing.assert_allclose(vc, vh, rtol=1e-10)
    np.testing.assert_allclose(gc, gh, rtol=0, atol=1e-10 * np.abs(gh).max())


def test_wrapper_checks_inputs():
    dev = torch.device("cuda")
    v = torch.zeros(1, 5, 2, device=dev)
    g = torch.zeros(1, 4, device=dev)
    with pytest.raises(TypeError):
        cuda_distance.distance_field_cuda(v, g.double(), g)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_distance.distance_field_cuda(v, torch.zeros(1, 8, device=dev)[:, ::2], g)
    with pytest.raises(ValueError, match="shape"):
        cuda_distance.distance_field_cuda(v, torch.zeros(2, 4, device=dev), g)
    with pytest.raises(TypeError):
        cuda_distance.distance_field_cuda(v.half(), g.half(), g.half())
