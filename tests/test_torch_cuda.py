"""The port's CUDA kernel against its plain PyTorch version, and the paths
that launch it, on the card; the OT toolbox on the card against the CPU.

Every test here needs a CUDA card and nvcc and skips without them. The file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import _nested_dev, compare_fields
from waveform_ot_torch.inversion import InvOptions, loc_cmt_value_and_grad
from waveform_ot_torch.ops import cuda_distance
from waveform_ot_torch.ops import fingerprint as tfp

pytestmark = [
    pytest.mark.cuda,
    # a string condition is evaluated when each test runs, not at import
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card"),
]
TOL = {torch.float64: 1e-12, torch.float32: 1e-6}
TIE_BOX = np.array([[0.0, 0.0], [0.0, 2.0], [4.0, 2.0], [4.0, 0.0]])  # as in the CPU test


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
@pytest.mark.parametrize("bsz,nt,nu,ntg,split", [
    (192, 61, 79, 61, None),    # loc/CMT batch: S = 1; ntg % 4 != 0
    (1, 256, 80, 512, None),    # Ricker: B = 1, S = 8, nseg % S != 0
    (3, 1500, 33, 257, None),   # more segments than one shared-memory tile, S = 16
    (5, 2, 7, 3, None),         # one segment, grid smaller than a block, ntg < 4
    (1, 4, 9, 7, 32),           # nseg = 3 < S; ntg % 4 != 0
    (1, 40, 6, 13, 32),         # nseg % S != 0
    (2, 40, 6, 2, 4),           # rows shorter than a thread's 4 points, split
])
def test_kernel_matches_plain_version(monkeypatch, dtype, bsz, nt, nu, ntg, split):
    """The plan's S at each shape, or the S given, against the plain version;
    ``split`` reaches splits that the plan keeps for longer polylines."""
    if split is not None:
        monkeypatch.setattr(cuda_distance, "plan", lambda *shape: split)
    args = _inputs(bsz, nt, nu, ntg, dtype, seed=nt)
    before = cuda_distance.LAUNCHES
    got = tfp.DistanceField(*cuda_distance.distance_field_cuda(*args))
    torch.cuda.synchronize()
    assert cuda_distance.LAUNCHES == before + 1
    assert got.iclose.dtype == torch.int32 and got.dvec.shape == (bsz, nu, ntg, 2)
    ref = tfp.distance_field_torch(*args)
    rep = compare_fields(got, ref, TOL[dtype])
    assert rep["tie_flips"] <= 0.01 * got.d.numel()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_takes_a_batch_past_grid_y(dtype):
    """70,000 traces (more than gridDim.y's 65,535) on an 8x8 grid with 6
    samples: one launch, bit for bit equal to the plain version."""
    args = _inputs(70_000, 6, 8, 8, dtype, seed=70)
    before = cuda_distance.LAUNCHES
    got = tfp.DistanceField(*cuda_distance.distance_field_cuda(*args))
    torch.cuda.synchronize()
    assert cuda_distance.LAUNCHES == before + 1
    ref = tfp.distance_field_torch(*args)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("reverse", [False, True], ids=["box", "reversed_box"])
def test_kernel_exact_tie_takes_lower_segment(monkeypatch, dtype, reverse):
    """The CPU test's box polyline (three segments, exact arithmetic): (2, -1)
    ties segments 0 and 2, (2, 0) ties all three; segment 0 wins in the kernel,
    with the segments on one lane and split over four, and in the plain
    version."""
    arr = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                    device="cuda")[None]
    args = (arr(TIE_BOX[::-1] if reverse else TIE_BOX), arr([1.0, 2.0, 3.0]),
            arr([-1.0, 0.0]))
    ref = tfp.distance_field_torch(*args)
    assert ref.iclose[0, 0, 1].item() == 0 and ref.iclose[0, 1, 1].item() == 0
    for split in (1, 4):
        monkeypatch.setattr(cuda_distance, "plan", lambda *shape: split)
        got = tfp.DistanceField(*cuda_distance.distance_field_cuda(*args))
        for x, y in zip(got, ref):
            assert torch.equal(x, y), split


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_zero_length_segment(dtype):
    """A repeated first vertex makes segment 0 zero-length and its lam NaN.
    The plain version, like JAX, lets the NaN win. The kernel's field is the
    box's with every index one higher: in f64 it skips the segment; in f32
    it takes lam = 0, so the segment counts as its point and wins the ties
    where the box's winner is its segment 0 at lam = 0."""
    arr = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                    device="cuda")[None]
    grid = (arr([1.0, 2.0, 3.0]), arr([-1.0, 0.0]))
    args = (arr(np.insert(TIE_BOX, 0, TIE_BOX[0], axis=0)), *grid)
    assert tfp.distance_field_torch(*args).lam.isnan().all()
    got = tfp.DistanceField(*cuda_distance.distance_field_cuda(*args))
    box = tfp.distance_field_torch(arr(TIE_BOX), *grid)
    at_start = (box.iclose == 0) & (box.lam == 0) & (dtype == torch.float32)
    assert at_start.any() or dtype == torch.float64
    assert torch.equal(got.iclose, torch.where(at_start, 0, box.iclose + 1))
    for x, y in zip((got.d, got.lam, got.dvec), (box.d, box.lam, box.dvec)):
        assert torch.equal(x, y)


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
    assert nc == 1 and nh == 0
    np.testing.assert_allclose(vc, vh, rtol=1e-10)
    np.testing.assert_allclose(gc, gh, rtol=0, atol=1e-10 * np.abs(gh).max())


def test_batched_loc_cmt_on_card_matches_cpu():
    """Four models at 8 stations in one call, float64, card vs CPU: one
    kernel launch for all 96 traces; 1e-10 as in the single-model test."""
    from chip_smoke import LOC, build_loc64_problem

    res = []
    for dev in (torch.device("cuda"), torch.device("cpu")):
        _, cfg, prob = build_loc64_problem(8, torch.float64, dev)
        ms = torch.tensor(LOC, dtype=torch.float64, device=dev) + torch.tensor(
            [[4.0, -3.0, 2.0], [-6.0, 1.0, 3.0], [0.5, 7.0, -2.0], [9.0, 9.0, 5.0]],
            dtype=torch.float64, device=dev)
        before = cuda_distance.LAUNCHES
        v, g = loc_cmt_value_and_grad(ms, prob, InvOptions(), cfg)
        res.append((v.cpu().numpy(), g.cpu().numpy(), cuda_distance.LAUNCHES - before))
    (vc, gc, nc), (vh, gh, nh) = res
    assert nc == 1 and nh == 0 and vc.shape == (4,) and gc.shape == (4, 3)
    np.testing.assert_allclose(vc, vh, rtol=1e-10)
    for a, b in zip(gc, gh):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 * np.abs(b).max())


def test_batched_solver_syncs_only_on_its_loop_flags():
    """minimize_lbfgs_batched on the card reads the device only for its two
    loop flags: over 5 outer iterations (tol 0 keeps every lane active),
    one read per outer check and one per line-search check, counted by
    torch's sync debug mode; one kernel launch per batched evaluation."""
    import warnings

    from chip_smoke import LOC, build_loc64_problem
    from waveform_ot_torch.inversion import loc_cmt_misfit, minimize_lbfgs_batched

    dev = torch.device("cuda")
    _, cfg, prob = build_loc64_problem(4, torch.float32, dev)
    starts = torch.tensor(LOC, device=dev) + torch.tensor(
        [[3.0, -2.0, 1.0], [-4.0, 1.0, 2.0], [1.0, 4.0, -3.0]], device=dev)
    calls = {"value": 0, "value_grad": 0}

    def fun(ms):
        calls["value_grad" if torch.is_grad_enabled() else "value"] += 1
        return loc_cmt_misfit(ms, prob, InvOptions(), cfg)

    torch.cuda.synchronize()
    before = cuda_distance.LAUNCHES
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = minimize_lbfgs_batched(fun, starts, max_iter=5, tol=0.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    outer = calls["value_grad"] - 1
    assert outer == 5 and res.n_iter.tolist() == [5, 5, 5]
    # the fifth outer check is skipped (it == max_iter); each of the 5 line
    # searches reads one flag per trial and one that ends it
    assert len(syncs) == outer + calls["value"] + outer, syncs
    assert cuda_distance.LAUNCHES - before == calls["value"] + calls["value_grad"]


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


# -- the layered f-k physics ------------------------------------------------
# Card against CPU, float64: the stack algebra cancels digits where the
# synthesis frequency nears 0 (tests/test_torch_layered.py), so the card's
# other order of rounding (FMA, its exp and division) moves the seismograms
# by ~4e-8 of the peak at the production damping 0.023 and by ~7e-9 at 0.1,
# where these tests hold them (bars 1e-7).
LAYERED_ALPHA = 0.1
LAYERED_CARD_TOL = 1e-7


def _layered_setup(dev, dtype):
    """Three stations on a 60 km circle, the Fukuoka model, nt 33, nk 32:
    (forward, stages, cfg, problem with data from the forward at LOC)."""
    from chip_smoke import LOC
    from waveform_ot_torch.inversion import TraceConfig, build_loc_cmt_problem
    from waveform_ot_torch.models import (
        StationSet, fukuoka_model, make_layered_forward, make_layered_stages,
        moment_tensor_from_sdr,
    )

    ang = np.linspace(0, 2 * np.pi, 3, endpoint=False)
    arr = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    st = StationSet(x=arr(60.0 * np.cos(ang)), y=arr(60.0 * np.sin(ang)))
    mxyz = moment_tensor_from_sdr(30.0, 60.0, 45.0, m0=5.0e6, device=dev).to(dtype)
    kw = dict(model=fukuoka_model(device=dev), nt=33, dt=1.0, nk=32, kmax=1.5,
              alpha_damp=LAYERED_ALPHA)
    fwd = make_layered_forward(st, **kw)
    with torch.no_grad():
        obs = fwd(*arr(LOC), mxyz)
    cfg = TraceConfig(nu=15, ntg=33, lambdav=0.04, q=None, p=2)
    prob = build_loc_cmt_problem(arr(np.arange(33.0)), obs, st, cfg, mxyz_fixed=mxyz)
    return fwd, make_layered_stages(**kw), cfg, prob


def test_layered_f64_on_card_matches_cpu():
    """Seismograms of three sources and the layered misfit's value and
    gradient at them, float64, card vs CPU: within LAYERED_CARD_TOL (of the
    peak, relative, of max |g|); one kernel launch on the card, none on the
    CPU."""
    from chip_smoke import LOC

    res = []
    for dev in (torch.device("cuda"), torch.device("cpu")):
        fwd, _, cfg, prob = _layered_setup(dev, torch.float64)
        ms = torch.tensor(LOC, dtype=torch.float64, device=dev) + torch.tensor(
            [[4.0, -3.0, 2.0], [-6.0, 1.0, 3.0], [0.5, 7.0, -2.0]], dtype=torch.float64,
            device=dev)
        with torch.no_grad():
            s = fwd(ms[:, 0], ms[:, 1], ms[:, 2], prob.mxyz_fixed)
        before = cuda_distance.LAUNCHES
        v, g = loc_cmt_value_and_grad(ms, prob, InvOptions(), cfg, forward=fwd)
        res.append((s.cpu().numpy(), v.cpu().numpy(), g.cpu().numpy(),
                    cuda_distance.LAUNCHES - before))
    (sc, vc, gc, nc), (sh, vh, gh, nh) = res
    assert nc == 1 and nh == 0
    dev = {"seis": np.abs(sc - sh).max() / np.abs(sh).max(),
           "value": (np.abs(vc - vh) / np.abs(vh)).max(),
           "grad": max(np.abs(a - b).max() / np.abs(b).max() for a, b in zip(gc, gh))}
    assert max(dev.values()) <= LAYERED_CARD_TOL, dev


def test_layered_paths_launch_the_kernel_once():
    """At the bench's width (11 stations, nk 512, float32): one launch per
    layered value+grad and per layered_misfit_grid call, one per chunk with
    ``xy_chunk``."""
    from chip_smoke import DM, build_layered_problem
    from waveform_ot_torch.inversion import layered_misfit_grid

    loc, cfg, prob, fwd, stages = build_layered_problem(torch.float32, torch.device("cuda"))
    counts = []
    for call in (
            lambda: loc_cmt_value_and_grad(loc + torch.tensor(DM, device=loc.device), prob,
                                           InvOptions(), cfg, forward=fwd),
            lambda: layered_misfit_grid(loc.new_tensor([8.0, 15.0]), loc.new_tensor(
                [[-4.0, 3.0], [5.0, -2.0], [0.0, 1.0]]), prob, InvOptions(), cfg, stages),
            lambda: layered_misfit_grid(loc.new_tensor([8.0, 15.0]), loc.new_tensor(
                [[-4.0, 3.0], [5.0, -2.0], [0.0, 1.0]]), prob, InvOptions(), cfg, stages,
                xy_chunk=2)):
        before = cuda_distance.LAUNCHES
        out = call()
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(o).all()) for o in out)
        counts.append(cuda_distance.LAUNCHES - before)
    assert counts == [1, 1, 2]


def test_layered_forward_ignores_the_tf32_switch():
    """The Bessel-wavenumber contraction is a float64 product, so float32
    seismograms at the bench's width are the same bit for bit with TF32
    matrix products allowed and not."""
    from chip_smoke import build_layered_problem

    loc, _, prob, fwd, _ = build_layered_problem(torch.float32, torch.device("cuda"))
    ms = loc + torch.tensor(np.random.default_rng(3).uniform(-8, 8, (8, 3)),
                            dtype=torch.float32, device=loc.device)
    prev = torch.backends.cuda.matmul.allow_tf32
    out = []
    try:
        for allow in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = allow
            with torch.no_grad():
                out.append(fwd(ms[:, 0], ms[:, 1], ms[:, 2], prob.mxyz_fixed))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert torch.equal(out[0], out[1])


def test_layered_forward_of_64_sources_equals_single_calls():
    """make_layered_forward on k = 64 sources, each with its own moment
    tensor, float64: every lane within 1e-10 of its single-source call's
    peak (the same elementwise arithmetic per lane)."""
    from chip_smoke import LOC

    dev = torch.device("cuda")
    fwd, _, _, prob = _layered_setup(dev, torch.float64)
    rng = np.random.default_rng(4)
    xyz = torch.tensor(LOC + rng.uniform(-10, 10, (64, 3)), device=dev)
    xyz[:, 2] = xyz[:, 2].abs() + 0.5
    mm = prob.mxyz_fixed * torch.tensor(1 + 0.1 * rng.standard_normal((64, 1, 1)), device=dev)
    with torch.no_grad():
        u = fwd(xyz[:, 0], xyz[:, 1], xyz[:, 2], mm)
        for i in range(64):
            u1 = fwd(xyz[i, 0], xyz[i, 1], xyz[i, 2], mm[i])
            assert (u[i] - u1).abs().max() <= 1e-10 * u1.abs().max(), i


def _rf_fingerprints(dev, nt=120, nu=60, ntg=80):
    """The fingerprints (pdf, pos) of a waveform and its delayed copy
    (predicted, observed), computed on ``dev``, and the observed waveformFP."""
    from waveform_ot_torch import compat

    t = np.linspace(0.0, 1.0, nt)
    waves = [2 * np.sin((t - s) * 6 * np.pi) - 3 * np.cos((2 * (t - s) + 0.3) * 2 * np.pi)
             for s in (0.02, 0.0)]
    grid = (0.0, 1.0, -6.5, 6.5, nu, ntg)
    fps = []
    for w in waves:
        wf = compat.waveformFP(t, w, grid, device=dev)
        wf.calcpdf(lambdav=0.04)
        fps.append(wf)
    return [(wf.pdf, wf.pos) for wf in fps], fps[1]


def test_calcpdf_launches_the_kernel_once_and_matches_the_plain_field():
    from waveform_ot_torch.ops.fingerprint import grid_axes

    before = cuda_distance.LAUNCHES
    _, wf = _rf_fingerprints("cuda")
    assert cuda_distance.LAUNCHES == before + 2        # one per calcpdf
    tg, ug = grid_axes(wf._t, wf._win, wf._spec)
    plain = tfp.distance_field_torch(wf._pn[None].contiguous(), tg[None].contiguous(),
                                     ug[None].contiguous())
    for x, y in zip(wf._fld, plain):
        assert torch.equal(x, y[0])


def test_toolbox_on_card_matches_cpu():
    """Marginal and sliced Wasserstein (closed forms: 1e-9 relative) and the
    dense Sinkhorn (iterated: 1e-8), card vs CPU on the card's fingerprints,
    chip_smoke.py phase 12's bars."""
    from waveform_ot_torch import compat

    fps, _ = _rf_fingerprints("cuda")
    card = [compat.OTpdf(fp, "cuda") for fp in fps]
    cpu = [compat.OTpdf(fp, "cpu") for fp in fps]
    calls = [
        (lambda s, o: compat.MargWasserstein(s, o, derivatives=True, returnmargW=True), 1e-9),
        (lambda s, o: compat.SlicedWasserstein(s, o, 10, derivatives=True), 1e-9),
        (lambda s, o: compat.Sinkhorn_MS(s, o, gamma=2e-3, maxiters=300), 1e-8),
    ]
    for call, tol in calls:
        assert _nested_dev(call(*card), call(*cpu)) <= tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gaussian_filter_ignores_the_tf32_switches(dtype):
    """The blur is float64 band-matrix products: neither cuDNN's nor
    cuBLAS's TF32 switch changes a bit of it."""
    from waveform_ot_torch.ops.sinkhorn import gaussian_filter

    img = torch.rand(300, 200, dtype=dtype, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(3))
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    out = []
    try:
        for flag in (False, True):
            torch.backends.cudnn.allow_tf32 = flag
            torch.backends.cuda.matmul.allow_tf32 = flag
            out.append(gaussian_filter(img, 6.5))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert torch.equal(out[0], out[1])
    ref = gaussian_filter(img.cpu().double(), 6.5).numpy()
    assert _nested_dev(out[0].double().cpu().numpy(), ref) <= (
        1e-12 if dtype == torch.float64 else 1e-6)


@pytest.mark.parametrize("chunk", [None, 1 << 12])
def test_distance_field_nn_on_card_equals_cpu(monkeypatch, chunk):
    """The vertex-NN field, chunked over grid points, and NNsearch's
    refinement (ni=2): winners, lam and offsets equal the CPU's bit for bit.
    d is sqrt(dsq) of the same dsq: on the card exactly NumPy's correctly
    rounded square root; the CPU's float64 torch.sqrt (its AVX-512 path) is
    not correctly rounded and may sit one ulp away."""
    from waveform_ot_torch import compat

    if chunk is not None:
        monkeypatch.setattr(tfp, "_PAIRS_PER_CHUNK", chunk)
    args = _inputs(3, 90, 41, 57, torch.float64, seed=9)
    got = tfp.distance_field_nn(*args)
    ref = tfp.distance_field_nn(*(a.cpu() for a in args))
    for x, y in zip(got[1:], ref[1:]):
        assert torch.equal(x.cpu(), y)
    dvec = ref.dvec.numpy()
    d = got.d.cpu().numpy()
    np.testing.assert_array_equal(d, np.sqrt(dvec[..., 0] * dvec[..., 0]
                                             + dvec[..., 1] * dvec[..., 1]))
    np.testing.assert_allclose(d, ref.d.numpy(), rtol=np.finfo(np.float64).eps, atol=0)
    t = np.linspace(0.0, 1.0, 90)
    w = np.sin(9 * t)
    nn = [compat.NNsearch(compat.waveformFP(t, w, (0.0, 1.0, -1.3, 1.3, 41, 57), device=d),
                          ni=2) for d in ("cuda", "cpu")]
    np.testing.assert_allclose(nn[0][0], nn[1][0], rtol=np.finfo(np.float64).eps, atol=0)
    for x, y in zip(nn[0][1:], nn[1][1:]):
        np.testing.assert_array_equal(x, y)


def test_zoom_solver_launches_once_per_trial():
    """minimize_multi_start(method="zoom") on the card: every zoom trial is
    one batched value+grad call and one kernel launch (no value-only calls),
    and the solver reads the device once per outer check and once per
    line-search check: over 4 outer iterations (tol 0 keeps every lane
    active), 5 outer reads and, per line search, one per trial and one that
    ends it; counted by torch's sync debug mode."""
    import warnings

    from chip_smoke import LOC, build_loc64_problem
    from waveform_ot_torch.inversion import loc_cmt_misfit, minimize_multi_start

    dev = torch.device("cuda")
    _, cfg, prob = build_loc64_problem(4, torch.float32, dev)
    starts = torch.tensor(LOC, device=dev) + torch.tensor(
        [[3.0, -2.0, 1.0], [-4.0, 1.0, 2.0], [1.0, 4.0, -3.0]], device=dev)
    calls = {"value": 0, "value_grad": 0}

    def fun(ms):
        calls["value_grad" if torch.is_grad_enabled() else "value"] += 1
        return loc_cmt_misfit(ms, prob, InvOptions(), cfg)

    torch.cuda.synchronize()
    before = cuda_distance.LAUNCHES
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = minimize_multi_start(fun, starts, max_iter=4, tol=0.0, method="zoom")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    trials = calls["value_grad"] - 1                 # the first call is the starts'
    assert calls["value"] == 0 and res.n_iter.tolist() == [4, 4, 4] and res.ls_failed is None
    assert len(syncs) == (4 + 1) + (trials + 4), syncs
    assert cuda_distance.LAUNCHES - before == calls["value_grad"]


def test_calcpdf_fmm_on_card_matches_cpu():
    """calcpdf(method="FMM") on a card object: no kernel launch (the field is
    host C++), the field and pdf within 1e-12 of the CPU object's."""
    from waveform_ot_torch import compat

    t = np.linspace(0.0, 1.0, 120)
    w = 2 * np.sin(6 * np.pi * t) - 3 * np.cos((2 * t + 0.3) * 2 * np.pi)
    grid = (0.0, 1.0, -6.5, 6.5, 60, 80)
    before = cuda_distance.LAUNCHES
    card, cpu = (compat.waveformFP(t, w, grid, device=d) for d in ("cuda", "cpu"))
    card.calcpdf(lambdav=0.04, method="FMM")
    assert cuda_distance.LAUNCHES == before and card.type == "FMM"
    cpu.calcpdf(lambdav=0.04, method="FMM")
    np.testing.assert_allclose(card.dfield, cpu.dfield, rtol=0, atol=1e-12)
    np.testing.assert_allclose(card.pdf, cpu.pdf, rtol=0, atol=1e-12)


def _card_mesh(n=4):
    from waveform_ot_torch import parallel as par

    return par.make_mesh(n, device="cuda:0")


def test_mesh_without_device_takes_the_cards():
    from waveform_ot_torch import parallel as par

    mesh = par.make_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i)
                                 for i in range(torch.cuda.device_count()))
    with pytest.raises(ValueError, match="need"):
        par.make_mesh(torch.cuda.device_count() + 1)


def test_trace_sharded_loc_cmt_on_4_shards_of_one_card():
    """pjit_batched_misfit over 4 shards of cuda:0, 8 stations (2 per shard),
    float64: one launch per shard, value 1e-12 and gradient 1e-11 of max |g|
    from the unsharded call on the card."""
    from chip_smoke import DM, build_loc64_problem
    from waveform_ot_torch import parallel as par
    from waveform_ot_torch.inversion import loc_cmt_misfit

    dev = torch.device("cuda", 0)
    loc, cfg, prob = build_loc64_problem(8, torch.float64, dev)
    m = loc + torch.tensor(DM, dtype=torch.float64, device=dev)
    v0, g0 = loc_cmt_value_and_grad(m, prob, InvOptions(), cfg)
    mesh = _card_mesh()
    f = par.pjit_batched_misfit(lambda mm, pp: loc_cmt_misfit(mm, pp, InvOptions(), cfg), mesh)
    mt = m.clone().requires_grad_(True)
    before = cuda_distance.LAUNCHES
    v1 = f(mt, par.shard_leading_axis(prob, mesh))
    (g1,) = torch.autograd.grad(v1, mt)
    assert cuda_distance.LAUNCHES - before == 4 and v1.device == dev
    assert abs(v1.item() - v0.item()) <= 1e-12 * abs(v0.item())
    assert (g1 - g0).abs().max().item() <= 1e-11 * g0.abs().max().item()


def test_node_and_start_sharded_on_4_shards_of_one_card():
    """misfit_grid_sharded (8 nodes, 2 per shard, one launch each) equals
    misfit_grid on the card at 1e-12, float64; minimize_multi_start_sharded
    on 8 starts takes one launch per shard per evaluation and ends where the
    unsharded solve does: the same n_iter per lane, x within 1e-8 (the
    backward's float64 atomics sum in another order each run, and the solve
    carries that to 1.1e-10 in x)."""
    from chip_smoke import LOC, build_loc64_problem
    from waveform_ot_torch.inversion import (
        loc_cmt_misfit, minimize_lbfgs_batched, misfit_grid, misfit_grid_sharded,
        minimize_multi_start_sharded,
    )

    dev = torch.device("cuda", 0)
    _, cfg, prob = build_loc64_problem(4, torch.float64, dev)
    ms = torch.tensor(LOC, dtype=torch.float64, device=dev) + torch.as_tensor(
        np.random.default_rng(3).uniform(-8, 8, (8, 3)), device=dev)
    mesh = _card_mesh()
    before = cuda_distance.LAUNCHES
    got = misfit_grid_sharded(ms, prob, InvOptions(), cfg, mesh)
    assert cuda_distance.LAUNCHES - before == 4 and len(got.parts) == 4
    ref = misfit_grid(ms, prob, InvOptions(), cfg)
    assert ((got.gather() - ref).abs() / ref.abs()).max().item() <= 1e-12
    calls = []

    def fun(x):
        calls.append(x.shape[0])
        return loc_cmt_misfit(x, prob, InvOptions(), cfg)

    before = cuda_distance.LAUNCHES
    res = minimize_multi_start_sharded(fun, ms, mesh, max_iter=15, tol=1e-6).gather()
    assert cuda_distance.LAUNCHES - before == len(calls) and set(calls) == {2}
    un = minimize_lbfgs_batched(fun, ms, max_iter=15, tol=1e-6)
    assert torch.equal(res.n_iter, un.n_iter)
    assert (res.x - un.x).abs().max().item() <= 1e-8


def test_grid_and_dp_sp_sharded_on_one_card():
    """120x200 fingerprints of 300-sample polylines, float64: the
    grid-sharded misfit of one polyline over 4 shards of cuda:0 and dp x sp
    of two on a (2, 2) mesh of it, one launch per shard, value 1e-12 and
    gradient 1e-11 of max |g| from the unsharded pipeline on the card."""
    from waveform_ot_torch import parallel as par
    from waveform_ot_torch.ops import Density1D, make_density_1d
    from waveform_ot_torch.ops.marginal import marg_wasserstein_value

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    t = np.linspace(0.0, 1.0, 300)
    arr = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    verts = arr(np.stack([np.broadcast_to(t, (2, 300)), 0.5 + 0.3 * np.sin(
        6 * t[None] + rng.standard_normal((2, 1)))], -1))
    tgrid, ugrid = arr(np.linspace(0.0, 1.0, 200)), arr(np.linspace(0.0, 1.0, 120))
    tt = make_density_1d(arr(rng.random(200) + 0.1), tgrid)
    tu = make_density_1d(arr(rng.random(120) + 0.1), ugrid)
    rows = lambda d, k: Density1D(*(a.expand(k, *a.shape) for a in d))

    def plain(v):
        k = v.shape[0]
        u2d = tfp.density_from_distance(tfp.distance_field_diff(
            v, tgrid.expand(k, 200), ugrid.expand(k, 120)), 0.04)
        wt, wu = marg_wasserstein_value(u2d, tgrid.expand(k, 200), ugrid.expand(k, 120),
                                        rows(tt, k), rows(tu, k))
        return (0.5 * wt + 0.5 * wu).sum()

    def vg(fn, v):
        v = v.clone().requires_grad_(True)
        before = cuda_distance.LAUNCHES
        out = fn(v)
        (g,) = torch.autograd.grad(out, v)
        return out.item(), g, cuda_distance.LAUNCHES - before

    mesh = _card_mesh()
    fn = par.grid_sharded_marg_misfit(mesh, lambdav=0.04)
    tg = par.shard_grid_axis(tgrid, mesh)
    one = verts[0]
    v0, g0, n0 = vg(lambda v: plain(v[None]), one)
    v1, g1, n1 = vg(lambda v: sum(0.5 * w for w in fn(v, tg, ugrid, tt, tu, 0.0)), one)
    mesh2 = par.make_mesh_2d(2, 2, device="cuda:0")
    dp = par.dp_sp_marg_misfit(mesh2, lambdav=0.04)
    tg2 = par.shard_grid_axis(tgrid, mesh2, axis_name="seq")
    v2, g2, n2 = vg(plain, verts)
    v3, g3, n3 = vg(lambda v: dp(v, tg2, ugrid, rows(tt, 2), rows(tu, 2),
                                 torch.zeros(2, device=dev, dtype=v.dtype)), verts)
    assert (n0, n1, n2, n3) == (1, 4, 1, 4)
    for (v, g), (vr, gr) in (((v1, g1), (v0, g0)), ((v3, g3), (v2, g2))):
        assert abs(v - vr) <= 1e-12 * abs(vr)
        assert (g - gr).abs().max().item() <= 1e-11 * gr.abs().max().item()
