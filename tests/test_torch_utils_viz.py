"""The port's ``utils/io``, ``viz`` and the plotting surface of ``compat``,
``compat_ricker`` and ``compat_loc_cmt`` on the CPU: pickle and JSON files
that one package writes the other reads, checkpoints through
``torch.save``, and every plot function drawn once under matplotlib's Agg
backend from tensors, its file written (and, where a wrapper returns
numbers, those numbers against the JAX package's).
"""

import json
import pickle
import time

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg", force=True)

import waveform_ot_torch  # noqa: E402
import waveform_ot_tpu  # noqa: E402
from waveform_ot_torch import compat as tc  # noqa: E402
from waveform_ot_torch import compat_loc_cmt as tlc  # noqa: E402
from waveform_ot_torch import compat_ricker as tru  # noqa: E402
from waveform_ot_torch import viz  # noqa: E402
from waveform_ot_torch.ops import fmm as tfmm  # noqa: E402
from waveform_ot_torch.ops.fingerprint import DistanceField  # noqa: E402
from waveform_ot_torch.ops.otpdf import make_density_1d  # noqa: E402
from waveform_ot_torch import utils  # noqa: E402
from waveform_ot_torch.utils import io, profiling  # noqa: E402
from waveform_ot_tpu import compat as jc  # noqa: E402
from waveform_ot_tpu import compat_loc_cmt as jlc  # noqa: E402
from waveform_ot_tpu.ops.fmm import signed_indicator  # noqa: E402
from waveform_ot_tpu import utils as jutils  # noqa: E402
from waveform_ot_tpu.utils import io as jio  # noqa: E402

CPU = "cpu"
F64 = torch.float64
NAMES = ["w2", "model", "trace", "label"]


def _payload():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(3, 4)), np.arange(5.0), [0.5, 1.5], "run-1"]


def _same(a, b):
    if isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# utils/io
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("fmt", ["pickle", "json"])
def test_named_arrays_round_trip_across_packages(tmp_path, fmt, writer, reader):
    """A dict of named NumPy payloads written by one package's io and read
    by the other's (or its own) comes back equal; the JSON reader reads
    JSON, not a pickle."""
    mods = {"port": io, "jax": jio}
    path = tmp_path / f"bundle.{fmt}"
    data = _payload()
    getattr(mods[writer], f"write_{fmt}")(path, NAMES, data)
    out = getattr(mods[reader], f"read_{fmt}")(path)
    assert list(out) == NAMES
    for k, v in zip(NAMES, data):
        _same(out[k], v)
    if fmt == "json":
        assert json.loads(path.read_text()) == out


def test_tensors_are_written_as_numpy(tmp_path):
    """Tensors (any device) go into the files as NumPy arrays and lists, so
    the JAX package and plain pickle/json read them."""
    t = torch.arange(6, dtype=F64).reshape(2, 3)
    io.write_pickle(tmp_path / "a.pkl", ["t"], [t])
    with open(tmp_path / "a.pkl", "rb") as fh:
        got = pickle.load(fh)["t"]
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, t.numpy())
    io.write_json(tmp_path / "a.json", ["t"], [t])
    assert jio.read_json(tmp_path / "a.json") == {"t": t.tolist()}


def test_checkpoint_round_trip(tmp_path):
    """save_checkpoint/restore_checkpoint keep the JAX package's step_{n}
    layout; tensors, NumPy arrays and containers come back equal under
    weights_only loading, and a template casts the leaves."""
    tree = {"x": torch.arange(3, dtype=F64), "h": [np.ones(2), np.float64(2.5)],
            "n": 7, "s": (np.arange(3, dtype=np.int32),)}
    io.save_checkpoint(tmp_path / "ck", tree, step=4)
    assert (tmp_path / "ck" / "step_4" / "checkpoint.pt").is_file()
    out = io.restore_checkpoint(tmp_path / "ck", step=4)
    assert torch.equal(out["x"], tree["x"]) and out["n"] == 7
    _same(out["h"][0], tree["h"][0])
    assert out["h"][1] == 2.5 and out["s"][0].dtype == np.int32
    io.save_checkpoint(tmp_path / "ck2", {"x": np.arange(3.0)})
    cast = io.restore_checkpoint(tmp_path / "ck2",
                                 template={"x": torch.zeros(3, dtype=torch.float32)})
    assert cast["x"].dtype == torch.float32 and cast["x"].tolist() == [0.0, 1.0, 2.0]


def test_save_checkpoint_takes_pytree_like_jax(tmp_path):
    """save_checkpoint's tree parameter is ``pytree``, as the JAX package's:
    the same keyword call on the same seeded NumPy tree writes a checkpoint
    each package restores equal to the tree (exactly)."""
    rng = np.random.default_rng(11)
    tree = {"m": rng.normal(size=4), "state": {"h": rng.normal(size=(2, 3))}}
    for mod, where in ((io, "port"), (jio, "jax")):
        mod.save_checkpoint(tmp_path / where, pytree=tree, step=2)
    got = io.restore_checkpoint(tmp_path / "port", step=2)
    ref = jio.restore_checkpoint(tmp_path / "jax", tree, step=2)
    for out in (got, ref):
        _same(out["m"], tree["m"])
        _same(out["state"]["h"], tree["state"]["h"])


def test_read_pickle_matches_jax(tmp_path):
    """A pickle written by plain ``pickle.dump`` (as the reference's
    writepickle does) reads back the same through both packages."""
    rng = np.random.default_rng(12)
    data = {"w2": rng.normal(size=(3, 2)), "trace": [0.5, 1.5], "label": "run-2"}
    path = tmp_path / "ref.pickle"
    with open(path, "wb") as fh:
        pickle.dump(data, fh)
    got, ref = io.read_pickle(path), jio.read_pickle(path)
    assert list(got) == list(ref) == list(data)
    for k in data:
        _same(got[k], ref[k])


def test_compat_io_wrappers(tmp_path):
    """compat_ricker's writepickle/readpickle/writejson/readjson and
    compat_loc_cmt's writepickle/readpickle."""
    data = _payload()
    for mod, fmts in ((tru, ("pickle", "json")), (tlc, ("pickle",))):
        for fmt in fmts:
            path = tmp_path / f"{mod.__name__}.{fmt}"
            getattr(mod, f"write{fmt}")(path, NAMES, data)
            out = getattr(mod, f"read{fmt}")(path)
            for k, v in zip(NAMES, data):
                _same(out[k], v)


# ---------------------------------------------------------------------------
# utils.profiling
# ---------------------------------------------------------------------------


def test_stage_timer_sums_repeated_stages():
    """A stage timed twice holds the sum of both spans; stop() without a
    running stage changes nothing."""
    timer = profiling.StageTimer()
    spans = []
    for name in ("fp", "ot", "fp"):
        timer.start(name)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 2e-3:
            pass
        spans.append((name, timer.stop()[name]))
    stages = timer.stop()
    assert set(stages) == {"fp", "ot"}
    assert stages["fp"] > spans[0][1] >= 2e-3 and stages["ot"] >= 2e-3
    for name in ("StageTimer", "benchmark", "top_device_ops"):    # JAX's utils exports
        assert getattr(utils, name) is getattr(profiling, name) and hasattr(jutils, name)


def test_benchmark_is_positive_and_calls_as_asked():
    """benchmark times n_iter calls after warmup calls, on the CPU without a
    synchronize, and returns seconds per call."""
    calls = []
    x = torch.linspace(0.0, 1.0, 4096, dtype=F64)
    sec = utils.benchmark(lambda a: calls.append(1) or torch.sin(a).sum(), x, n_iter=7, warmup=2)
    assert sec > 0.0 and len(calls) == 9


def test_timed_and_device_label_on_the_cpu():
    """timed returns the call's result and its host-clock seconds (no card
    here, so no synchronize); device_label names the CPU "cpu"."""
    out, sec = profiling.timed(lambda a: a * 2, 21)
    assert out == 42 and sec >= 0.0
    assert profiling.device_label("cpu") == profiling.device_label(torch.device("cpu")) == "cpu"


def test_top_device_ops_names_real_operators():
    """On the CPU the ranking is by the operators' self time: names of aten
    operators, times positive and descending, at most ``top`` of them."""
    a = torch.randn(96, 96, dtype=F64)
    top = utils.top_device_ops(lambda m: torch.sin(m @ m).sum(), a, top=3)
    assert 1 <= len(top) <= 3
    names = [name for _, name in top]
    assert "aten::mm" in names and all(n.startswith("aten::") for n in names)
    times = [ms for ms, _ in top]
    assert times == sorted(times, reverse=True) and times[-1] > 0.0


def test_top_device_ops_leaves_its_trace_in_trace_dir(tmp_path):
    """With ``trace_dir`` the profiled call's trace is left there, as the
    JAX package's top_device_ops leaves its jax.profiler trace: a non-empty
    torch.profiler Chrome trace naming the call's operators, beside the
    same kind of ranking as without it (the same operators, descending
    times)."""
    a = torch.randn(64, 64, dtype=F64, generator=torch.Generator().manual_seed(3))
    fn = lambda m: torch.sin(m @ m).sum()
    plain = utils.top_device_ops(fn, a, top=100)
    traced = utils.top_device_ops(fn, a, top=100, trace_dir=tmp_path / "trace")
    assert {n for _, n in traced} == {n for _, n in plain}
    times = [ms for ms, _ in traced]
    assert times == sorted(times, reverse=True)
    files = list((tmp_path / "trace").iterdir())
    assert [f.name.startswith("torch_profiler_") and f.name.endswith(".pt.trace.json")
            for f in files] == [True]
    assert "aten::mm" in {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    jutils.top_device_ops(jax.jit(lambda m: jnp.sin(m @ m).sum()), jnp.asarray(a.numpy()),
                          top=100, trace_dir=tmp_path / "jax")
    assert [f for f in (tmp_path / "jax").rglob("*") if f.is_file() and f.stat().st_size]


def test_package_binds_utils_and_pyprop8_bridge():
    """``waveform_ot_torch.utils`` and ``waveform_ot_torch.models.pyprop8_bridge``
    are bound, as the JAX package binds its own, and are the port's modules."""
    for top in (waveform_ot_torch, waveform_ot_tpu):
        assert top.utils.__name__ == f"{top.__name__}.utils"
        assert top.models.pyprop8_bridge.__name__ == f"{top.__name__}.models.pyprop8_bridge"


# ---------------------------------------------------------------------------
# viz
# ---------------------------------------------------------------------------


def _density(shift):
    x = torch.linspace(0.0, 1.0, 40, dtype=F64)
    return make_density_1d(torch.exp(-((x - 0.4 - shift) / 0.1) ** 2), x)


def _field():
    gen = torch.Generator().manual_seed(0)
    verts = torch.stack([torch.linspace(0, 1, 12, dtype=F64),
                         0.5 + 0.3 * torch.sin(torch.linspace(0, 6, 12, dtype=F64))], 1)
    tg, ug = torch.linspace(0, 1, 10, dtype=F64), torch.linspace(0, 1, 8, dtype=F64)
    fld = DistanceField(d=torch.rand(8, 10, dtype=F64, generator=gen),
                        iclose=torch.randint(0, 11, (8, 10), dtype=torch.int32, generator=gen),
                        lam=torch.rand(8, 10, dtype=F64, generator=gen),
                        dvec=torch.zeros(8, 10, 2, dtype=F64))
    return verts, tg, ug, fld


def _viz_calls():
    verts, tg, ug, fld = _field()
    gen = torch.Generator().manual_seed(1)
    seis = torch.randn(2, 3, 16, dtype=F64, generator=gen)
    tt = torch.arange(16.0, dtype=F64)
    xg, yg = np.meshgrid(np.linspace(-2, 2, 6), np.linspace(-2, 2, 6))
    slices = torch.tensor(np.array([np.hypot(xg - k / 4, yg) + 1.0 for k in range(4)]))
    return {
        "plot_wasser_panels": lambda f: viz.plot_wasser_panels(_density(0.0), _density(0.2),
                                                               npoints=50, filename=f),
        "plot_transport_plan": lambda f: viz.plot_transport_plan(
            torch.rand(5, 6, dtype=F64, generator=gen), filename=f),
        "plot_fingerprint": lambda f: viz.plot_fingerprint(fld.d, verts, tg, ug, levels=5,
                                                           filename=f, title="fp"),
        "plot_rays": lambda f: viz.plot_rays(fld, verts, tg, ug, stride=9, filename=f),
        "plot_marginals": lambda f: viz.plot_marginals(fld.d, tg, ug, filename_prefix=f),
        "plot_transport_frames": lambda f: viz.plot_transport_frames(_density(0.0),
                                                                     _density(0.2), nframes=3,
                                                                     filename=f),
        "plot_misfit_trace": lambda f: viz.plot_misfit_trace(torch.tensor([3.0, 2.0, 1.0]),
                                                             second=[2.0, 1.5, 1.2],
                                                             filename=f),
        "plot_misfit_profiles": lambda f: viz.plot_misfit_profiles(
            torch.linspace(-1, 1, 5), [torch.arange(5.0), np.arange(5.0) ** 2], ["W2", "L2"],
            title="p", filename=f),
        "plot_seismograms": lambda f: viz.plot_seismograms(seis, tt, overlays=[seis * 0.5],
                                                           filename=f, title="s"),
        "plot_misfit_surface": lambda f: viz.plot_misfit_surface(
            slices[0], np.linspace(-2, 2, 6), np.linspace(-2, 2, 6), xtrue=torch.tensor(0.0),
            ytrue=0.0, filename=f),
        "plot_density_surface": lambda f: viz.plot_density_surface(
            fld.d, tg, ug, ridge_t=verts[:, 0], ridge_u=verts[:, 1], filename=f),
        "plot_phi": lambda f: viz.plot_phi(verts[:, 0], verts[:, 1], tg, ug, filename=f),
        "plot_rays_discrete": lambda f: viz.plot_rays_discrete(
            torch.randint(0, 12, (8, 10), generator=gen), verts, tg, ug, phi=torch.ones(8, 10),
            filename=f),
        "plot_two_fingerprints": lambda f: viz.plot_two_fingerprints(
            fld.d, verts, fld.lam, verts, titles=("a", "b"), levels=4, filename=f),
        "plot_rickers": lambda f: viz.plot_rickers(tt, seis[0, 0], tt, seis[0, 1],
                                                   tlim=(0, 15), ulim=(-3, 3), filename=f),
        "plot_waveform_fit": lambda f: viz.plot_waveform_fit(
            tt, seis[0, 0], tt, seis[0, 1], torch.tensor([3.0, 2.0, 1.0]), torch.tensor(1),
            second=torch.tensor([2.0, 1.5, 1.2]), xlim=(0, 15), ylim=(-3, 3), filename=f),
        "plot_misfit_sections": lambda f: viz.plot_misfit_sections(
            slices, xg, yg, torch.tensor([2.0, 4.0, 6.0, 8.0]), 5.0,
            sol=torch.tensor([0.1, 0.2, 5.0]), mistype="L2", ninterp=20, filename=f),
        "plot_misfit_section": lambda f: viz.plot_misfit_section(
            slices[1], xg, yg, ninterp=20, sol=torch.tensor([0.1, 0.2]), title="t", filename=f),
    }


@pytest.mark.parametrize("name", sorted(_viz_calls()))
def test_viz_draws_from_tensors(tmp_path, name):
    """Each viz function draws from tensors (and NumPy) and writes its file."""
    plt = viz._plt()
    out = _viz_calls()[name](str(tmp_path / f"{name}.png"))
    files = list(tmp_path.iterdir())
    assert files and all(f.stat().st_size > 0 for f in files)
    for fig in out if isinstance(out, list) else [out]:
        plt.close(fig)


def test_signed_indicator_matches_jax():
    """plot_phi's default field, ops.fmm.signed_indicator, is the JAX
    package's signed_indicator."""
    verts, tg, ug, _ = _field()
    assert viz.signed_indicator is tfmm.signed_indicator
    np.testing.assert_array_equal(tfmm.signed_indicator(verts[:, 0], verts[:, 1], tg, ug),
                                  signed_indicator(verts[:, 0].numpy(), verts[:, 1].numpy(),
                                                   tg.numpy(), ug.numpy()))


# ---------------------------------------------------------------------------
# compat, compat_ricker and compat_loc_cmt plot wrappers
# ---------------------------------------------------------------------------


def _fingerprints():
    """A 18x20 port fingerprint of a sine and its OTpdf, and a pair of 1-D
    OTpdfs in both packages."""
    t = np.linspace(0.0, 1.0, 25)
    w = np.sin(6.0 * t)
    wf = tc.waveformFP(t, w, (0.0, 1.0, -1.5, 1.5, 18, 20), device=CPU)
    wf.calcpdf(lambdav=0.05, deriv=True)
    x = np.linspace(0.0, 1.0, 30)
    pair = lambda mod, **kw: (mod.OTpdf((np.exp(-((x - 0.4) / 0.1) ** 2), x), **kw),
                              mod.OTpdf((np.exp(-((x - 0.6) / 0.15) ** 2), x), **kw))
    return t, w, wf, tc.OTpdf((wf.pdf, wf.pos), CPU), pair(tc, device=CPU), pair(jc)


def test_compat_plot_wrappers(tmp_path, monkeypatch):
    """Every plot wrapper of compat (the JAX compat's lines 786-1072) draws
    and writes its file; plotOT1D's plan and plot_RF_SDF's axis limits
    equal the JAX package's (1e-12)."""
    monkeypatch.chdir(tmp_path)
    t, w, wf, fp, (src, tgt), (jsrc, jtgt) = _fingerprints()
    f = lambda n: str(tmp_path / f"{n}.png")
    plt = viz._plt()
    fig, axs = plt.subplots(2, 3)
    assert len(tc.trim_axs(axs, 4)) == 4 and len(fig.axes) == 4
    plt.close(fig)
    tq = np.linspace(0, 1, 20)
    tc.plotWasser(tq, tq, tq ** 2, tq, tq, tq ** 2, tq, tq, tq, tq, filename=f("wasser"))
    plan = tc.plotOT1D(src, tgt, filename=f("ot1d"), returnplan=True)
    np.testing.assert_allclose(plan, jc.plotOT1D(jsrc, jtgt, returnplan=True), atol=1e-12)
    tc.plot_optimal_transform_frames(src, tgt, 3, filename=f("frames"))
    tc.plot_optimal_transform_frames(src, tgt, [0.0, 0.5, 1.0], filename=f("frames2"))
    X, Y = np.meshgrid(np.linspace(0, 1, 20), np.linspace(-1.5, 1.5, 18))
    tc.plot_phi(X, Y, np.sign(Y - np.interp(X, t, w)), t, w, (0, 1), (-1.5, 1.5),
                filename=f("phi"))
    tc.plot_LS(wf.dfield, wf, (0, 1), (-1.5, 1.5), "ls", "k", "grey", filename=f("ls"))
    tc.plot_LS(wf.pdf, wf, None, None, "ls", "k", "grey", aspect=True, filename=f("ls2"))
    tc.plot_2LS(wf, wf, "a", "b", "k", "grey", filename=f("2ls"), pdf=True)
    tc.plot_rays(np.arange(0, 360, 37), wf, "rays", "k", "grey", filename=f("rays"))
    tc.plotPDFsurface(wf.pdf, wf.pn[:, 0], wf.pn[:, 1], filename=f("surf"))
    tc.plotMarginals(wf, fp, tag="_t", outdir=str(tmp_path))
    for name in ("Marginal_u_t.png", "Marginal_t_t.png", "Marginals_and_fingerprint_t.pdf"):
        assert (tmp_path / name).stat().st_size > 0
    lims = tc.plot_RF_SDF(t, w, filename=f("rf"))
    np.testing.assert_allclose(lims, jc.plot_RF_SDF(t, w), atol=1e-12)
    q = np.where(np.abs(Y - np.interp(X, t, w)) < 0.2, 1, 0)
    q[0, 0] = 2
    darg = np.zeros(X.shape, int)
    wg = np.interp(np.linspace(0.0, 1.0, 20), t, w)     # the waveform on the grid's columns
    tc.plot_rays_discrete(X, Y, wf.dfield, np.sign(Y), t, wg, (0, 1), (-1.5, 1.5), "d", "k",
                          "grey", darg, q, [(3, 4), (9, 10)], filename=f("discrete"))
    assert len([p for p in tmp_path.iterdir() if p.suffix == ".png"]) >= 14


def test_inversion_module_plot_wrappers(tmp_path):
    """compat_ricker's plot wrappers (plotrickers, plotrickers_special,
    plotsurface, plotmisfit, plotwfit, plotwfit_3panels, plotMarginals) and
    compat_loc_cmt's plotseis and plotmisfitsection, whose interpolated
    contour fields equal the JAX package's (1e-12)."""
    t, w, wf, fp, _, _ = _fingerprints()
    f = lambda n: str(tmp_path / f"{n}.png")
    plt = viz._plt()
    tru.plotrickers(t, w, t, 0.5 * w, tlim=(0, 1), ref=(t, w), clean=True, filename=f("r"))
    plt.figure()
    tru.plotrickers_special(t, w, t, 0.5 * w, tlim=(0, 1), ulim=(-1, 1), ref=[t, w],
                            xlab=True, offset="0.1", clean=True)
    plt.savefig(f("special"))
    plt.close("all")
    tru.plotsurface(np.outer(t, t)[:6, :6], t[:6], t[:6], 0.1, 0.1, filename=f("surf"))
    tru.plotmisfit([3.0, 2.0, 1.0], second=[2.0, 1.0, 0.5], log=True, filename=f("mis"))
    tru.plotwfit(t, w, 0, [wf], [3.0, 2.0, 1.0], 1, None, filename=f("wfit"))
    tru.plotwfit_3panels(t, w, 0, [wf], [3.0, 2.0, 1.0], [1.0, 0.5, 0.2], 2, None, None,
                         filename=f("wfit3"))
    tru.plotMarginals(wf, fp, tag="_r", outdir=str(tmp_path))
    fig = tlc.plotseis(torch.ones(2, 3, 16, dtype=F64), np.arange(16.0),
                       splot0=np.zeros((2, 3, 16)), title="s", filename=f("seis"))
    plt.close(fig)
    fig = tlc.plotseis(np.zeros(16), np.arange(16.0), filename=f("seis1"))
    plt.close(fig)
    xg, yg = np.meshgrid(np.linspace(-2, 2, 6), np.linspace(-2, 2, 6))
    slices = [np.hypot(xg - k / 4, yg) + 1.0 for k in range(4)]
    args = ((-2, 2), (-2, 2), xg, yg, [2.0, 4.0, 6.0, 8.0], 5.0, [0.1, 0.2, 5.0], [slices])
    for mistype in ("OT", "L2"):
        got = tlc.plotmisfitsection(*args, {"mistype": mistype}, [f(f"sec{mistype}")],
                                    returncontfunc=True)
        want = jlc.plotmisfitsection(*args, {"mistype": mistype},
                                     [str(tmp_path / f"jsec{mistype}.png")],
                                     returncontfunc=True)
        np.testing.assert_allclose(got, want, atol=1e-12, equal_nan=True)
    plt.close("all")
    written = [p for p in tmp_path.iterdir() if p.stat().st_size > 0]
    assert len(written) >= 14
