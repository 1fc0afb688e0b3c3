"""Drop-in migration layer for the reference's ``ricker_util`` module on the
PyTorch port (counterpart of waveform_ot_tpu.compat_ricker).

Reference users write ``from libs import ricker_util as ru``; pointing that
import here (``from waveform_ot_torch import compat_ricker as ru``) keeps
their calling code working: every public name of ricker_util.py (the
forward model, window and transform helpers, the OT-object constructor, the
scipy ``optfunc`` and its ``Wdata``/``Wits`` history blackboard, pickle
I/O, the plots) exists with the reference signature. NumPy goes in and
comes out, in float64; in between the numbers are computed in torch on the
card, where every fingerprint is one launch of the distance-field kernel
(``compat.waveformFP.calcpdf``). Functions that make tensors take
``device`` (default "cuda"); the objective and the FD checkers compute on
the device of the observed ``OTpdf`` they are given.

Reference: ricker_util.py:22-426.
"""

from __future__ import annotations

import numpy as np
import torch

from waveform_ot_torch import viz as _viz
from waveform_ot_torch.compat import (
    MargWasserstein, OTpdf, plotMarginals as _fp_plotMarginals, waveformFP,
)
from waveform_ot_torch.models.ricker import (
    ricker as _core_ricker,
    ricker_wavelet as _core_ricker_wavelet,
    ricker_wavelet_noisy as _core_ricker_wavelet_noisy,
    ricker_wavelet_with_jacobian as _core_ricker_wavelet_with_jacobian,
)
from waveform_ot_torch.ops.transforms import arctan_transform
from waveform_ot_torch.utils import io as _io
from waveform_ot_torch.viz import _arr, _plt

# -- optimisation-history blackboard (reference ricker_util_opt.py:9-11) ----

Wdata: list = []
Wits: list = []


def init():
    """Reset the history blackboard (reference ricker_util_opt.init)."""
    global Wdata, Wits
    Wdata = []
    Wits = []


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float64, device=device)


# -- forward model (ricker_util.py:22-89) -----------------------------------


def ricker(f, length=0.128, dt=0.001, deriv=False, device="cuda"):
    out = _core_ricker(_scalar(f, device), length=length, dt=dt, deriv=deriv)
    return tuple(_arr(v) for v in out)


def rickerwavelet(tpert, amp, f, trange=(-2.0, 2.0), sigma_amp=0.0,
                  sigma_cor=0.0, deriv=False, seed=0, removejitter=True,
                  device="cuda"):
    """Double Ricker wavelet + optional GP/white noise + optional analytic
    jacobian (ricker_util.py:38-89). The noise is drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``, so its draws are
    not the JAX package's. ``removejitter=False`` is not carried over (the
    reference default removes it)."""
    if not removejitter:
        raise NotImplementedError(
            "the jittered variant is not reproduced; the reference default "
            "removejitter=True is the supported path")
    m = [_scalar(v, device) for v in (tpert, amp, f)]
    if sigma_amp > 0.0:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        t, w = _core_ricker_wavelet_noisy(gen, *m, trange=trange, sigma_amp=sigma_amp,
                                          sigma_cor=sigma_cor)
    else:
        t, w = _core_ricker_wavelet(*m, trange=trange)
    if deriv:
        t, w2, dw = _core_ricker_wavelet_with_jacobian(*m, trange=trange)
        if sigma_amp == 0.0:
            w = w2
        return _arr(t), _arr(w), _arr(dw)   # dw: (3, nt)
    return _arr(t), _arr(w)


# -- window union / L2 misfit (ricker_util.py:91-103, 341-343) --------------


def datawindowunion(tref, wref, t, w):
    """Interpolate both waveforms onto the union time grid, zero filled
    outside each one's support (ricker_util.py:91-103)."""
    t0 = min(tref[0], t[0])
    t1 = max(tref[-1], t[-1])
    dt = t[1] - t[0]
    tnew = np.linspace(t0, t1, int((t1 - t0) / dt))
    wout1 = np.interp(tnew, _arr(t), _arr(w), left=0.0, right=0.0)
    wout2 = np.interp(tnew, _arr(tref), _arr(wref), left=0.0, right=0.0)
    return wout1, wout2


def LSmisfit(tref, wref, tpred, wpred):
    w1, w2 = datawindowunion(tref, wref, tpred, wpred)
    r = w1 - w2
    return float(np.dot(r, r))


# -- amplitude transform (ricker_util.py:270-275) ---------------------------


def arctan_trans(u, u0, u1, deriv=False, device="cuda"):
    out = arctan_transform(_scalar(_arr(u), device), u0, u1, deriv=deriv)
    if deriv:
        return _arr(out[0]), _arr(out[1])
    return _arr(out)


# -- OT objects (ricker_util.py:204-268) -----------------------------------


def BuildOTobjfromWaveform(t, wave, grid, norm=False, verbose=False,
                           lambdav=None, deriv=False, transform=False,
                           theta=45.0, device="cuda"):
    """waveform -> (waveformFP, OTpdf[, auto grid]) like
    ricker_util.py:204-268: ``norm=True`` derives a padded window from the
    data; ``transform=True`` arctan-squashes amplitudes into (0, 1). The
    fingerprint is one kernel launch on the card."""
    wave = _arr(wave)
    t = _arr(t)
    if norm:
        du = wave.max() - wave.min()
        g6 = (t.min(), t.max(), wave.min() - 0.2 * du,
              wave.max() + 0.2 * du, int(1.3 * len(wave)), len(wave))
    elif transform:
        (t0, t1, u0, u1, nu, ntg) = grid
        wave = arctan_trans(wave, u0, u1, device=device)
        g6 = (t0, t1, 0.0, 1.0, nu, ntg)
    else:
        g6 = tuple(grid)
    wf = waveformFP(t, wave, g6, theta=theta, device=device)
    wf.calcpdf(lambdav=0.04 if lambdav is None else lambdav, deriv=deriv)
    xa, xb = np.meshgrid(np.linspace(wf.tlimn[0], wf.tlimn[1], wf.ntg),
                         np.linspace(0.0, 1.0, wf.nug))
    pos = np.dstack((xa, xb))
    if verbose:
        print(" BuildOTobjfromWaveform: grid", wf.ntg, wf.nug)
    ot = OTpdf((wf.pdf, pos), device)
    if norm:
        return wf, ot, g6
    return wf, ot


# -- misfit wrapper (ricker_util.py:289-339) --------------------------------


def CalcWasserWaveform(wfsource, wftarget, wf, distfunc="W2", deriv=False,
                       returnmarg=False):
    """Marginal Wasserstein between fingerprints + chain rule back to
    waveform amplitudes and window origin time (ricker_util.py:289-339;
    the origin-time derivative carries the 1/(tant*(t1-t0)) rescale of the
    Ricker convention)."""
    if not deriv:
        out = MargWasserstein(wfsource, wftarget, distfunc=distfunc,
                              returnmargW=returnmarg)
        return out if returnmarg else out[0]
    w, dw, dwg = MargWasserstein(wfsource, wftarget, derivatives=True,
                                 distfunc=distfunc, returnmargW=returnmarg)
    scale = wf.tant * (wf.tlim[1] - wf.tlim[0])
    if returnmarg:
        wf.PDFderivMarg(dw)
        return w, wf.pdfdMarg, [dwg[0] / scale, dwg[1] / scale]
    wf.PDFderiv(chainmatrix=dw)
    return w, wf.pdfd, dwg / scale


def CalcWasserWaveform_old(wfsource, wftarget, wf, distfunc="W2",
                           deriv=False, Nproj=10):
    """The reference's deprecated averaged-marginal wrapper
    (ricker_util.py:277-287): like :func:`CalcWasserWaveform` with
    ``returnmarg=False`` but the window derivative is rescaled by the
    window length only (no tan-theta factor)."""
    if not deriv:
        return MargWasserstein(wfsource, wftarget, distfunc=distfunc)[0]
    w, dw, dwg = MargWasserstein(wfsource, wftarget, derivatives=True,
                                 distfunc=distfunc)
    wf.PDFderiv(chainmatrix=dw)
    return w, wf.pdfd, dwg / (wf.tlim[1] - wf.tlim[0])


# -- FD checkers (ricker_util.py:554-606) ------------------------------------


def check_dwduFD(i, t, RF, dufd, grid, lambdav, wfobs_target,
                 transform=False, theta=45.0):
    """Central-difference d(Wt)/du_i, d(Wu)/du_i of the marginal
    Wasserstein distances w.r.t. waveform amplitude ``RF[i]``
    (reference check_dwduFD, ricker_util.py:554-573): perturb by
    ``dufd * RF[i] / 100`` and rebuild the whole fingerprint/OT chain on
    both sides, on the device of ``wfobs_target``."""
    dev = wfobs_target.device
    RFp = np.copy(_arr(RF, float))
    dufdu = dufd * RFp[i] / 100.0
    RFp[i] += dufdu
    wfsp, wfsourcep = BuildOTobjfromWaveform(
        t, RFp, grid, lambdav=lambdav, transform=transform, theta=theta, device=dev)
    w2tp, w2up = CalcWasserWaveform(wfsourcep, wfobs_target, wfsp,
                                    distfunc="W2", returnmarg=True)[0]
    RFm = np.copy(_arr(RF, float))
    RFm[i] -= dufdu
    wfsn, wfsourcen = BuildOTobjfromWaveform(
        t, RFm, grid, lambdav=lambdav, transform=transform, theta=theta, device=dev)
    w2tn, w2un = CalcWasserWaveform(wfsourcen, wfobs_target, wfsn,
                                    distfunc="W2", returnmarg=True)[0]
    return ((w2tp - w2tn) / (2 * dufdu), (w2up - w2un) / (2 * dufdu))


def check_dwdmFD(k, tpred, wpred, dm, mref, grid, lambdav, wfobs_target,
                 trange, transform=False, returnmarg=True, theta=45.0):
    """Central-difference derivative of the (marginal) Wasserstein misfit
    w.r.t. Ricker model parameter ``mref[k]`` through the full
    model -> wavelet -> fingerprint -> OT chain (reference check_dwdmFD,
    ricker_util.py:576-606), on the device of ``wfobs_target``. Returns
    (fd_t, fd_u) under ``returnmarg``, else the averaged fd."""
    dev = wfobs_target.device

    def _w_at(m):
        tw, ww = rickerwavelet(m[0], m[1], m[2], trange=trange, device=dev)
        wfs, wfsource = BuildOTobjfromWaveform(
            tw, ww, grid, lambdav=lambdav, transform=transform, theta=theta, device=dev)
        if returnmarg:
            return CalcWasserWaveform(wfsource, wfobs_target, wfs,
                                      distfunc="W2", returnmarg=True)[0]
        return CalcWasserWaveform(wfsource, wfobs_target, wfs,
                                  distfunc="W2")

    m = np.copy(_arr(mref, float))
    ds = dm * m[k]
    m[k] += ds
    wp = _w_at(m)
    m = np.copy(_arr(mref, float))
    m[k] -= ds
    wn = _w_at(m)
    if returnmarg:
        return ((wp[0] - wn[0]) / (2 * ds), (wp[1] - wn[1]) / (2 * ds))
    return (wp - wn) / (2 * ds)


# -- special plot (ricker_util.py:133-166) -----------------------------------


def plotrickers_special(t1, w1, t2, w2, tlim=(False, False),
                        ulim=(False, False), clean=False,
                        title="Ricker Wavelets", ref=[False, False],
                        xlab=False, offset=""):
    """Wavelet-pair overlay with the reference's exact styling switches
    (ricker_util.py:133-159): optional offset label, grey reference trace,
    tick-free 'clean' mode and the dotted zero line."""
    plt = _plt()
    t1, w1, t2, w2 = map(_arr, (t1, w1, t2, w2))
    if offset == "":
        plt.plot(t1, w1, lw=0.75)
    else:
        plt.plot(t1, w1, lw=0.75, label=offset)
    plt.plot(t2, w2, lw=0.75)
    plt.ylabel("Amplitude")
    if xlab:
        plt.xlabel("Time")
    if tlim[0] is not False:
        plt.xlim(tlim[0], tlim[1])
    if ulim[0] is not False:
        plt.ylim(ulim[0], ulim[1])
    if type(ref[0]) is np.ndarray:
        plt.plot(ref[0], ref[1], color="grey", lw=1.0)
    if clean:
        plt.tick_params(left=False, bottom=False, labelleft=False,
                        labelbottom=False)
    plt.plot([np.min((t1[0], t2[0], tlim[0])),
              np.max((t1[-1], t2[-1], tlim[-1]))], [0.0, 0.0],
             "k:", lw=0.5)


# -- scipy objective (ricker_util.py:373-426) -------------------------------


def optfunc(x, data):
    """The reference's scipy.optimize objective: model -> ricker ->
    fingerprint -> marginal W -> chain rule, on the device of the observed
    OTpdf; appends to ``Wdata`` (ricker_util.py:373-403). data =
    [wfobs_target, distfunc, trange, grid, lambdav, transform, alpha,
    theta]."""
    [wfobs_target, distfunc, trange, grid, lambdav, transform, alpha,
     theta] = data
    dev = wfobs_target.device
    tpos, wpos, dw = rickerwavelet(x[0], x[1], x[2], trange=trange,
                                   deriv=True, device=dev)      # dw: (3, nt)
    wfsp, wfsourcep = BuildOTobjfromWaveform(
        tpos, wpos, grid, lambdav=lambdav, deriv=True, transform=transform,
        theta=theta, device=dev)
    w2M, dr, dgM = CalcWasserWaveform(wfsourcep, wfobs_target, wfsp,
                                      distfunc=distfunc, deriv=True,
                                      returnmarg=True)
    w2 = alpha * w2M[0] + (1 - alpha) * w2M[1]  # eqn 21 weighting
    dg = alpha * dgM[0] + (1 - alpha) * dgM[1]
    dr = [np.asarray(dr[0]), np.asarray(dr[1])]
    if transform:
        _, dundu = arctan_trans(wpos, grid[2], grid[3], deriv=True, device=dev)
        dr[0] = dr[0] * dundu
        dr[1] = dr[1] * dundu
    derivt = dw.dot(dr[0])
    derivu = dw.dot(dr[1])
    deriv = alpha * derivt + (1 - alpha) * derivu
    deriv[0] = dg       # origin-time slot overwritten by window derivative
    Wdata.append([w2, x, wfsp, deriv, wfsourcep])
    return w2, deriv


def recordresult(x):
    """scipy callback recorder (ricker_util.py:407-411)."""
    Wits.append(x)
    print(x)


def findres(Wits_, Wdata_):
    """Match recorded iterates back to objective evaluations
    (ricker_util.py:413-426)."""
    ind = []
    for i in range(len(Wits_)):
        for j in range(len(Wdata_)):
            if np.all(Wits_[i] == Wdata_[j][1]):
                ind.append(j)
    u = np.unique(np.array(ind))
    was = [Wdata_[k][0] for k in u]
    models = [Wdata_[k][1] for k in u]
    waves = [Wdata_[k][2] for k in u]
    return was, models, waves


# -- persistence (ricker_util.py:345-365) -----------------------------------


def writepickle(filename, listOfStr, listOfdata):
    _io.write_pickle(filename, listOfStr, listOfdata)


def readpickle(filename):
    return _io.read_pickle(filename)


def writejson(filename, listOfStr, listOfdata):
    _io.write_json(filename, listOfStr, listOfdata)


def readjson(filename):
    """Reads JSON (the reference's readjson calls pickle,
    ricker_util.py:364-365)."""
    return _io.read_json(filename)


# -- reference-signature plot wrappers (viz backs them; figures save when a
#    filename is given rather than unconditionally into Figures/) -----------


def plotrickers(t1, w1, t2, w2, tlim=(False, False), ulim=(False, False),
                clean=False, title="Ricker Wavelets", ref=(False, False),
                filename=None):
    """Predicted/observed wavelet pair (reference plotrickers,
    ricker_util.py:106-131); ``ref`` optionally overlays a grey reference
    curve, ``clean`` strips labels like the reference."""
    plt = _plt()
    fig = _viz.plot_rickers(t1, w1, t2, w2,
                       tlim=None if tlim[0] is False else tlim,
                       ulim=None if ulim[0] is False else ulim,
                       title=title)
    ax = fig.gca()
    if isinstance(ref[0], np.ndarray):
        ax.plot(ref[0], ref[1], color="grey", lw=1.0)
    if clean:
        ax.set_title("")
        ax.tick_params(left=False, bottom=False, labelleft=False,
                       labelbottom=False)
    if filename:
        fig.savefig(filename)
    plt.close(fig)


def plotsurface(source, x, y, xtrue, ytrue, xlab="x", ylab="y", filename=None,
                **kw):
    """3-D misfit surface (reference plotsurface, ricker_util.py:162-200);
    extra reference styling keywords are accepted and ignored."""
    fig = _viz.plot_misfit_surface(source, x, y, xtrue=xtrue, ytrue=ytrue,
                              xlab=xlab, ylab=ylab, filename=filename)
    _plt().close(fig)


def plotmisfit(ws, title="Wasserstein distance vs iteration", filename=None,
               second=None, log=False, style1="co-", style2="co-"):
    """Misfit-vs-iteration trace (reference plotmisfit,
    ricker_util.py:428-454)."""
    fig = _viz.plot_misfit_trace(ws, second=second, log=log, title=title,
                            filename=filename)
    _plt().close(fig)


def plotwfit(tobs, wobs, i, wfplot, was, it, w, xlim=(-2.1, 7.1),
             ylim=(-1.0, 1.9), title="Waveform fit", filename=None):
    """Waveform fit + W-convergence at iterate ``it`` (reference plotwfit,
    ricker_util.py:456-475); ``wfplot`` is a sequence of waveformFP whose
    ``.p`` vertices are the synthetic at each iteration."""
    p = np.asarray(wfplot[i].p)
    fig = _viz.plot_waveform_fit(tobs, wobs, p.T[0], p.T[1], was, int(it),
                            xlim=xlim, ylim=ylim, title=title,
                            filename=filename)
    _plt().close(fig)


def plotwfit_3panels(tobs, wobs, i, wfplot, was, ls, it, w, l2,
                     xlim=(-2.1, 7.1), ylim=(-1.0, 1.9),
                     title="Waveform fit", filename=None):
    """plotwfit with the reference's third (L2) panel
    (ricker_util.py:477-507)."""
    p = np.asarray(wfplot[i].p)
    fig = _viz.plot_waveform_fit(tobs, wobs, p.T[0], p.T[1], was, int(it),
                            second=ls, second_label="L2 distance",
                            xlim=xlim, ylim=ylim, title=title,
                            filename=filename)
    _plt().close(fig)


def plotMarginals(wfwave, wf, tag="_", fxsize=None, fysize=None, outdir="."):
    """Marginal strips + fingerprint (reference ricker_util.plotMarginals,
    ricker_util.py:508-552 — same panels as the FingerprintLib variant;
    figure-size overrides are accepted for signature parity)."""
    return _fp_plotMarginals(wfwave, wf, tag=tag, outdir=outdir)
