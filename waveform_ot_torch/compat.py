"""The reference's class-based API on the PyTorch port (counterpart of
waveform_ot_tpu.compat).

Users of msambridge/waveform-ot keep their calling code: ``OTpdf``,
``waveformFP``, ``wasser``, ``MargWasserstein``, ``SlicedWasserstein``, the
Sinkhorn and barycenter entry points and the FingerprintLib utilities take
and return NumPy arrays, in float64, as the reference does. Between the
boundaries every number is computed in torch on the object's device, which
is the card unless the caller asks for another (``device="cpu"``);
``OTpdf``/``waveformFP`` objects carry it, and the module functions that
take none (``SinkhornAB``, ``filter``) have their own ``device`` argument.
The LP, least-squares and numerical-integration oracles stay on the host
(``ops/validate.py``, SciPy), as do the exact EMD of ``wasserPOT`` and the
fast-marching field of ``calcpdf(method="FMM")`` and ``calcFMM_dist_deriv``
(``native/``, C++).

The plotting wrappers (``plotWasser`` ... ``plot_rays_discrete``, the JAX
compat's lines 786-1072) draw through ``waveform_ot_torch.viz``.
"""

from __future__ import annotations

import numpy as np
import torch

from waveform_ot_torch.ops import errors
from waveform_ot_torch.ops.barycenter import (
    barycenter_continuous, barycenter_pointmass, interp,
)
from waveform_ot_torch.ops.fingerprint import (
    DistanceField, FingerprintSpec, density_from_distance, distance_field,
    distance_field_nn, grid_axes, linspace, make_window, nearest_segment,
    nearest_vertex, normalize_vertices, resolve_adjacent,
)
from waveform_ot_torch.ops.fmm import distance_field_fmm, fmm_ray_endpoints
from waveform_ot_torch.ops.marginal import marg_wasserstein as _marg
from waveform_ot_torch.ops.otpdf import make_density, marginals, validate_density
from waveform_ot_torch.ops.pot_bridge import sinkhorn_pot, wasser_pot
from waveform_ot_torch.ops.sinkhorn import (
    gaussian_filter, sinkhorn_dense, sinkhorn_gaussian,
)
from waveform_ot_torch.ops.sliced import project_sliced, sliced_wasserstein as _sliced
from waveform_ot_torch.ops.validate import (
    build_linprog, cost_matrix, find_plan_from_w, linprog_plan, wasserstein_numint,
)
from waveform_ot_torch.ops.wasser import (
    check_common_cdf, transport_plan_1d, transport_plan_jacobian, wasser as _wasser,
)
from waveform_ot_torch.viz import (
    _arr, _plt, plot_density_surface, plot_transport_frames, plot_transport_plan,
)

# The reference's exception names, its own spellings included
# (POTlibraryError, WaveformPFderivError, FMMlibraryError), as the classes
# of ops.errors.
Error = errors.Error
PDFShapeError = errors.PDFShapeError
DistfuncShapeError = errors.DistfuncShapeError
PDFSignError = errors.PDFSignError
UnknownOTDistanceTypeError = errors.UnknownOTDistanceTypeError
TargetSourceCDFError = errors.TargetSourceCDFError
TargetSource2DShapeError = errors.TargetSource2DShapeError
SlicedWassersteinError = errors.SlicedWassersteinError
MarginalWassersteinError = errors.MarginalWassersteinError
POTLibraryError = POTlibraryError = errors.POTLibraryError
WaveformFPderivError = WaveformPFderivError = errors.WaveformFPderivError
FingerprintMethodError = errors.FingerprintMethodError
FMMLibraryError = FMMlibraryError = errors.FMMLibraryError


def _tensor(a, device) -> torch.Tensor:
    """An array or tensor as a float64 tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


def _np(x):
    """A tensor as a NumPy array; a 0-d tensor or a number as a float."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
        return x if x.shape else float(x)
    return float(x)


def _nested_np(v):
    return [_nested_np(u) for u in v] if isinstance(v, list) else _np(v)


class OTpdf:
    """The reference's PDF container (OTlib.py:82-163).

    Built from an (amplitudes, locations) pair: normalization, CDF and
    the 1-D/2-D split happen at once; ``setMarginals``/``setSliced`` fill
    ``.marg``/``.proj``. Attributes are NumPy arrays; ``density`` is the
    port's Density1D/Density2D on ``device``.
    """

    def __init__(self, pdf, device="cuda"):
        f, x = pdf
        self.device = torch.device(device)
        f, x = _tensor(f, self.device), _tensor(x, self.device)
        validate_density(f, x)
        self._d = make_density(f, x)
        self.ndim = 2 if f.dim() == 2 else 1
        self.type = "2D" if self.ndim == 2 else "1D"
        self.amp = _np(self._d.amp)
        self.pdf = _np(self._d.pdf)
        self.x = _np(self._d.x)
        if self.ndim == 2:
            self.nx, self.ny = self.pdf.shape
            self.n = self.nx * self.ny
        else:
            self.n = self.pdf.shape[0]
            self.cdf = _np(self._d.cdf)
        self.calcmarg = True
        self.calcproj = True
        self.nproj = 0

    @property
    def density(self):
        """The port's Density1D/Density2D, on this object's device."""
        return self._d

    def setMarginals(self):
        if self.type != "2D":
            raise errors.TargetSource2DShapeError()
        self.marg = [OTpdf((m.pdf, m.x), self.device) for m in marginals(self._d)]
        self.angles = np.array([0.0, np.pi / 2])
        self.calcmarg = False

    def setSliced(self, Nproj, org):
        if self.type != "2D":
            raise errors.TargetSource2DShapeError()
        pr = project_sliced(self._d, Nproj, org)
        self.nproj = Nproj
        self.origin = org
        self.proj = [OTpdf((pr.f_sorted[i], pr.x_sorted[i]), self.device)
                     for i in range(Nproj)]
        self.psorted = _np(pr.psorted)
        self.angles = _np(pr.angles)
        self.calcproj = False


def wasser(source: OTpdf, target: OTpdf, distfunc="W12", derivatives=False,
           returnplan=False, checkCommonCDF=False, ignoreCommonCDFerror=False,
           **_ignored):
    """The reference wasser (OTlib.py:596-741 signature subset):
    [W1(, dW1/df, dW1/dt)][, W2(, ...)] (+ plan (+ plan Jacobian))."""
    f = source.density.pdf * source.density.amp
    g = target.density.pdf * target.density.amp
    if checkCommonCDF or derivatives:
        try:
            check_common_cdf(f, g)
        except errors.TargetSourceCDFError:
            if not ignoreCommonCDFerror:
                raise
    out = [_np(v) for v in _wasser(source.density, target.density, distfunc=distfunc,
                                   derivatives=derivatives)]
    if returnplan:
        xf, xg = source.density.x, target.density.x
        out.append(_np(transport_plan_1d(f, xf, g, xg)))
        if derivatives:
            out.append(_np(transport_plan_jacobian(f, xf, g, xg)))
    return out


def MargWasserstein(source: OTpdf, target: OTpdf, distfunc="W2", derivatives=False,
                    returnmargW=False, **_ignored):
    """The reference MargWasserstein (OTlib.py:1055-1154)."""
    return _nested_np(_marg(source.density, target.density, distfunc=distfunc,
                            derivatives=derivatives, returnmargW=returnmargW))


def SlicedWasserstein(source: OTpdf, target: OTpdf, Nproj, distfunc="W2",
                      derivatives=False, returnplan=False, origin=(0.5, 0.5),
                      **_ignored):
    """The reference SlicedWasserstein (OTlib.py:1156-1318 subset)."""
    return [_np(v) for v in _sliced(source.density, target.density, Nproj,
                                    distfunc=distfunc, derivatives=derivatives,
                                    returnplan=returnplan, origin=origin)]


def _checkderivSliced(source: OTpdf, target: OTpdf, df, Nproj=10, distfunc="W2",
                      verbose=False, memory=False):
    """The reference's sliced-Wasserstein FD harness (OTlib.py:303-328):
    prints the analytic derivative beside a central difference for every
    source amplitude, each perturbed sample a new OTpdf; returns None."""
    f = source.pdf.reshape(source.n) * source.amp
    fx = source.x
    Wplan, dWplan = SlicedWasserstein(source, target, Nproj, derivatives=True,
                                      distfunc=distfunc)
    print("\n W2 from average plan: ", np.sqrt(Wplan))
    print("\n Compare analytical and finite difference derivatives from "
          "Sliced Wasserstein: \n")
    print("I           d(W2)/df            Finite Diff \n")
    for i in range(source.n):
        fmin = np.copy(f)
        fmin[i] = f[i] - df
        sm = OTpdf((fmin.reshape((source.nx, source.ny)), fx), source.device)
        w2m = SlicedWasserstein(sm, target, Nproj, distfunc=distfunc)[0]
        fplu = np.copy(f)
        fplu[i] = f[i] + df
        sp = OTpdf((fplu.reshape((source.nx, source.ny)), fx), source.device)
        w2p = SlicedWasserstein(sp, target, Nproj, distfunc=distfunc)[0]
        wfd = (w2p - w2m) / (2 * df)
        print(i, " :    plan  ", np.asarray(dWplan).flatten()[i], " ", wfd)


def _checkderivMarg(source: OTpdf, target: OTpdf, df, distfunc="W2", verbose=False,
                    memory=False, percent=False, ind=None, returnmargW=False,
                    dffloor=None):
    """The reference's marginal-Wasserstein FD harness (OTlib.py:330-393)
    with its quirks: it returns at the first index whose amplitude clears
    ``dffloor``, (None, None) when none does, and splits per marginal on
    ``returnmargW``."""
    f = source.pdf.reshape(source.n) * source.amp
    fx = source.x
    Wpm = MargWasserstein(source, target, derivatives=True, distfunc=distfunc,
                          returnmargW=returnmargW)
    dWm = Wpm[1]
    if verbose:
        print("\n W2 from average marginal : ", np.sqrt(Wpm[0]))
        print("\n Compare analytical and finite difference derivatives "
              "from Marginal Wasserstein: \n")
        print("I                     d(W2)/df            Finite Diff \n")
    dfused = df
    if dffloor is None:
        dffloor = 0.0001 * np.max(f)
    for i in range(source.n) if ind is None else ind:
        if percent:
            dfused = np.abs(f[i]) * df / 100.0
        if not np.abs(f[i]) > dffloor:
            continue
        fmin = np.copy(f)
        fmin[i] = f[i] - dfused
        sm = OTpdf((fmin.reshape((source.nx, source.ny)), fx), source.device)
        fplu = np.copy(f)
        fplu[i] = f[i] + dfused
        sp = OTpdf((fplu.reshape((source.nx, source.ny)), fx), source.device)
        if returnmargW:
            w2m = MargWasserstein(sm, target, distfunc=distfunc, returnmargW=True)[0]
            w2p = MargWasserstein(sp, target, distfunc=distfunc, returnmargW=True)[0]
            wfd0 = (w2p[0] - w2m[0]) / (2 * dfused)
            wfd1 = (w2p[1] - w2m[1]) / (2 * dfused)
            if verbose:
                print(i, " :     Marg t   ", np.asarray(dWm[0]).flatten()[i], " ", wfd0)
                print(i, " :     Marg u   ", np.asarray(dWm[1]).flatten()[i], " ", wfd1)
            return wfd0, wfd1
        w2m = MargWasserstein(sm, target, distfunc=distfunc)[0]
        w2p = MargWasserstein(sp, target, distfunc=distfunc)[0]
        wfd = (w2p - w2m) / (2 * dfused)
        if verbose:
            print(i, " :     avg   ", np.asarray(dWm).flatten()[i], " ", wfd)
        return wfd
    return None, None


def wasserNumInt(source: OTpdf, target: OTpdf):
    """The reference wasserNumInt (OTlib.py:854-874): (W1, W2^2) by
    inverse-CDF sampling on the host (a validation oracle)."""
    return wasserstein_numint(source.pdf * source.amp, source.x,
                              target.pdf * target.amp, target.x)


def Wasser_LinProg(source: OTpdf, target: OTpdf, distfunc="W1", maxiter: int = 5000,
                   **_ignored):
    """The reference Wasser_LinProg (OTlib.py:465-506): exact W by SciPy's
    linear programming on the host. Returns (W, plan)."""
    p = 1 if distfunc == "W1" else 2
    H = linprog_plan(source.pdf, source.x, target.pdf, target.x, p=p, maxiter=maxiter)
    return float(np.sum(cost_matrix(source.x, target.x, p) * H)), H


def wasser_find_optplan(source: OTpdf, target: OTpdf, W, distfunc="W2", **_ignored):
    """The reference wasser_find_optplan (OTlib.py:876-904): a plan of a
    known W by bounded least squares on the host."""
    p = 1 if distfunc == "W1" else 2
    return find_plan_from_w(source.pdf, source.x, target.pdf, target.x, float(W), p=p)


def Sinkhorn(source: OTpdf, target: OTpdf, gamma: float = 0.005, iter: int = 250,
             **_ignored):
    """The reference's Gaussian-kernel Sinkhorn (OTlib.py:956-967) on the
    normalized grid densities; gamma is the blur's sigma in pixels.
    Returns (distance, v, w)."""
    d, v, w = sinkhorn_gaussian(source.density.pdf, target.density.pdf, gamma=gamma,
                                iters=iter)
    return _np(d), _np(v), _np(w)


def Sinkhorn_MS(sou: OTpdf, tar: OTpdf, gamma: float = 5e-4, maxiters: int = 5001,
                **_ignored):
    """The reference's dense-kernel Sinkhorn (OTlib.py:969-1011). Returns
    (W^p estimate, plan)."""
    d, pi = sinkhorn_dense(sou.density, tar.density, gamma=gamma, iters=maxiters)
    return _np(d), _np(pi)


def wasserPOT(source: OTpdf, target: OTpdf, distfunc="W2", **kw):
    """The reference's POT bridge (OTlib.py:906-928): the exact EMD on the
    host, by the package's native solver when POT is absent; pass
    ``backend='pot'`` for the reference's raise-when-absent behaviour."""
    return wasser_pot(source.density, target.density, distfunc=distfunc, **kw)


def sinkhornPOT(source: OTpdf, target: OTpdf, distfunc="W2", **kw):
    """The reference's POT Sinkhorn (OTlib.py:1015-1053), iterated on the
    objects' device."""
    return sinkhorn_pot(source.density, target.density, distfunc=distfunc, **kw)


def barypath_pointmass(source: OTpdf, target: OTpdf, weights):
    """The reference barypath_pointmass (OTlib.py:743-786): lists of
    amplitudes and positions, the original pdfs at the two ends."""
    amps, xs = barycenter_pointmass(source.density, target.density, weights,
                                    include_endpoints=True)
    return [_np(a) for a in amps], [_np(x) for x in xs]


def barypath(source: OTpdf, target: OTpdf, weights, npoints: int = 50000,
             returntaxis: bool = False, pointmass: bool = False):
    """The reference barypath (OTlib.py:788-852): continuous displacement
    interpolation (k, 2, npoints), or with ``pointmass`` the (k, 2, m)
    positions and masses."""
    if pointmass:
        xs, dtk = barycenter_pointmass(source.density, target.density, weights)
        return _np(torch.stack([xs, dtk.expand_as(xs)], dim=1))
    out = barycenter_continuous(source.density, target.density, weights,
                                npoints=npoints, return_taxis=returntaxis)
    return (_np(out[0]), _np(out[1])) if returntaxis else _np(out)


class waveformFP:
    """The reference's fingerprint object (FingerprintLib.py:48-180).

    Holds the waveform and its window and, after ``calcpdf``, the distance
    field ``dfield``, density ``pdf``, nearest-segment data ``irays``/
    ``lrays``/``xrays`` and grid positions ``pos``, as NumPy arrays; the
    same quantities stay on ``device`` for the derivative methods.
    """

    def __init__(self, t, w, grid, fpgrid=None, theta=45.0, tantheta=1.0, device="cuda"):
        (t0, t1, u0, u1, nug, ntg) = grid
        self.device = torch.device(device)
        t = np.asarray(t, dtype=np.float64)
        w = np.asarray(w, dtype=np.float64)
        self.nt = len(t)
        self.ntg = int(ntg)
        self.nug = int(nug)
        self.tlim = (t0, t1)
        self.ulim = (u0, u1)
        kw = {"tantheta": tantheta} if tantheta != 1.0 else {"theta": theta}
        self._win = make_window(t0, t1, u0, u1, device=self.device, **kw)
        self.tant = float(self._win.tantheta)
        self.theta = float(np.rad2deg(np.arctan(self.tant)))
        self._spec = FingerprintSpec(nu=self.nug, ntg=self.ntg)
        self._t = _tensor(t, self.device)
        self._fpbox = None if fpgrid is None else tuple(fpgrid[0:4])
        delt = self.tant * (t1 - t0)
        self.tlimn = ((t[0] - t0) / delt, (t[-1] - t0) / delt)
        self.ulimn = (0.0, 1.0)
        self.p = np.array([t, w]).T
        self._pn = normalize_vertices(self._t, _tensor(w, self.device), self._win)
        self.pn = _np(self._pn)
        # the fingerprint box and the segment geometry, which the module
        # utilities (wavedistv, NNsearch) read off the object
        if fpgrid is None:
            self.tlimfp, self.ulimfp = self.tlim, self.ulim
            self.tlimnfp, self.ulimnfp = self.tlimn, self.ulimn
        else:
            fp_t0, fp_t1, fp_u0, fp_u1 = fpgrid[0:4]
            self.tlimfp = (fp_t0, fp_t1)
            self.ulimfp = (fp_u0, fp_u1)
            self.tlimnfp = ((fp_t0 - t0) / delt, (fp_t1 - t0) / delt)
            self.ulimnfp = ((fp_u0 - u0) / (u1 - u0), (fp_u1 - u0) / (u1 - u0))
        self.delgrid = np.array([(self.ulimnfp[1] - self.ulimnfp[0]) / self.nug,
                                 (self.tlimnfp[1] - self.tlimnfp[0]) / self.ntg])
        self.x0 = self.pn[:-1].reshape(1, self.nt - 1, 2)
        self._delta = self._pn[1:] - self._pn[:-1]
        self._lsq = self._delta[:, 0] * self._delta[:, 0] + self._delta[:, 1] * self._delta[:, 1]
        self.delta_n = _np(self._delta)
        self.lsq_n = _np(self._lsq)
        self.dcalc = False
        self.drcalc = False

    def calcpdf(self, q=None, lambdav=0.04, deriv=False, method="Enumerate",
                verbose=False, nsegs=0):
        """Distance field and density on the fingerprint grid: 'Enumerate'
        is the exact field (the CUDA kernel on the card, one launch),
        'NNsearch' the vertex-NN field, 'FMM' the fast-marching field of the
        signed indicator (host C++, no launch; it leaves the nearest-segment
        data unset, as the reference does)."""
        if method not in ("Enumerate", "NNsearch", "FMM", "fmm"):
            raise errors.FingerprintMethodError(method)
        self.lam = lambdav
        self.q = q
        tg, ug = grid_axes(self._t, self._win, self._spec, fpbox=self._fpbox)
        if method in ("FMM", "fmm"):
            self.dfield = distance_field_fmm(self.pn[:, 0], self.pn[:, 1], tg, ug)
            self.type = "FMM"
            d = _tensor(self.dfield, self.device)
        else:
            args = (self._pn[None].contiguous(), tg[None].contiguous(), ug[None].contiguous())
            if method == "NNsearch":
                fld, self.type = distance_field_nn(*args), "NNs"
            else:
                fld, self.type = distance_field(*args), "Enu"
            self._store_field(DistanceField(*(x[0] for x in fld)))
            d = self._fld.d
        self._pdf = density_from_distance(d, lambdav, q=q)
        self.pdf = _np(self._pdf)
        shape = (self.nug, self.ntg)
        self.pos = _np(torch.stack([tg.expand(shape), ug[:, None].expand(shape)], dim=-1))
        self.dcalc = True
        if deriv:
            self.wdistderiv()

    def wdistderiv(self):
        """d(distance)/d(waveform amplitude) at every grid point (reference
        wdistderiv, FingerprintLib.py:333-385), stored as ``dddy``
        (Ngrid, 2) for the nearest segment's (lower, upper) endpoint."""
        if not self.dcalc:
            raise errors.WaveformFPderivError()
        pts = _tensor(_grid_points_n(self), self.device)
        self._dddy = _wavederiv(self._fld.d.reshape(-1), self._lr, self._xrays, pts,
                                self.ulim[1] - self.ulim[0])
        self.dddy = _np(self._dddy)
        self.drcalc = True
        return self.dddy

    def _chain(self, chainmatrix):
        """-(sum of dddy-weighted grid terms at each waveform sample) / lambda
        for the grid weights pdf * chainmatrix (the reference's per-sample
        loops, FingerprintLib.py:196-202, as two ``index_add_``)."""
        pdfrow = self._pdf.reshape(-1)
        if chainmatrix is not None:
            pdfrow = pdfrow * _tensor(chainmatrix, self.device).reshape(-1)
        if self.q == 2:
            pdfrow = 2.0 * pdfrow * self._fld.d.reshape(-1).abs()
        return -_endpoint_scatter(self._ir, self._dddy, pdfrow, self.nt) / self.lam

    def PDFderiv(self, chainmatrix=None):
        """d(density)/d(amplitudes), optionally chained with a cotangent
        field (reference PDFderiv, FingerprintLib.py:182-203); stores and
        returns ``pdfd`` (nt,)."""
        if not self.drcalc:
            raise errors.WaveformFPderivError()
        chain = chainmatrix if isinstance(chainmatrix, (np.ndarray, torch.Tensor)) else None
        self.pdfd = _np(self._chain(chain))
        return self.pdfd

    def PDFderivMarg(self, chainmatrix):
        """Both marginal cotangent fields at once (reference PDFderivMarg,
        FingerprintLib.py:205-228); stores and returns ``pdfdMarg``
        [(nt,), (nt,)]."""
        if not self.drcalc:
            raise errors.WaveformFPderivError()
        self.pdfdMarg = [_np(self._chain(cm)) for cm in (chainmatrix[0], chainmatrix[1])]
        return self.pdfdMarg

    def _store_field(self, fld):
        self._fld = fld
        self._ir = fld.iclose.reshape(-1).long()
        self._lr = fld.lam.reshape(-1)
        self._xrays = self._pn[:-1][self._ir] + self._lr[:, None] * self._delta[self._ir]
        self.dfield = _np(fld.d)
        self.irays = _np(fld.iclose.reshape(-1))
        self.lrays = _np(self._lr)
        self.xrays = _np(self._xrays)


# ---------------------------------------------------------------------------
# module-level FingerprintLib utilities
# ---------------------------------------------------------------------------


def _grid_points_n(wf) -> np.ndarray:
    """Normalized fingerprint grid points, flattened row-major (the
    reference's meshgrid of np.linspace axes)."""
    tg = np.linspace(wf.tlimnfp[0], wf.tlimnfp[1], wf.ntg)
    ug = np.linspace(wf.ulimnfp[0], wf.ulimnfp[1], wf.nug)
    tt, uu = np.meshgrid(tg, ug)
    return np.stack([tt.ravel(), uu.ravel()], axis=1)


def _endpoint_scatter(ir, dddy, pdfrow, nt):
    """sum over grid points of dddy[:, 0] * pdfrow into sample ir and of
    dddy[:, 1] * pdfrow into sample ir + 1, (nt,)."""
    s = pdfrow.new_zeros(nt).index_add_(0, ir, dddy[:, 0] * pdfrow)
    return s.index_add_(0, ir + 1, dddy[:, 1] * pdfrow)


def wavedist(point, wf):
    """Nearest distance from one point to the polyline (reference
    wavedist): (d, iclose, xclose) in normalized coordinates."""
    d, i, xc, _ = wavedistv(np.asarray(point).reshape(1, 2), wf)
    return float(d[0]), int(i[0]), xc[0]


def wavedistv(points, wf):
    """Nearest segment of the polyline for (k, 2) points (reference
    wavedistv): (d, iclose, xclose, lam), first-minimum ties."""
    p = _tensor(points, wf.device).reshape(-1, 2)
    dsq, iclose, lam = nearest_segment(wf._pn, p)
    xclose = wf._pn[:-1][iclose] + lam[:, None] * wf._delta[iclose]
    return _np(torch.sqrt(dsq)), _np(iclose), _np(xclose), _np(lam)


def _wavederiv(dis, lr, xr, p, du):
    """Envelope-form dd/d(amplitude) of the segment's two endpoints."""
    safe = torch.where(dis > 0, dis, torch.ones_like(dis))
    dddu = (xr[:, 1] - p[:, 1]) / safe
    return torch.stack([(1.0 - lr) * dddu / du, lr * dddu / du], dim=1)


def wavederiv(d, irays, xrays, lrays, points, wf, verbose=False):
    """d(distance)/d(waveform amplitude) for each query point (reference
    wavederiv, FingerprintLib.py:478-514).

    Envelope form: at the winning segment dd/dy0 = (1-lam) ray_u and
    dd/dy1 = lam ray_u with ray = (x* - p)/d, over du to undo the amplitude
    normalization. verbose=True also returns (dlamdy0, dlamdy1, dxdy0,
    dxdy1): the derivatives of the unclipped projection parameter, zero at
    the clip, as the JAX package writes them.
    """
    dev = wf.device
    p = _tensor(points, dev).reshape(-1, 2)
    lr = _tensor(lrays, dev).reshape(-1)
    out = _wavederiv(_tensor(d, dev).reshape(-1), lr, _tensor(xrays, dev).reshape(-1, 2), p,
                     wf.ulim[1] - wf.ulim[0])
    if not verbose:
        return _np(out)
    ir = torch.as_tensor(np.asarray(irays), device=dev).reshape(-1).long()
    x0 = wf._pn[:-1][ir]
    c = wf._delta[ir]
    lsq = wf._lsq[ir]
    b = p - x0
    interior = (lr > 0.0) & (lr < 1.0)
    zero = torch.zeros_like(lr)
    dlamdy0 = torch.where(interior, (2.0 * lr * c[:, 1] - c[:, 1] - b[:, 1]) / lsq, zero)
    dlamdy1 = torch.where(interior, (b[:, 1] - lr * c[:, 1]) / lsq, zero)
    e_u = torch.tensor([0.0, 1.0], dtype=torch.float64, device=dev)
    dxdy0 = (1.0 - lr)[:, None] * e_u + dlamdy0[:, None] * c
    dxdy1 = lr[:, None] * e_u + dlamdy1[:, None] * c
    return _np(out), _np(dlamdy0), _np(dlamdy1), _np(dxdy0), _np(dxdy1)


def NNsearch(wf, ni=0):
    """Vertex-NN distance field (reference NNsearch, FingerprintLib.py:387-443):
    (dfield, irays, lrays, xrays).

    ni > 0 first resamples the polyline at ntg*(ni+1) - ni points over the
    normalized fingerprint box (the reference sizes it by the grid's time
    count), finds each grid point's nearest resampled vertex, rounds it
    back to an original vertex and resolves it against that vertex's two
    adjacent segments, with the reference's max(npoints)-1 clip and its
    prefer-the-lower-segment ties.
    """
    dev = wf.device
    if not ni:
        tg = linspace(*(_tensor(v, dev) for v in wf.tlimnfp), wf.ntg)
        ug = linspace(*(_tensor(v, dev) for v in wf.ulimnfp), wf.nug)
        fld = distance_field_nn(wf._pn[None], tg[None], ug[None])
        ir = fld.iclose.reshape(-1).long()
        lr = fld.lam.reshape(-1)
        xrays = wf._pn[:-1][ir] + lr[:, None] * wf._delta[ir]
        return _np(fld.d[0]), _np(ir), _np(lr), _np(xrays)
    tf = _tensor(np.linspace(wf.tlimnfp[0], wf.tlimnfp[1], wf.ntg * (ni + 1) - ni), dev)
    pline = torch.stack([tf, interp(tf, wf._pn[:, 0], wf._pn[:, 1])], dim=1)
    pts = _tensor(_grid_points_n(wf), dev)
    nn = nearest_vertex(pline, pts)
    npoints = torch.round(nn.to(torch.float64) / (ni + 1)).long()
    hi = int(npoints.max()) - 1
    dsq, irays, lrays, _ = resolve_adjacent(wf._pn, pts, torch.clamp(npoints, 0, hi),
                                            torch.clamp(npoints - 1, 0, hi))
    xrays = wf._pn[:-1][irays] + lrays[:, None] * wf._delta[irays]
    dfield = torch.sqrt(dsq).reshape(wf.nug, wf.ntg)
    return _np(dfield), _np(irays), _np(lrays), _np(xrays)


def check_FDderiv(wf, k, du=0.001, verbose=False):
    """Central difference of the distance at grid point ``k`` w.r.t. the
    two endpoints of its nearest segment (reference check_FDderiv,
    FingerprintLib.py:516-572). Returns (segment, dddy0_fd, dddy1_fd)."""
    t = np.asarray(wf.p)[:, 0]
    w = np.asarray(wf.p)[:, 1]
    i = int(np.asarray(wf.irays).reshape(-1)[k])
    step = du * abs(w[i]) if w[i] != 0 else du
    pts = _grid_points_n(wf)
    grid = (wf.tlim[0], wf.tlim[1], wf.ulim[0], wf.ulim[1], wf.nug, wf.ntg)

    def field_at(j, s):
        wp = np.array(w, copy=True)
        wp[j] += s
        wfp = waveformFP(t, wp, grid, tantheta=wf.tant, device=wf.device)
        return wavedistv(pts, wfp)[0][k]

    d0 = (field_at(i, step) - field_at(i, -step)) / (2 * step)
    d1 = (field_at(i + 1, step) - field_at(i + 1, -step)) / (2 * step)
    if verbose:
        print(f"check_FDderiv: point {k} segment {i} fd=({d0}, {d1})")
    return i, d0, d1


def check_FDchain(wf, lambdav, dufd=0.0001):
    """Central difference of sum(exp(-d/lambda)) w.r.t. each waveform
    amplitude (reference check_FDchain, FingerprintLib.py:574-610); like the
    reference it returns the last sample's value (its loop overwrites)."""
    t = np.asarray(wf.p)[:, 0]
    w = np.asarray(wf.p)[:, 1]
    pts = _grid_points_n(wf)
    grid = (wf.tlim[0], wf.tlim[1], wf.ulim[0], wf.ulim[1], wf.nug, wf.ntg)

    def total(j, s):
        wp = np.array(w, copy=True)
        wp[j] += s
        wfp = waveformFP(t, wp, grid, device=wf.device)
        return np.sum(np.exp(-np.abs(wavedistv(pts, wfp)[0]) / lambdav))

    dsdyfd = 0.0
    for j in range(wf.nt):
        dsdyfd = (total(j, dufd) - total(j, -dufd)) / (2 * dufd)
    return dsdyfd


def wPDFderiv(pdf, dddy, lambdav, irays, wf, chainmatrix):
    """Chain rule from the density field to the waveform amplitudes
    (reference wPDFderiv, FingerprintLib.py:612-622)."""
    dev = wf.device
    pdfrow = _tensor(pdf, dev).reshape(-1) * _tensor(chainmatrix, dev).reshape(-1)
    ir = torch.as_tensor(np.asarray(irays), device=dev).reshape(-1).long()
    return _np(-_endpoint_scatter(ir, _tensor(dddy, dev), pdfrow, wf.nt) / lambdav)


# ---------------------------------------------------------------------------
# module-level OTlib utilities
# ---------------------------------------------------------------------------


def BuildLinProg(source: OTpdf, target: OTpdf, distfunc=None, args=None):
    """LP data (d, A_eq, b_eq) for exact OT (reference BuildLinProg,
    OTlib.py:454-463) on the host: ``distfunc`` is 'W1'/'W2' or a
    cost(i, j, args) callable; d is the (n_src, n_tgt) cost matrix."""
    if distfunc is None:
        raise errors.UnknownOTDistanceTypeError(distfunc)
    if callable(distfunc):
        d = np.array([[float(distfunc(j, i, args)) for i in range(target.n)]
                      for j in range(source.n)])
        _, A_eq, b_eq = build_linprog(source.pdf, source.x, target.pdf, target.x, p=1)
        return d, A_eq, b_eq
    if distfunc not in ("W1", "W2"):
        raise errors.UnknownOTDistanceTypeError(distfunc)
    c, A_eq, b_eq = build_linprog(source.pdf, source.x, target.pdf, target.x,
                                  p=2 if distfunc == "W2" else 1)
    return np.asarray(c).reshape(source.n, target.n), A_eq, b_eq


def distfunction(iarr, jarr, distfunction_args, proj=-1, deriv=False):
    """Precomputed-cost lookup of the user-cost wasser path (reference
    distfunction, OTlib.py:574-594): (i, j) indexing for 1-D, or through
    the per-slice sort permutations for the sliced form."""
    if isinstance(distfunction_args, np.ndarray):
        if proj != -1:
            raise errors.UnknownOTDistanceTypeError("sliced lookup needs (source, target, A) args")
        return distfunction_args[np.asarray(iarr), np.asarray(jarr)]
    source, target, A = distfunction_args
    if proj == -1:
        return A[np.asarray(iarr), np.asarray(jarr)]
    lf = np.asarray(source.psorted)[proj][np.asarray(iarr)]
    lg = np.asarray(target.psorted)[proj][np.asarray(jarr)]
    return A[lf, lg]


# elementwise helpers of the reference's Sinkhorn section (OTlib.py:939-941);
# logv floors at 1e-300 like the reference
powv = np.vectorize(pow)
maxv = np.vectorize(max)
logv = np.vectorize(lambda x: np.log(max(1e-300, x)))


def SinkhornAB(mu, sigma, verbose=False, device="cuda"):
    """Gaussian-kernel Sinkhorn on a pair of grid densities mu = (mu0, mu1)
    (reference SinkhornAB, OTlib.py:943-954), 5001 steps. Returns
    (dist, v, w)."""
    dist, v, w = sinkhorn_gaussian(_tensor(mu[0], device), _tensor(mu[1], device),
                                   gamma=sigma, iters=5001)
    if verbose:
        print("Sinkhorn distance: " + str(float(dist)))
    return _np(dist), _np(v), _np(w)


def filter(image, sigma, device="cuda"):  # noqa: A001 - reference name (OTlib.py:936)
    """Zero-padded Gaussian blur, truncate=32 (reference filter)."""
    return _np(gaussian_filter(_tensor(image, device), sigma))


def trim_axs(axs, N):
    """Trim a subplot-axes array to N entries (reference trim_axs,
    OTlib.py:1322-1328)."""
    axs = axs.flat
    for ax in axs[N:]:
        ax.remove()
    return axs[:N]


# ---------------------------------------------------------------------------
# reference-signature plot wrappers (viz backs them; figures saved when a
# filename is given, matching the reference's filename='Null'/'no' idiom)
# ---------------------------------------------------------------------------


def plotWasser(xp, Fp, Gp, t, IF, IG, x, IGF, xmIFGsq, iFGdiff,
               filename="Null"):
    """Six-panel CDF/inverse-CDF/transport-map figure from precomputed
    curves (reference plotWasser, OTlib.py:508-572). viz.plot_wasser_panels
    computes the same panels directly from a pair of densities."""
    plt = _plt()
    fig, axs = plt.subplots(3, 2, figsize=(9, 10))
    panels = [
        (xp, [(Fp, "$F(x)$"), (Gp, "$G(x)$")], "CDFs"),
        (t, [(IF, "$F^{-1}(t)$"), (IG, "$G^{-1}(t)$")], "Inverse CDFs"),
        (x, [(IGF, "$G^{-1}(F(x))$")], "Transport map"),
        (x, [(x - IGF, "$x - G^{-1}(F(x))$")], "Displacement"),
        (x, [(xmIFGsq, "$|x - G^{-1}(F(x))|^2$")], "Squared displacement"),
        (t, [(iFGdiff, "$F^{-1}(t) - G^{-1}(t)$")], "Quantile difference"),
    ]
    for ax, (ox, curves, title) in zip(axs.flat, panels):
        for cy, lab in curves:
            ax.plot(_arr(ox), _arr(cy), label=lab)
        ax.set_title(title)
        ax.legend(fontsize=7)
    fig.tight_layout()
    if filename != "Null":
        fig.savefig(filename)
    plt.close(fig)


def plotOT1D(source: OTpdf, target: OTpdf, filename="Null",
             returnplan=False):
    """1-D transport-plan figure (reference plotOT1D, OTlib.py:1388-1424):
    the optimal plan matrix with the two marginals alongside."""
    H = _np(transport_plan_1d(source.density.pdf, source.density.x,
                              target.density.pdf, target.density.x))
    fig = plot_transport_plan(H, source.density, target.density,
                              filename=None if filename == "Null"
                              else filename)
    _plt().close(fig)
    if returnplan:
        return H


def plot_optimal_transform_frames(source: OTpdf, target: OTpdf, frames,
                                  plotsum=False, filename=None):
    """Displacement-interpolation frames (reference
    plot_optimal_transform_frames, OTlib.py:1330-1386). ``frames`` is a
    frame count or an explicit sequence of interpolation weights."""
    if isinstance(frames, int):
        fig = plot_transport_frames(source.density, target.density,
                                    nframes=frames, filename=filename)
    else:
        fig = plot_transport_frames(source.density, target.density,
                                    weights=_arr(frames),
                                    filename=filename)
    _plt().close(fig)


def plot_phi(X, Y, phi, t, waveform, xl, yl, filename=None):
    """Zero contour of the FMM indicator (reference plot_phi,
    FingerprintLib.py:663-675) — reference argument order."""
    plt = _plt()
    fig = plt.figure(figsize=(8, 4))
    plt.xlim(*xl)
    plt.ylim(*yl)
    plt.xlabel("t")
    plt.ylabel("u")
    plt.contour(X, Y, phi, [0], linewidths=1, colors="grey")
    plt.contourf(X, Y, phi, [-1, 0, 1], colors=["lightgray", "powderblue"])
    plt.plot(t, waveform, "-", color="green", lw=0.5)
    plt.title("Zero contour of $d(u,t)$")
    if filename:
        fig.savefig(filename)
    plt.close(fig)


def plot_LS(f, wf, xl, yl, title, col1, col2, aspect=False, filename="no",
            pdf=False, ncon=10, fxsize=None, fysize=None):
    """Contoured field + waveform (reference plot_LS,
    FingerprintLib.py:742-779): aspect=True plots in NORMALIZED
    coordinates with an equal-aspect (9,9) frame and 3*ncon levels;
    aspect=False plots in the un-normalized fingerprint box ((8,4)
    frame, 2*ncon levels) with the xl/yl limits applied when given (the
    reference then overrides ylim from globals — a notebook-context
    quirk not reproduced)."""
    plt = _plt()
    if aspect:
        fig = plt.figure(figsize=(fxsize or 9, fysize or 9))
        ax = fig.add_subplot(111)
        ax.set_aspect("equal")
        tg = np.linspace(wf.tlimnfp[0], wf.tlimnfp[1], wf.ntg)
        ug = np.linspace(wf.ulimnfp[0], wf.ulimnfp[1], wf.nug)
        ax.plot(wf.pn[:, 0], wf.pn[:, 1], "-", color=col1, lw=0.7)
        ax.contour(tg, ug, _arr(f), 3 * ncon, linewidths=0.5,
                   colors=col2)
    else:
        fig = plt.figure(figsize=(fxsize or 8, fysize or 4))
        ax = fig.add_subplot(111)
        if xl is not None:
            ax.set_xlim(*xl)
        if yl is not None:
            ax.set_ylim(*yl)
        tg = np.linspace(wf.tlimfp[0], wf.tlimfp[1], wf.ntg)
        ug = np.linspace(wf.ulimfp[0], wf.ulimfp[1], wf.nug)
        ax.plot(wf.p[:, 0], wf.p[:, 1], "-", color=col1, lw=0.7)
        ax.contour(tg, ug, _arr(f), 2 * ncon, linewidths=0.5,
                   colors=col2)
    ax.set_title(title)
    ax.set_xlabel("t")
    ax.set_ylabel("u")
    if filename != "no":
        fig.savefig(filename)
    plt.close(fig)


def plot_2LS(wf1, wf2, title1, title2, col1, col2, filename="no", pdf=False,
             ncon=10, fxsize=None, fysize=None, aspect=False):
    """Side-by-side fingerprint pair (reference plot_2LS,
    FingerprintLib.py:781-816)."""
    plt = _plt()
    fig, axs = plt.subplots(1, 2, figsize=(fxsize or 18, fysize or 9))
    for ax, wf, title in ((axs[0], wf1, title1), (axs[1], wf2, title2)):
        if aspect:
            ax.set_aspect("equal")
        field = wf.pdf if pdf else wf.dfield
        tg = np.linspace(wf.tlimnfp[0], wf.tlimnfp[1], wf.ntg)
        ug = np.linspace(wf.ulimnfp[0], wf.ulimnfp[1], wf.nug)
        ax.contour(tg, ug, _arr(field), ncon, linewidths=0.5,
                   colors=col2)
        ax.plot(wf.pn[:, 0], wf.pn[:, 1], "-", color=col1, lw=0.7)
        ax.set_title(title)
    if filename != "no":
        fig.savefig(filename)
    plt.close(fig)


def plot_rays(plotind, wf, title, col1, col2, filename="no", fxsize=None,
              fysize=None):
    """Rays from selected grid points to their nearest waveform points
    (reference plot_rays, FingerprintLib.py:715-740)."""
    plt = _plt()
    fig = plt.figure(figsize=(fxsize or 9, fysize or 9))
    ax = fig.add_subplot(111)
    ax.set_aspect("equal")
    pts = _grid_points_n(wf)
    for kk in _arr(plotind).ravel():
        x1, y1 = wf.xrays[kk]
        ax.plot([pts[kk, 0], x1], [pts[kk, 1], y1], "b-", lw=0.5)
        ax.plot(x1, y1, "ro", markersize=2.0)
    ax.plot(wf.pn[:, 0], wf.pn[:, 1], "-", color="green", lw=0.5)
    ax.set_title(title)
    ax.set_xlabel("t")
    ax.set_ylabel("u")
    if filename != "no":
        fig.savefig(filename)
    plt.close(fig)


def plotPDFsurface(pdf, t, ridge, mycmap=None, elev=75, azim=-134,
                   filename=None):
    """3-D perspective surface of the fingerprint PDF (reference
    plotPDFsurface, FingerprintLib.py:641-661)."""
    pdf = _arr(pdf)
    nu, ntg = pdf.shape
    tg = np.linspace(0.0, 1.0, ntg)
    ug = np.linspace(0.0, 1.0, nu)
    fig = plot_density_surface(pdf, tg, ug, ridge_t=_arr(t),
                               ridge_u=_arr(ridge), elev=elev,
                               azim=azim, cmap=mycmap or "cubehelix_r",
                               filename=filename)
    _plt().close(fig)


def plotMarginals(wfwave, wf: OTpdf, tag="_", outdir="."):
    """Marginal strip plots saved as Marginal_{u,t}<tag>.png plus the
    combined Marginals_and_fingerprint<tag>.pdf of ``wfwave``'s distance
    field (reference plotMarginals, FingerprintLib.py:818-851); the third
    figure is skipped when ``wfwave`` is None."""
    import os

    plt = _plt()
    if wf.calcmarg:
        wf.setMarginals()
    suffix = tag if tag != "-" else ""
    for axis, name in ((1, "u"), (0, "t")):
        fig = plt.figure(figsize=(9, 1))
        m = wf.marg[axis]
        plt.plot(m.x, m.pdf)
        plt.fill_between(m.x, 0, m.pdf)
        plt.xlim(m.x[0], m.x[-1])
        plt.tick_params(left=False, bottom=True, labelleft=False,
                        labelbottom=False)
        fig.savefig(os.path.join(outdir, f"Marginal_{name}{suffix}.png"),
                    dpi=300)
        plt.close(fig)
    if wfwave is not None:
        plot_LS(wfwave.dfield, wfwave, None, None, " ", "black", "grey",
                aspect=True,
                filename=os.path.join(
                    outdir, f"Marginals_and_fingerprint{suffix}.pdf"))


def plot_RF_SDF(t, RFo, ltype="b-", string="Predicted receiver function",
                grid=False, legend=False, filename=None):
    """Waveform preview returning the axis limits (reference plot_RF_SDF,
    FingerprintLib.py:627-640)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.set_title(string)
    ax.set_xlabel("Time, t (s)")
    ax.set_ylabel("Amplitude, u")
    ax.grid(grid)
    if len(RFo) != 0:
        ax.plot(t, RFo, "-", color="grey", label="Noisy Receiver Function")
    ax.plot(t, np.zeros(np.shape(RFo)), "--", linewidth=0.5, color="grey")
    if legend:
        ax.legend()
    xl, yl = ax.get_xlim(), ax.get_ylim()
    if filename:
        fig.savefig(filename)
    plt.close(fig)
    return xl, yl


def plot_rays_discrete(X, Y, f, phi, t, waveform, xl, yl, title, col1, col2,
                       darg, q, points, filename=None):
    """Rays from selected grid points to their nearest discrete waveform
    node (reference plot_rays_discrete, FingerprintLib.py:676-713):
    ``darg`` indexes into the q>=1 node set of the indicator grid ``q``;
    viz.plot_rays_discrete is the functional-API equivalent working from
    vertex indices directly."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 9))
    ax.set_aspect("equal")
    X, Y = _arr(X), _arr(Y)
    nu, ntg = X.shape
    Xn, Yn = np.meshgrid(np.linspace(0, 1, ntg), np.linspace(0, 1, nu))
    ax.contour(Xn, Yn, _arr(phi), [0], linewidths=1, colors=col1)
    ax.contour(Xn, Yn, _arr(f), 30, linewidths=0.5, colors=col2)
    u0 = Y[0, 0]
    du = Y[-1, 0] - u0
    q = _arr(q)
    darg = _arr(darg)
    wp = np.where(q >= 1)
    for (i, j) in points:
        ii = wp[1][darg[i, j]]
        jj = wp[0][darg[i, j]]
        ax.plot([Xn[i, j], Xn[0][ii]], [Yn[i, j], Yn[jj][0]], "b-", lw=0.5)
    ax.plot(np.linspace(0, 1, ntg), (_arr(waveform) - u0) / du, "-",
            color="green", lw=0.5)
    ax.plot(Xn[wp], Yn[wp], "o", lw=0.5)
    ax.plot(Xn[q == 2], Yn[q == 2], "ro")
    ax.plot(Xn[q == -2], Yn[q == -2], "go")
    ax.set_title(title)
    ax.set_xlabel("t")
    ax.set_ylabel("u")
    if filename:
        fig.savefig(filename)
    plt.close(fig)


def calcFMM_dist_deriv(d, deltax):
    """Ray end points from an FMM distance field (reference
    calcFMM_dist_deriv, FingerprintLib.py:853-865). Returns (Xw, Yw)."""
    return fmm_ray_endpoints(d, deltax)
