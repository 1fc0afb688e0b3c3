"""Drop-in migration layer for the reference's ``loc_cmt_util`` module on the
PyTorch port (counterpart of waveform_ot_tpu.compat_loc_cmt).

Reference users write ``from libs import loc_cmt_util as lc``; pointing that
import here (``from waveform_ot_torch import compat_loc_cmt as lc``) keeps
their calling code working: every public name of loc_cmt_util.py (the
pyprop8 forward wrapper, the scipy ``optfunc``/``optfunc_L2``/``optfunc_OT``
objectives, the OT-object constructors, moment-tensor helpers, the
``opt_history`` blackboard of loc_cmt_util_opt.py, analysis and plotting,
pickle I/O) exists with the reference signature. NumPy goes in and comes
out, in float64; in between the numbers are computed in torch on the card.

The physics behind ``prop8seis`` is the port's layered-medium forward
(models/layered.py, the Fukuoka six-layer crust by default) instead of host
pyprop8. Its derivative array comes from the ``jacobian`` of
:func:`~waveform_ot_torch.models.layered.make_layered_stages` (stage A
once per call, the depth column from its closed-form tangent, x and y by
forward mode through the Bessel assembly, the moment columns by linearity;
no finite differences), laid out like pyprop8's ((nr, nderiv, nc, nt),
diag-first moment-tensor channel order, receiver-depth z sign), so the
reference's ``drv_rpd2xyz`` chain consumes it unchanged. Each fingerprint
of ``BuildOTobjfromWaveform`` is one launch of the distance-field kernel.

Functions that make tensors take ``device`` (default "cuda"); the
objectives read ``optdata.get("device", "cuda")``, so the user's dicts of
the reference's notebooks work unchanged.

Reference: loc_cmt_util.py:28-702, loc_cmt_util_opt.py:9-12.
"""

from __future__ import annotations

import numpy as np
import torch

from waveform_ot_torch import viz as _viz
from waveform_ot_torch.compat import MargWasserstein, OTpdf, waveformFP
from waveform_ot_torch.inversion.analysis import check_convergence
from waveform_ot_torch.inversion.windows import build_windows as _build_windows
from waveform_ot_torch.models.layered import (
    LayeredModel, fukuoka_model, layered_model_from_table, make_layered_stages,
)
from waveform_ot_torch.models.pyprop8_bridge import _DIAGORDER, _drv_to_cartesian
from waveform_ot_torch.models.seismo import (
    StationSet, moment_tensor_from_sdr, moment_tensor_ls, mxyz_from_upper,
)
from waveform_ot_torch.ops.transforms import arctan_transform
from waveform_ot_torch.utils import io as _io
from waveform_ot_torch.viz import _arr

# -- optimisation-history blackboard (reference loc_cmt_util_opt.py:9-12) ---
# The reference keeps these in a sibling module (loc_cmt_util_opt); here
# they live on the compat module itself, like compat_ricker's Wdata/Wits.
# Notebook code that did ``lo.optdata = optdata`` assigns the module
# attribute instead: ``lc.optdata = optdata``.

opt_history: list = []
opt_history_data: list = []
optdata = []


def init():
    """Reset the history blackboard (reference loc_cmt_util_opt.init)."""
    global opt_history, opt_history_data, optdata
    opt_history, opt_history_data, optdata = [], [], []


# -- forward physics (loc_cmt_util.py:28-58) ---------------------------------

_NM2MOMENT = 1.0e-13  # Nm -> moment argument value (loc_cmt_util.py:29)


class DerivativeSwitches:
    """pyprop8-compatible derivative selector.

    Declares which derivative channels ``prop8seis`` packs into its
    ``(nr, nderiv, nc, nt)`` array and at which indices (``i_x``/``i_y``/
    ``i_z`` or ``i_r``/``i_phi``/``i_z``, plus ``i_mt`` for the six
    diag-first moment-tensor channels): the attribute surface
    ``drv_rpd2xyz`` reads (loc_cmt_util.py:155-158, 360-383).
    """

    def __init__(self, x=False, y=False, z=False, r=False, phi=False,
                 moment_tensor=False, structure=None):
        self.x, self.y, self.z = bool(x), bool(y), bool(z)
        self.r, self.phi = bool(r), bool(phi)
        self.moment_tensor = bool(moment_tensor)
        self.structure = structure
        self.spherical = self.r or self.phi
        self.has_loc = self.spherical or self.x or self.y or self.z
        n = 0
        if self.spherical:
            self.i_r, self.i_phi, self.i_z = 0, 1, 2
            n = 3
        elif self.has_loc:
            self.i_x, self.i_y, self.i_z = 0, 1, 2
            n = 3
        self.i_mt = n
        self.nderiv = n + (6 if self.moment_tensor else 0)


class _Source:
    """Lightweight stand-in for pp.PointSource (the attributes the
    notebooks read: location and ``Mxyz`` with a leading source axis,
    as consumed by ``setmref``)."""

    def __init__(self, x, y, z, Mxyz):
        self.x, self.y, self.z = float(x), float(y), float(z)
        self.Mxyz = _arr(Mxyz)[np.newaxis]


class _Stations:
    """Lightweight stand-in for pp.ListOfReceivers: receiver coordinates
    plus the source-relative range ``rr`` and ccw-from-x azimuth ``pp``
    that ``drv_rpd2xyz`` uses for the spherical chain."""

    def __init__(self, recx, recy, x, y):
        self.xx = np.asarray(recx, float)
        self.yy = np.asarray(recy, float)
        self.nstations = self.xx.size
        dx = self.xx - float(x)
        dy = self.yy - float(y)
        self.rr = np.hypot(dx, dy)
        self.pp = np.arctan2(dy, dx)


def _resolve_model(prop8data, device) -> LayeredModel:
    """prop8data['model'] -> the port's LayeredModel on ``device``: one
    already, a raw layer table (thickness, vp, vs, rho rows), or absent ->
    the Fukuoka six-layer crust of the Figs 9-12 notebooks.
    ``convert.prop8data`` carries a JAX package's model over."""
    model = prop8data.get("model")
    if model is None:
        return fukuoka_model(device=device)
    if isinstance(model, LayeredModel):
        return model.to(device, torch.float64)
    return layered_model_from_table(model, device=device)


def _stations(prop8data, device) -> StationSet:
    arr = lambda k: torch.as_tensor(np.asarray(prop8data[k], float).flatten(),
                                    dtype=torch.float64, device=device)
    return StationSet(x=arr("recx"), y=arr("recy"))


_STAGES: dict = {}


def _jacobian_fn(prop8data, nt, timestep, device):
    """The layered forward and Jacobian (make_layered_stages' ``jacobian``)
    of prop8data's model, at the quadrature it asks for (nk 1024, kmax 2.5
    by default, loc_cmt_util.py:230-232); built once per model, nt, dt,
    quadrature and device."""
    model = prop8data.get("model")
    if isinstance(model, LayeredModel):
        model_key = tuple(tuple(v.tolist()) for v in model)
    else:
        model_key = None if model is None else tuple(map(tuple, np.asarray(model, float)))
    nk, kmax = int(prop8data.get("nk", 1024)), float(prop8data.get("kmax", 2.5))
    key = (model_key, int(nt), float(timestep), nk, kmax, str(torch.device(device)))
    if key not in _STAGES:
        _STAGES[key] = make_layered_stages(model=_resolve_model(prop8data, device), nt=int(nt),
                                           dt=float(timestep), nk=nk, kmax=kmax)
    return _STAGES[key].jacobian


def _assemble_channels(jac, drv, stations):
    """(nr, 9, nc, nt) jacobian in (x, y, z_src, m6-upper) parameter order
    -> the pyprop8 channel layout ``drv`` declares: source-z negated to the
    receiver-depth convention, cartesian optionally rotated to (r, phi)
    using the station geometry (inverting the drv_rpd2xyz chain,
    loc_cmt_util.py:363-373), moment-tensor channels reordered diag-first.
    """
    chans = []
    if drv.spherical:
        dx, dy = jac[:, 0], jac[:, 1]
        cosp = np.cos(stations.pp)
        sinp = np.sin(stations.pp)
        dr = -((dx.T) * cosp + (dy.T) * sinp).T
        dp = ((dx.T) * (sinp * stations.rr)
              - (dy.T) * (cosp * stations.rr)).T
        chans += [dr, dp, -jac[:, 2]]
    elif drv.has_loc:
        chans += [jac[:, 0], jac[:, 1], -jac[:, 2]]
    if drv.moment_tensor:
        # channel j holds d/d(m6[k]) with _DIAGORDER[k] == j
        inv = np.argsort(_DIAGORDER)
        chans += [jac[:, 3 + inv[j]] for j in range(6)]
    return np.stack(chans, axis=1)


def prop8seis(x, y, z, prop8data, Mxyz=None, drv=None, show_progress=True,
              nt=61, timestep=1.0, returndata=False, device="cuda"):
    """Reference-signature seismogram forward (loc_cmt_util.py:28-58) on
    the port's layered-medium physics, on ``device``.

    prop8data keys: 'sdrm' (strike, dip, rake, Mo[Nm]), 'recx'/'recy'
    (receiver coordinates), 'model' (LayeredModel | layer table | None ->
    Fukuoka), optional 'nk'/'kmax' wavenumber-quadrature overrides.
    Returns (t, s[, deriv][, source, stations]) with s shaped (nr, 3, nt)
    and deriv shaped (nr, drv.nderiv, 3, nt) in pyprop8's channel layout.
    A ``drv`` with location channels computes the three location columns,
    one with moment-tensor channels the six moment columns, one with both
    all nine.
    """
    del show_progress  # the layered forward has no progress bar
    strike, dip, rake, Mo = prop8data["sdrm"]
    if Mxyz is None:
        Mxyz = moment_tensor_from_sdr(strike, dip, rake, Mo * _NM2MOMENT, device=device)
    Mxyz = torch.as_tensor(_arr(Mxyz), dtype=torch.float64, device=device)
    recx = np.asarray(prop8data["recx"], float).flatten()
    recy = np.asarray(prop8data["recy"], float).flatten()
    loc, mt = False, False
    if drv is not None:
        loc = drv.has_loc
        mt = drv.moment_tensor or not drv.has_loc
    jacobian = _jacobian_fn(prop8data, nt, timestep, device)
    u, cols = jacobian(float(x), float(y), float(z), Mxyz, _stations(prop8data, device),
                       loc=loc, mt=mt)
    s = _arr(u)
    t = timestep * np.arange(nt)
    out = [t, s]
    if drv is not None:
        # the computed columns at their places in the 9-wide (x, y, z, m6)
        # parameter order _assemble_channels indexes
        jac = np.zeros((s.shape[0], 9) + s.shape[1:])
        jac[:, slice(0 if loc else 3, 9 if mt else 3)] = np.moveaxis(_arr(cols), 0, 1)
        out.append(_assemble_channels(jac, drv, _Stations(recx, recy, x, y)))
    if returndata:
        out += [_Source(x, y, z, Mxyz), _Stations(recx, recy, x, y)]
    return tuple(out)


def misfitfunc(so, sp):
    """L2 misfit between waveform arrays (loc_cmt_util.py:60-62)."""
    r = (_arr(so) - _arr(sp)).flatten()
    return float(np.dot(r, r))


def plotseis(splot, tt, splot0=None, splot1=None, splot2=None, title=None,
             filename="seis.pdf"):
    """Seismogram grid plot (loc_cmt_util.py:64-110), delegating to
    viz.plot_seismograms; accepts 1-D/2-D/3-D arrays like the reference."""

    def _3d(a):
        a = _arr(a)
        if a.ndim == 1:
            return a[np.newaxis, np.newaxis, :]
        if a.ndim == 2:
            return a[np.newaxis, :, :]
        return a

    overlays = [_3d(o) for o in (splot0, splot1, splot2) if o is not None]
    return _viz.plot_seismograms(_3d(splot), tt, overlays=overlays,
                                 filename=filename, title=title)


# -- scipy objectives (loc_cmt_util.py:113-306) ------------------------------


def _model_head(m_in, invopt, precon):
    """Preconditioning, parameter layout and the depth floor shared by the
    L2/OT objectives (loc_cmt_util.py:126-158)."""
    if invopt["precon"] and precon:
        m = np.asarray(m_in, float) * np.asarray(invopt["mscal"], float)
    else:
        m = np.asarray(m_in, float)
    loc, cmt = bool(invopt["loc"]), bool(invopt["cmt"])
    if loc:
        x, y, z = m[:3]
    else:
        x, y, z = np.asarray(invopt["mref"], float).ravel()[:3]
    z = max(z, 0.001)
    Mxyz = None
    if cmt:
        Mxyz = buildMxyzfromupper(m[3:] if loc else m)
    return m, loc, cmt, x, y, z, Mxyz


def _forward_and_modelderiv(x, y, z, Mxyz, prop8data, loc, cmt, geometry, device):
    """One forward + jacobian call; returns (t, seis_pred, derivxyz, d)
    where derivxyz is the (nm, nr, nc, nt) model-derivative array the
    reference's returnseisd/returnderiv paths hand back, and d is its
    (nm, nr*nc*nt) reshape in the (x, y, z[, 6 m6]) row order the
    objectives contract against (loc_cmt_util.py:226-236)."""
    nt = np.shape(prop8data["obs_seis"])[-1]
    timestep = prop8data.get("timestep", 1.0)
    if geometry == "cartesian":
        drv = DerivativeSwitches(x=loc, y=loc, z=loc, moment_tensor=cmt,
                                 structure=prop8data.get("model"))
    else:
        drv = DerivativeSwitches(r=loc, phi=loc, z=loc, moment_tensor=cmt,
                                 structure=prop8data.get("model"))
    t, seis_pred, deriv, _, stations = prop8seis(
        x, y, z, prop8data, Mxyz=Mxyz, drv=drv, show_progress=False,
        nt=nt, timestep=timestep, returndata=True, device=device)
    if loc:
        derivxyz = drv_rpd2xyz(drv, deriv, stations, geometry=geometry)
        nm = 9 if cmt else 3
    else:
        # cmt-only: just the six upper-triangular moment-tensor rows
        derivxyz = np.array([deriv[:, drv.i_mt + _DIAGORDER[k]]
                             for k in range(6)])
        nm = 6
    return t, seis_pred, derivxyz, derivxyz.reshape(nm, -1)


def optfunc(m, optdata, returnseis=False, return2W=False, precon=True):
    """Dispatch to the L2 or OT objective on invopt['mistype']
    (loc_cmt_util.py:113-118)."""
    invopt = optdata["invopt"]
    if invopt["mistype"] == "OT":
        return optfunc_OT(m, optdata, returnseis=returnseis,
                          return2W=return2W, precon=precon)
    if invopt["mistype"] == "L2":
        return optfunc_L2(m, optdata, returnseis=returnseis, precon=precon)
    raise ValueError(f"unknown mistype {invopt['mistype']!r}")


def optfunc_L2(m_in, optdata, returnseis=False, returnseisd=False,
               noderiv=False, geometry="cartesian", precon=True):
    """L2 objective: (misfit, d misfit/dm) via the layered forward and its
    jacobian (loc_cmt_util.py:120-184), on ``optdata.get("device",
    "cuda")``. Appends to ``opt_history_data``."""
    invopt = optdata["invopt"]
    prop8data = optdata["prop8data"]
    seis_obs = _arr(prop8data["obs_seis"])
    if not invopt["loc"] and not invopt["cmt"]:
        return 0.0, np.zeros_like(np.asarray(m_in, float))
    m, loc, cmt, x, y, z, Mxyz = _model_head(m_in, invopt, precon)
    t, seis_pred, derivxyz, d = _forward_and_modelderiv(
        x, y, z, Mxyz, prop8data, loc, cmt, geometry, optdata.get("device", "cuda"))
    dr = (seis_pred - seis_obs).flatten()
    mis = float(np.dot(dr, dr))
    dmis = 2.0 * d.dot(dr)
    opt_history_data.append([mis, m, dmis, seis_pred, Mxyz])
    if returnseis:
        return mis, dmis, t, seis_pred
    if returnseisd:
        # reference returns the 4-D (nm, nr, nc, nt) derivative array here
        # (loc_cmt_util.py:180), not its flattened objective form
        return mis, dmis, t, seis_pred, derivxyz
    if noderiv:
        return mis
    if invopt["precon"] and precon:
        dmis = dmis * np.asarray(invopt["mscal"], float)
    return mis, dmis


def optfunc_OT(m_in, optdata, returnseis=False, returnwobj=False,
               returngrid=False, noderiv=False, returnderiv=False,
               return2W=False, geometry="cartesian", precon=True):
    """Wasserstein objective: forward -> arctan transform -> fingerprints
    -> marginal OT per trace -> chain rule back to the model
    (loc_cmt_util.py:186-306), on ``optdata.get("device", "cuda")``.
    Appends to ``opt_history_data``."""
    OTdata = optdata["OTdata"]
    invopt = optdata["invopt"]
    prop8data = optdata["prop8data"]
    device = optdata.get("device", "cuda")
    seis_obs = _arr(prop8data["obs_seis"])
    if not invopt["loc"] and not invopt["cmt"]:
        return 0.0, np.zeros_like(np.asarray(m_in, float))
    m, loc, cmt, x, y, z, Mxyz = _model_head(m_in, invopt, precon)
    t, seis_pred, derivxyz, d = _forward_and_modelderiv(
        x, y, z, Mxyz, prop8data, loc, cmt, geometry, device)

    nr, nc, ntw = seis_obs.shape
    returnmarg = OTdata["Wopt"] != "Wavg" or return2W
    obs_grids = OTdata["obs_grids"]
    wfobs_target = OTdata["wfobs_target"]
    wfo = OTdata.get("wfobs")

    _, dundu = arctan_trans(seis_pred, obs_grids, deriv=True, device=device)
    wfp, wfpred_source = BuildOTobjfromWaveform(
        t, seis_pred, obs_grids, OTdata, lambdav=OTdata["plambda"],
        deriv=True, theta=OTdata["theta"], device=device)

    mis = 0.0
    if returnmarg:
        misW = np.zeros(2)
        drW = np.zeros((2, nr, nc, ntw))
        dg = np.zeros(2)
        for i in range(nr):
            for j in range(nc):
                w2pl, drl, dgl = CalcWasserWaveform(
                    wfpred_source[i][j], wfobs_target[i][j], wfp[i][j],
                    distfunc=OTdata["distfunc"], deriv=True,
                    returnmarg=True)
                misW += np.asarray(w2pl, float)
                drW[0, i, j, :] = drl[0]
                drW[1, i, j, :] = drl[1]
                dg[:] = np.asarray(dgl, float)  # last trace, as reference
    else:
        drW = np.zeros((nr, nc, ntw))
        for i in range(nr):
            for j in range(nc):
                w2p, drW[i, j, :], dg = CalcWasserWaveform(
                    wfpred_source[i][j], wfobs_target[i][j], wfp[i][j],
                    distfunc=OTdata["distfunc"], deriv=True,
                    returnmarg=False)
                mis += w2p

    if returnmarg:
        drW = drW * dundu[np.newaxis]
        dmis0 = d.dot(drW[0].flatten())
        dmis1 = d.dot(drW[1].flatten())
        if return2W:
            dmis = [dmis0, dmis1]
            mis = misW
        elif OTdata["Wopt"] == "Wt":
            dmis, mis = dmis0, misW[0]
        elif OTdata["Wopt"] == "Wu":
            dmis, mis = dmis1, misW[1]
    else:
        drW = drW * dundu
        dmis = d.dot(drW.flatten())

    opt_history_data.append([mis, m, dmis, seis_pred, Mxyz])
    if returnseis:
        return mis, dmis, t, seis_pred
    if returnwobj:
        return mis, dmis, wfo, wfp, wfpred_source, wfobs_target
    if returngrid:
        return mis, dmis, obs_grids
    if noderiv:
        return mis
    if returnderiv:
        # reference: mis, dmis, derivxyz (nm, nr, nc, nt), dr (the
        # dundu-scaled waveform derivative), loc_cmt_util.py:304
        return mis, dmis, derivxyz, drW
    if invopt["precon"] and precon:
        dmis = dmis * np.asarray(invopt["mscal"], float)
    return mis, dmis


# -- moment-tensor solve / helpers (loc_cmt_util.py:309-396) -----------------


def Moment_LS(xyz, prop8data, device="cuda"):
    """Least-squares moment tensor (upper-triangular 6-vector) at a fixed
    location (loc_cmt_util.py:309-334): models.seismo.moment_tensor_ls on
    the six unit-tensor forwards, which are the moment columns of one
    layered Jacobian call (stage A once)."""
    x, y, z = [float(v) for v in xyz]
    z = max(z, 0.001)
    seis_obs = torch.as_tensor(_arr(prop8data["obs_seis"], float), device=device)
    jacobian = _jacobian_fn(prop8data, seis_obs.shape[-1], prop8data.get("timestep", 1.0),
                            device)
    stations = _stations(prop8data, device)
    _, g = jacobian(x, y, z, torch.zeros(3, 3, dtype=torch.float64, device=device),
                    stations, loc=False, mt=True)             # (6, nr, 3, nt)
    # the seismograms are linear in M: any m6 batch is a combination of g
    forward = lambda m6: (m6[..., None] * g.reshape(6, -1)).sum(-2).reshape(
        m6.shape[:-1] + g.shape[1:])
    return _arr(moment_tensor_ls(torch.as_tensor([x, y, z], dtype=torch.float64,
                                                 device=device),
                                 stations, seis_obs, forward=forward))


def recordresult(x):
    """scipy callback recorder (loc_cmt_util.py:338-350); reads the
    module-level ``optdata``/``opt_history_data`` blackboard."""
    invopt = optdata["invopt"]
    mis = opt_history_data[-1][0]
    Mxyz = opt_history_data[-1][-1]
    index = len(opt_history_data)
    xx = np.asarray(x, float)
    if invopt["precon"]:
        xx = xx * np.asarray(invopt["mscal"], float)
    opt_history.append([xx, mis, index, Mxyz])


def buildMxyzfromupper(vals):
    """Symmetric 3x3 from 6 upper-triangle values (loc_cmt_util.py:352)."""
    return mxyz_from_upper(torch.as_tensor(_arr(vals, float))).numpy()


def BuildMxyz(A):
    """Alias construction of the symmetric tensor (loc_cmt_util.py:385)."""
    return buildMxyzfromupper(A)


def drv_rpd2xyz(drv, deriv, stations, geometry="spherical"):
    """Reorder/rotate derivative seismograms to (x, y, z[, 6 m6]) rows
    (loc_cmt_util.py:360-383), through models.pyprop8_bridge."""
    return _drv_to_cartesian(drv, _arr(deriv), stations, geometry=geometry)


def setmref(invopt, source, mtrue):
    """Reference model assembly for the inversion (loc_cmt_util.py:391)."""
    if invopt["loc"] and invopt["cmt"]:
        return [mtrue[0], mtrue[1], mtrue[2],
                source.Mxyz[0][np.triu_indices(3)]]
    if invopt["loc"]:
        return mtrue
    return source.Mxyz[0][np.triu_indices(3)]


# -- analysis (loc_cmt_util.py:399-446, 667-702) -----------------------------


def checkconverge(solutions, dlimit=1.0, mlimit=None, verbose=False):
    """Convergence classification of repeat inversions
    (loc_cmt_util.py:399-427): converged iff |loc_final - loc_true| <
    dlimit, restricted to starts off the |x|=80 outer square. ``solutions``
    rows are [mstart, mis_start, mfinal, mis_final, mtrue, mis_true]."""
    del mlimit  # the reference hardcodes its misfit condition off
    m_starts = np.array([np.asarray(s[0], float) for s in solutions])
    m_finals = np.array([np.asarray(s[2], float) for s in solutions])
    m_true = np.asarray(solutions[0][4], float)
    conv, dist, considered, frac = check_convergence(
        m_starts, m_finals, m_true, dlimit=dlimit, exclude_edge=80.0)
    con = list(conv & considered)
    gcon = list(considered)
    if verbose:
        for i, s in enumerate(solutions):
            print(i, ":", " start: ", m_starts[i][:3], " mis start ", s[1],
                  " mis final:", s[3], " mfinal", m_finals[i][:3], con[i])
        n = max(int(considered.sum()), 1)
        print("\n", int(np.sum(con)), " of ", float(n), " converged: ",
              100.0 * frac, "%")
    return con, dist, gcon


def buildFingerprintwindows(t, wave, Nu=None, Nt=None, u0=None, u1=None,
                            device="cuda"):
    """Per-trace fingerprint 6-tuples [t0,t1,u0,u1,Nu,Nt]
    (loc_cmt_util.py:430-446): amplitude box = trace range padded by 30%,
    or the fixed limits u0/u1 (inversion.windows.build_windows), Nu =
    1.3*nt by default."""
    wave = torch.as_tensor(_arr(wave, float), device=device)
    nr, nc, ntw = wave.shape
    win = _build_windows(torch.as_tensor(_arr(t, float), device=device), wave,
                         pad=0.3, u0=u0, u1=u1)
    nu_used = int(1.3 * ntw) if Nu is None else int(Nu)
    nt_used = ntw if Nt is None else int(Nt)
    u0a, u1a = _arr(win.u0), _arr(win.u1)
    t0, t1 = float(win.t0), float(win.t1)
    return [[[t0, t1, float(u0a[i, j]), float(u1a[i, j]), nu_used, nt_used]
             for j in range(nc)] for i in range(nr)]


# -- OT objects (loc_cmt_util.py:448-587) -----------------------------------


def BuildOTobjfromWaveform(t, wavein, gridin, OTdata, norm=False,
                           verbose=False, lambdav=None, deriv=False,
                           fpgrid=None, theta=45.0, device="cuda"):
    """(nr, nc) waveforms -> nested lists of (waveformFP, OTpdf)
    (loc_cmt_util.py:448-524): amplitudes are arctan-squashed with the RAW
    grids, fingerprints built on the (0,1) grids OTdata['obs_grids01'],
    one kernel launch per trace."""
    del norm, fpgrid  # reference hardcodes fpgrid=None in this variant
    wavein = _arr(wavein, float)
    if wavein.ndim == 1:
        nr, nc = 1, 1
        wave = wavein[np.newaxis, np.newaxis, :]
        grid = [[list(gridin)]]
    elif wavein.ndim == 3:
        nr, nc, _ = wavein.shape
        wave = wavein
        grid = gridin
    else:
        raise ValueError("waveform must be 1-D or (nr, nc, nt)")
    u = arctan_trans(wave, grid, device=device)
    grid01 = OTdata["obs_grids01"]
    if wavein.ndim == 1 and np.ndim(grid01[0][0]) == 0:
        grid01 = [[list(grid01)]]
    lam = 0.04 if lambdav is None else lambdav
    wflist = [[None] * nc for _ in range(nr)]
    wfolist = [[None] * nc for _ in range(nr)]
    for i in range(nr):
        for j in range(nc):
            wf = waveformFP(_arr(t, float), u[i][j], grid01[i][j], theta=theta,
                            device=device)
            wf.calcpdf(lambdav=lam, deriv=deriv, q=None)
            wflist[i][j] = wf
            wfolist[i][j] = OTpdf((wf.pdf, wf.pos), device)
    if verbose:
        print(" BuildOTobjfromWaveform:", nr, "x", nc, "fingerprints")
    return wflist, wfolist


def CalcWasserWaveform(wfsource, wftarget, wf, distfunc="W2", deriv=False,
                       Nproj=10, returnmarg=False):
    """Marginal Wasserstein + chain rule back to waveform amplitudes and
    window origin time, the loc/CMT variant (loc_cmt_util.py:527-574),
    whose origin-time rescale is 1/(t1-t0) WITHOUT tantheta (unlike
    ricker_util.py:333; see TraceConfig.include_tant_in_dg)."""
    del Nproj  # reference signature artifact (Marginal method only)
    if not deriv:
        out = MargWasserstein(wfsource, wftarget, distfunc=distfunc,
                              returnmargW=returnmarg)
        return out if returnmarg else out[0]
    w, dw, dwg = MargWasserstein(wfsource, wftarget, derivatives=True,
                                 distfunc=distfunc, returnmargW=returnmarg)
    scale = wf.tlim[1] - wf.tlim[0]
    if returnmarg:
        wf.PDFderivMarg(dw)
        return w, wf.pdfdMarg, [dwg[0] / scale, dwg[1] / scale]
    wf.PDFderiv(chainmatrix=dw)
    return w, wf.pdfd, dwg / scale


def arctan_trans(u, grids, deriv=False, device="cuda"):
    """Batched arctan transform with per-trace (u0, u1) from the grid
    lists (loc_cmt_util.py:576-587), one broadcast on ``device``."""
    u = torch.as_tensor(_arr(u, float), device=device)
    nr, nc, _ = u.shape
    g = torch.as_tensor([[grids[i][j][2:4] for j in range(nc)] for i in range(nr)],
                        dtype=torch.float64, device=device)
    out = arctan_transform(u, g[..., 0, None], g[..., 1, None], deriv=deriv)
    if deriv:
        return _arr(out[0]), _arr(out[1])
    return _arr(out)


# -- plotting / persistence / reporting (loc_cmt_util.py:589-702) ------------


def plotmisfitsection(xlim, ylim, xgrid, ygrid, zg, ztrue, sol, misfitgrid,
                      invopt, plotfile, returncontfunc=False):
    """2x2 depth-section misfit figures, one file per entry of
    ``misfitgrid`` (loc_cmt_util.py:589-655), via viz.plot_misfit_sections.
    With ``returncontfunc`` also returns the last figure's four
    interpolated (log-clipped for L2) contour fields."""
    from scipy.interpolate import griddata

    ninterp = 100
    tplot_out = None
    for i, misplot in enumerate(misfitgrid):
        _viz.plot_misfit_sections(misplot, xgrid, ygrid, zg, ztrue, sol=sol,
                                  mistype=invopt["mistype"], ninterp=ninterp,
                                  filename=plotfile[i])
        if returncontfunc:
            X, Y = np.meshgrid(np.linspace(xlim[0], xlim[1], ninterp),
                               np.linspace(ylim[0], ylim[1], ninterp))
            tplot_out = np.zeros((4, ninterp, ninterp))
            for k in range(4):
                ti = griddata((_arr(xgrid).flatten(), _arr(ygrid).flatten()),
                              _arr(misplot[k]).flatten(), (X, Y), method="cubic")
                tplot_out[k] = (ti if invopt["mistype"] == "OT"
                                else np.log(np.clip(ti, 1.0, np.inf)))
    if returncontfunc:
        return tplot_out


def writepickle(filename, listOfStr, listOfdata):
    _io.write_pickle(filename, listOfStr, listOfdata)


def readpickle(filename):
    return _io.read_pickle(filename)


def printanalysis(sol, opt, mtrue, mstart, mis_start, mis_true, prop8data,
                  sdata_nonoise, fit=False, device="cuda"):
    """Solution summary prints (loc_cmt_util.py:667-702): location/CMT
    errors, optionally the best-fit CMT at the true location (with and
    without noise) via Moment_LS on ``device``."""
    print("\n Some analysis of solution: ")
    if not opt.success:
        print("\n Optimisation Failed")
        return
    mis_final = opt.fun
    mfinal = np.asarray(sol, float)[:3]
    Mxyz_true = buildMxyzfromupper(np.asarray(mtrue, float)[3:])
    Mxyz_final = opt_history[-1][3]
    print("\n Model loc start :", np.asarray(mstart, float)[:3],
          "\n Misfit start :", mis_start, "\n Misfit final :", mis_final,
          "\n Misfit true  :", mis_true)
    print("\n Final location = ", mfinal,
          "\n True location = ", np.asarray(mtrue, float)[:3])
    print("\n Start CMT = \n",
          buildMxyzfromupper(np.asarray(mstart, float)[3:]))
    print("\n Final CMT = \n", Mxyz_final)
    print("\n True CMT = \n", Mxyz_true)
    with np.errstate(divide="ignore", invalid="ignore"):
        print("\n % Error in CMT:\n",
              100.0 * (np.asarray(Mxyz_final) - Mxyz_true) / Mxyz_true)
    if fit:
        x, y, z = np.asarray(mtrue, float)[:3]
        m_fit = BuildMxyz(Moment_LS([x, y, z], prop8data, device=device))
        print("\n Best fit CMT using True location = \n", m_fit)
        with np.errstate(divide="ignore", invalid="ignore"):
            print("\n % Error :\n", 100.0 * (m_fit - Mxyz_true) / Mxyz_true)
        p8 = dict(prop8data)
        p8["obs_seis"] = sdata_nonoise
        m_fit2 = BuildMxyz(Moment_LS([x, y, z], p8, device=device))
        print("\n Best fit CMT using True location and noiseless data = \n",
              m_fit2)
        with np.errstate(divide="ignore", invalid="ignore"):
            print("\n % Error :\n", 100.0 * (m_fit2 - Mxyz_true) / Mxyz_true)
