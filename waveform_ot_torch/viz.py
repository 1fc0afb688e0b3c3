"""Plotting suite (host-side matplotlib; counterpart of waveform_ot_tpu.viz).

Functional equivalents of the reference's plot helpers:
  OTlib.plotWasser / plotOT1D          (OTlib.py:508-572, 1320-1378)
  FingerprintLib.plot_LS / plot_rays /
  plotMarginals / plotPDFsurface       (FingerprintLib.py:627-889)
  ricker_util.plotrickers/plotmisfit/
  plotsurface                          (ricker_util.py:106-201, 428-552)
  loc_cmt_util.plotseis/plotmisfitsection (loc_cmt_util.py:64-110, 589-655)

Every function takes arrays, tensors on any device or NamedTuples of them
(the port's Density1D, DistanceField), and an optional filename; one helper,
:func:`_arr`, brings each to NumPy. Nothing here mutates library state, and
matplotlib is imported lazily, so jobs that import the package without
plotting pay nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from waveform_ot_torch.ops.fmm import signed_indicator


def _arr(a, dtype=None) -> np.ndarray:
    """``a`` as a NumPy array: a tensor on any device is detached and copied
    to the host; anything else goes through np.asarray."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_wasser_panels(source, target, npoints: int = 2000, filename=None):
    """Six-panel CDF / inverse-CDF / transport-map figure (plotWasser)."""
    plt = _plt()
    cf, fx = _arr(source.cdf), _arr(source.x)
    cg, gx = _arr(target.cdf), _arr(target.x)
    t = np.linspace(0, 1, npoints)
    IF = np.interp(t, cf, fx)
    IG = np.interp(t, cg, gx)
    x = np.linspace(min(fx[0], gx[0]), max(fx[-1], gx[-1]), npoints)
    F = np.interp(x, fx, cf)
    IGF = np.interp(F, cg, gx)
    fig, axs = plt.subplots(3, 2, figsize=(9, 10))
    axs[0, 0].plot(fx, cf, "r", label="$F(x)$")
    axs[0, 0].plot(gx, cg, "g", label="$G(x)$")
    axs[0, 0].set_title("CDFs")
    axs[0, 0].legend()
    axs[0, 1].plot(t, IF, "r", label="$F^{-1}$")
    axs[0, 1].plot(t, IG, "g", label="$G^{-1}$")
    axs[0, 1].set_title("Inverse CDFs")
    axs[0, 1].legend()
    axs[1, 0].plot(t, np.abs(IF - IG), "k")
    axs[1, 0].set_ylabel("$|G^{-1}-F^{-1}|$")
    axs[1, 1].plot(t, (IF - IG) ** 2, "m")
    axs[1, 1].set_ylabel("$(G^{-1}-F^{-1})^2$")
    axs[2, 0].plot(x, IGF, "b", label="$G^{-1}(F(x))$")
    axs[2, 0].plot(x, x, "k:")
    axs[2, 0].set_ylabel("T(x)")
    axs[2, 0].legend()
    axs[2, 1].plot(x, (x - IGF) ** 2)
    axs[2, 1].set_ylabel("$(x-T(x))^2$")
    fig.tight_layout()
    if filename:
        fig.savefig(filename)
    return fig


def plot_transport_plan(H, source=None, target=None, filename=None):
    """1-D plan heat map with marginals (reference plotOT1D)."""
    plt = _plt()
    H = _arr(H)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(H, origin="lower", aspect="auto", cmap="cubehelix_r")
    ax.set_xlabel("target index")
    ax.set_ylabel("source index")
    if filename:
        fig.savefig(filename)
    return fig


def plot_fingerprint(field, waveform_verts=None, tgrid=None, ugrid=None,
                     levels: int = 20, filename=None, title=None):
    """Level sets of the distance/density field with the waveform overlaid
    (reference plot_LS, FingerprintLib.py:627-676)."""
    plt = _plt()
    field = _arr(field)
    fig, ax = plt.subplots(figsize=(10, 4))
    extent = None
    if tgrid is not None and ugrid is not None:
        extent = [float(tgrid[0]), float(tgrid[-1]),
                  float(ugrid[0]), float(ugrid[-1])]
    ax.contourf(field, levels, cmap="cubehelix_r",
                extent=extent, origin="lower")
    ax.contour(field, levels, colors="grey", linewidths=0.4,
               extent=extent, origin="lower")
    if waveform_verts is not None:
        v = _arr(waveform_verts)
        ax.plot(v[:, 0], v[:, 1], "k-", lw=1.2)
    if title:
        ax.set_title(title)
    if filename:
        fig.savefig(filename)
    return fig


def plot_rays(fld, verts, tgrid, ugrid, stride: int = 7, filename=None):
    """Rays from grid points to their nearest waveform point
    (reference plot_rays, FingerprintLib.py:714-770)."""
    plt = _plt()
    v = _arr(verts)
    tt, uu = np.meshgrid(_arr(tgrid), _arr(ugrid))
    p = np.stack([tt.ravel(), uu.ravel()], 1)
    ic = _arr(fld.iclose).ravel()
    lam = _arr(fld.lam).ravel()
    xstar = v[:-1][ic] + lam[:, None] * (v[1:] - v[:-1])[ic]
    fig, ax = plt.subplots(figsize=(10, 4))
    for i in range(0, len(p), stride):
        ax.plot([p[i, 0], xstar[i, 0]], [p[i, 1], xstar[i, 1]],
                "c-", lw=0.3)
    ax.plot(v[:, 0], v[:, 1], "k-", lw=1.4)
    if filename:
        fig.savefig(filename)
    return fig


def plot_marginals(pdf2d, tgrid, ugrid, filename_prefix=None):
    """Filled time/amplitude marginal strips (reference plotMarginals)."""
    plt = _plt()
    pdf2d = _arr(pdf2d)
    ft = pdf2d.sum(0)
    fu = pdf2d.sum(1)
    figs = []
    for name, x, f in (("t", _arr(tgrid), ft),
                       ("u", _arr(ugrid), fu)):
        fig = plt.figure(figsize=(9, 1.2))
        plt.plot(x, f)
        plt.fill_between(x, 0, f)
        plt.xlim(x[0], x[-1])
        plt.tick_params(left=False, labelleft=False)
        if filename_prefix:
            fig.savefig(f"{filename_prefix}_marginal_{name}.png", dpi=300)
        figs.append(fig)
    return figs


def plot_transport_frames(source, target, nframes: int = 5, filename=None,
                          weights=None):
    """Displacement-interpolation frames between two 1-D densities (the
    port's Density1D; reference plot_optimal_transform_frames,
    OTlib.py:1380-1424). ``weights`` overrides the uniform linspace of
    interpolation weights."""
    plt = _plt()
    from waveform_ot_torch.ops.barycenter import barycenter_continuous

    w = (np.linspace(0.0, 1.0, nframes) if weights is None
         else _arr(weights, float))
    nframes = w.shape[0]
    path = _arr(barycenter_continuous(source, target, w, npoints=4000))
    fig, axs = plt.subplots(nframes, 1, figsize=(8, 1.6 * nframes),
                            sharex=True, squeeze=False)
    for k in range(nframes):
        x, p = path[k, 0], path[k, 1]
        axs[k, 0].fill_between(x, 0, p, alpha=0.6)
        axs[k, 0].set_ylabel(f"w={w[k]:.2f}")
    fig.tight_layout()
    if filename:
        fig.savefig(filename)
    return fig


def plot_misfit_trace(misfits, second=None, log: bool = True,
                      title="misfit vs iteration", filename=None):
    """Convergence traces (reference plotmisfit, ricker_util.py:428-454)."""
    plt = _plt()
    fig = plt.figure(figsize=(6, 4))
    plotter = plt.semilogy if log else plt.plot
    plotter(_arr(misfits), "co-")
    if second is not None:
        plotter(_arr(second), "rx-")
    plt.title(title)
    plt.xlabel("iteration")
    if filename:
        fig.savefig(filename)
    return fig


def plot_misfit_profiles(x, profiles, labels, xlab="time shift",
                         normalize: bool = True, title=None, filename=None):
    """Overlaid 1-D misfit profiles (the W1/W2-vs-L2 time-shift comparison
    of reference Ricker_Figs_1_7 / paper Fig 1). ``profiles`` is a list of
    same-length arrays; each is optionally normalized to [0, 1] so shapes
    (convexity, secondary minima) compare directly."""
    plt = _plt()
    fig = plt.figure(figsize=(7, 4.5))
    for prof, lab in zip(profiles, labels):
        v = _arr(prof, float)
        if normalize:
            v = (v - v.min()) / max(v.max() - v.min(), 1e-30)
        plt.plot(_arr(x), v, label=lab)
    plt.xlabel(xlab)
    plt.ylabel("misfit" + (" (normalized)" if normalize else ""))
    plt.legend()
    if title:
        plt.title(title)
    if filename:
        fig.savefig(filename)
    return fig


def plot_seismograms(seis, t, overlays=(), filename=None, title=None):
    """(nr, nc, nt) seismogram grid, nc <= 3 components (reference plotseis,
    loc_cmt_util.py:64-110)."""
    plt = _plt()
    s, t = _arr(seis), _arr(t)
    if s.ndim == 2:
        s = s[None]
    nr, nc = s.shape[:2]
    fig, axs = plt.subplots(nr, nc, figsize=(4 * nc, 1.0 + 1.5 * nr),
                            sharex=True, squeeze=False)
    labels = ["North", "East", "Vertical"]
    colors = ["b", "r", "g"]
    for i in range(nr):
        for j in range(nc):
            if i == 0:
                axs[0, j].set_title(labels[j])
            for ov in overlays:
                o = _arr(ov)
                if o.ndim == 2:
                    o = o[None]
                axs[i, j].plot(t, o[i, j], "k--", lw=0.8, alpha=0.6)
            axs[i, j].plot(t, s[i, j], color=colors[j])
    if title:
        fig.suptitle(title, y=1.02)
    fig.tight_layout()
    if filename:
        fig.savefig(filename)
    return fig


def plot_misfit_surface(values, x, y, xtrue=None, ytrue=None, filename=None,
                        xlab="x", ylab="y"):
    """3-D shaded misfit surface (reference plotsurface,
    ricker_util.py:162-200)."""
    plt = _plt()
    from matplotlib import cm
    from matplotlib.colors import LightSource

    xv, yv = np.meshgrid(_arr(x), _arr(y))
    z = _arr(values)
    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(projection="3d")
    ls = LightSource(315, 25)
    ax.view_init(azim=-45.0, elev=55)
    ax.plot_surface(xv, yv, z, rstride=1, cstride=1, linewidth=0,
                    antialiased=True,
                    facecolors=ls.shade(z, cmap=cm.cubehelix_r,
                                        blend_mode="soft"))
    if xtrue is not None:
        ax.plot([float(xtrue)], [float(ytrue)], [z.max()], "r^")
    ax.set_xlabel(xlab)
    ax.set_ylabel(ylab)
    ax.set_zlabel("waveform misfit")
    if filename:
        fig.savefig(filename, dpi=300)
    return fig


def plot_density_surface(pdf2d, tgrid, ugrid, ridge_t=None, ridge_u=None,
                         elev: float = 75, azim: float = -134,
                         cmap="cubehelix_r", filename=None):
    """3-D shaded surface of the fingerprint density with the waveform
    drawn as a white ridge line (reference plotPDFsurface,
    FingerprintLib.py:642-663)."""
    plt = _plt()
    from matplotlib.colors import LightSource

    pdf2d = _arr(pdf2d)
    X, Y = np.meshgrid(_arr(tgrid), _arr(ugrid))
    mycmap = plt.get_cmap(cmap) if isinstance(cmap, str) else cmap
    fig = plt.figure(figsize=(12, 12))
    ax = fig.add_subplot(projection="3d")
    ls = LightSource(azdeg=40, altdeg=45)
    ax.view_init(elev=elev, azim=azim)
    ax.plot_surface(X, Y, pdf2d, antialiased=False, rstride=2, cstride=2,
                    cmap=mycmap, facecolors=ls.shade(pdf2d, cmap=mycmap))
    if ridge_t is not None and ridge_u is not None:
        ax.plot(_arr(ridge_t), _arr(ridge_u),
                np.ones(len(_arr(ridge_t))), lw=1.0, color="w",
                zorder=99)
    ax.set_xlabel("Time, t")
    ax.set_ylabel("Waveform amplitude, u")
    ax.set_zlabel("PDF amplitude")
    ax.set_title(r"PDF = $e^{-|d(u,t)|/\lambda}$")
    if filename:
        fig.savefig(filename)
    return fig


def plot_phi(t, waveform, tgrid, ugrid, phi=None, filename=None):
    """Zero contour of the signed FMM indicator field with the waveform
    overlaid (reference plot_phi, FingerprintLib.py:664-676). phi defaults
    to the fast-marching seed field of the waveform on the grid."""
    plt = _plt()
    if phi is None:
        phi = signed_indicator(t, waveform, tgrid, ugrid)
    phi = _arr(phi)
    X, Y = np.meshgrid(_arr(tgrid), _arr(ugrid))
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.contour(X, Y, phi, [0], linewidths=1, colors="grey")
    ax.contourf(X, Y, phi, [-1, 0, 1], colors=["lightgray", "powderblue"])
    ax.plot(_arr(t), _arr(waveform), "-", color="green", lw=0.5)
    ax.set_title("Zero contour of $d(u,t)$")
    ax.set_xlabel("t")
    ax.set_ylabel("u")
    if filename:
        fig.savefig(filename)
    return fig


def plot_rays_discrete(darg, verts, tgrid, ugrid, points=None, phi=None,
                       filename=None, title="discrete rays"):
    """Rays from grid points to their nearest DISCRETE waveform vertex
    (reference plot_rays_discrete, FingerprintLib.py:677-713, which draws
    rays to nearest-neighbour point indices rather than the continuous
    closest point of plot_rays).

    darg: (nu, ntg) or flat indices of the nearest vertex per grid point
    (e.g. from ops.fingerprint.nearest_vertex);
    points: optional list of (iu, it) grid points to draw (default: a
    coarse stride over the grid); phi: optional indicator to contour.
    """
    plt = _plt()
    v = _arr(verts)
    tg = _arr(tgrid)
    ug = _arr(ugrid)
    darg = _arr(darg).reshape(len(ug), len(tg))
    fig, ax = plt.subplots(figsize=(9, 9))
    ax.set_aspect("equal")
    X, Y = np.meshgrid(tg, ug)
    if phi is not None:
        ax.contour(X, Y, _arr(phi), [0], linewidths=1, colors="grey")
    if points is None:
        points = [(i, j) for i in range(0, len(ug), max(1, len(ug) // 8))
                  for j in range(0, len(tg), max(1, len(tg) // 8))]
    for (i, j) in points:
        k = int(darg[i, j])
        ax.plot([X[i, j], v[k, 0]], [Y[i, j], v[k, 1]], "b-", lw=0.5)
    ax.plot(v[:, 0], v[:, 1], "-", color="green", lw=0.7)
    ax.plot(v[:, 0], v[:, 1], "o", markersize=2.0, color="tab:blue")
    ax.set_title(title)
    ax.set_xlabel("t")
    ax.set_ylabel("u")
    if filename:
        fig.savefig(filename)
    return fig


def plot_two_fingerprints(field1, verts1, field2, verts2, titles=("", ""),
                          levels: int = 30, filename=None):
    """Side-by-side contour panels of two fingerprint fields with their
    waveforms (reference plot_2LS, FingerprintLib.py:788-830)."""
    plt = _plt()
    fig, axs = plt.subplots(1, 2, figsize=(14, 7))
    for ax, field, verts, title in zip(axs, (field1, field2),
                                       (verts1, verts2), titles):
        f = _arr(field)
        v = _arr(verts)
        ax.plot(v[:, 0], v[:, 1], "-", color="black")
        ny, nx = f.shape
        X, Y = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny))
        ax.contour(X, Y, f, levels, linewidths=0.5, colors="grey")
        ax.set_title(title)
        ax.set_xlabel("t")
        ax.set_ylabel("u")
    if filename:
        fig.savefig(filename)
    return fig


def plot_rickers(t1, w1, t2, w2, tlim=None, ulim=None,
                 title="Ricker Wavelets", filename=None):
    """Predicted-vs-observed wavelet pair (reference plotrickers,
    ricker_util.py:106-131)."""
    plt = _plt()
    t1, w1, t2, w2 = map(_arr, (t1, w1, t2, w2))
    fig = plt.figure(figsize=(10, 4))
    plt.title(title)
    plt.xlabel("t")
    plt.plot(t1, w1, label="Predicted")
    plt.plot(t2, w2, label="Observed")
    plt.legend()
    if tlim is not None:
        plt.xlim(*tlim)
    if ulim is not None:
        plt.ylim(*ulim)
    plt.plot([min(t1[0], t2[0]), max(t1[-1], t2[-1])], [0.0, 0.0],
             "k-", lw=0.5)
    if filename:
        fig.savefig(filename)
    return fig


def plot_waveform_fit(tobs, wobs, tpred, wpred, misfits, it: int,
                      second=None, second_label="L2 distance",
                      xlim=None, ylim=None, title="Waveform fit",
                      filename=None):
    """Iteration fit-evolution panel: waveform fit + misfit-reduction
    trace(s) with the current iterate marked (reference plotwfit /
    plotwfit_3panels, ricker_util.py:456-508). Passing ``second`` adds the
    reference's third panel (e.g. the L2 trace alongside W)."""
    plt = _plt()
    misfits, it = _arr(misfits), int(it)
    rows = 2 if second is not None else 1
    fig = plt.figure(figsize=(14, 4 * rows))
    ax1 = plt.subplot2grid((rows, 3), (0, 0), colspan=2, rowspan=rows)
    ax1.set_title(title)
    ax1.set_xlabel("Time")
    ax1.plot(_arr(tpred), _arr(wpred), label="Synthetic")
    ax1.plot(_arr(tobs), _arr(wobs), label="Observed")
    ax1.legend()
    if xlim is not None:
        ax1.set_xlim(*xlim)
    if ylim is not None:
        ax1.set_ylim(*ylim)
    ax1.axhline(0.0, color="k", ls=":", lw=0.5)

    ax2 = plt.subplot2grid((rows, 3), (0, 2))
    ax2.set_title("Misfit reduction")
    ax2.set_ylabel("Wasserstein distance")
    ax2.semilogy(misfits, "w-")
    ax2.semilogy(misfits[: it + 1], "c-")
    ax2.semilogy(it, misfits[it], "ro")
    ax2.set_xlabel("Iteration")
    if second is not None:
        second = _arr(second)
        ax3 = plt.subplot2grid((rows, 3), (1, 2))
        ax3.set_title("Misfit reduction")
        ax3.set_ylabel(second_label)
        ax3.plot(second, "w-")
        ax3.plot(second[: it + 1], "c-")
        ax3.plot(it, second[it], "ro")
        ax3.set_xlabel("Iteration")
    fig.tight_layout()
    if filename:
        fig.savefig(filename)
    return fig


def plot_misfit_sections(misfit_slices, xgrid, ygrid, zg, ztrue, sol=None,
                         mistype: str = "OT", ninterp: int = 100,
                         filename=None):
    """The full 2x2 depth-section misfit figure (reference
    plotmisfitsection, loc_cmt_util.py:589-655): one interpolated contour
    panel per depth slice, log-clipped for L2 like the reference, the
    source at the origin and the solution marked in the last panel.

    misfit_slices: (4, ...) misfit values per depth, each over (xgrid,
    ygrid) nodes; zg: the four depths; ztrue: true source depth.
    """
    plt = _plt()
    from scipy.interpolate import griddata

    xg = _arr(xgrid).ravel()
    yg = _arr(ygrid).ravel()
    X, Y = np.meshgrid(np.linspace(xg.min(), xg.max(), ninterp),
                       np.linspace(yg.min(), yg.max(), ninterp))
    fig = plt.figure(figsize=(16, 12))
    name = ("Wasserstein" if mistype == "OT" else "L2-norm")
    fig.suptitle(f"Contours of {name} misfit function between seismograms "
                 "as a function of source position", fontsize=16)
    for k in range(4):
        ax = fig.add_subplot(2, 2, k + 1)
        Ti = griddata((xg, yg), _arr(misfit_slices[k]).ravel(),
                      (X, Y), method="cubic")
        Tplot = Ti if mistype == "OT" else np.log(np.clip(Ti, 1.0, np.inf))
        ax.contour(X, Y, Tplot, 30, cmap="cubehelix_r")
        cs = ax.contourf(X, Y, Tplot, 30, cmap="cubehelix_r")
        ax.set_title(f"Misfit at z={float(zg[k]):4.1f} km with source at "
                     f"{float(ztrue):4.1f} km depth")
        ax.plot(0.0, 0.0, "ko", markersize=4.0)
        if k == 3 and sol is not None:
            ax.plot(*_arr(sol)[:2], "co", markersize=4.0)
        fig.colorbar(cs, ax=ax)
    if filename:
        fig.savefig(filename)
    return fig


def plot_misfit_section(values, xgrid, ygrid, ninterp: int = 100,
                        sol=None, filename=None, title=None):
    """Interpolated misfit contour section (reference plotmisfitsection,
    loc_cmt_util.py:589-655, one panel)."""
    plt = _plt()
    from scipy.interpolate import griddata

    xg = _arr(xgrid).ravel()
    yg = _arr(ygrid).ravel()
    X, Y = np.meshgrid(np.linspace(xg.min(), xg.max(), ninterp),
                       np.linspace(yg.min(), yg.max(), ninterp))
    Ti = griddata((xg, yg), _arr(values).ravel(), (X, Y),
                  method="cubic")
    fig, ax = plt.subplots(figsize=(8, 6))
    cs = ax.contourf(X, Y, Ti, 30, cmap="cubehelix_r")
    ax.contour(X, Y, Ti, 30, colors="k", linewidths=0.2)
    fig.colorbar(cs)
    ax.plot(0.0, 0.0, "ko", markersize=4)
    if sol is not None:
        ax.plot(*_arr(sol)[:2], "co", markersize=5)
    if title:
        ax.set_title(title)
    if filename:
        fig.savefig(filename)
    return fig
