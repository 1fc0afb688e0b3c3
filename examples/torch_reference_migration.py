"""Drop-in migration walkthrough on the PyTorch port: reference calling code
on ``waveform_ot_torch.compat``.

The port's counterpart of examples/reference_migration.py (lines 27-91).
Every call is written the way msambridge/waveform-ot users write it (the
OTlib / FingerprintLib class API) and computes in torch on ``--device``. It
reproduces the reference's own N-version self-test (OTlib.py:1428-1593) with
the same seed: the closed-form ``wasser`` against numerical integration,
linear programming, the Monge two-pointer and Sinkhorn, then a fingerprint +
marginal-Wasserstein pass as in the FingerprintLib demo, whose two 40x120
``calcpdf`` calls each launch the distance-field kernel once on the card.
Float64 throughout; the assertions are the JAX script's.

Run: python examples/torch_reference_migration.py [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))

import numpy as np

from waveform_ot_torch import compat
from waveform_ot_torch.ops.validate import monge_1d

SEED, N = 61254557, 10  # the reference's __main__ seed


def run(device="cuda") -> dict:
    """The self-test and the fingerprint pass on ``device``; asserts the
    JAX script's bounds and returns the values it prints."""
    rng = np.random.default_rng(SEED)
    f = rng.random(N)
    g = rng.random(N)
    x = np.linspace(0.0, 1.0, N)

    # --- reference calling convention: OTpdf + wasser ------------------------
    source = compat.OTpdf((f, x), device)
    target = compat.OTpdf((g, x), device)
    w1, _, _, w2, _, _ = compat.wasser(source, target, "W12", derivatives=True)

    # --- five independent solvers must agree (OTlib.py:1504-1593) ------------
    w1n, w2n = compat.wasserNumInt(source, target)
    wlp, _ = compat.Wasser_LinProg(source, target, distfunc="W2")
    _, c = monge_1d(f, g)
    ws, _ = compat.Sinkhorn_MS(source, target, gamma=2e-3, maxiters=800)
    tol = 1e-5
    assert abs(wlp - c) < 1e-8
    assert abs(w1n - w1) < 5e-4 and abs(w2n - w2) < 5e-4
    assert abs(wlp - w2) < tol and abs(c - w2) < tol
    assert abs(ws - w2) < 5e-3

    # transport plan consistency: marginals of H are the input pdfs
    hp = compat.wasser(source, target, "W2", returnplan=True)[-1]
    assert np.abs(hp.sum(1) - source.pdf).max() < 1e-6
    assert np.abs(hp.sum(0) - target.pdf).max() < 1e-6

    # --- fingerprint demo: waveformFP + MargWasserstein ----------------------
    t = np.linspace(0.0, 6.0, 120)
    wave_obs = np.sin(3 * t) * np.exp(-0.3 * t)
    wave_pred = np.sin(3 * (t - 0.15)) * np.exp(-0.3 * t)
    grid = (t[0], t[-1], -1.4, 1.4, 40, len(t))

    def build(wv):
        wf = compat.waveformFP(t, wv, grid, device=device)
        wf.calcpdf(lambdav=0.04, q=None)
        return compat.OTpdf((wf.pdf, wf.pos), device)

    ot_pred, ot_obs = build(wave_pred), build(wave_obs)
    wvals, dw, _ = compat.MargWasserstein(ot_pred, ot_obs, distfunc="W2", derivatives=True,
                                          returnmargW=True)
    assert wvals[0] > 0 and np.all(np.isfinite(dw[0]))
    sw = compat.SlicedWasserstein(ot_pred, ot_obs, 8, distfunc="W2")
    return {"w1": w1, "w2": w2, "w1_numint": w1n, "w2_numint": w2n, "w2_linprog": wlp,
            "w2_monge": c, "w2_sinkhorn": ws, "plan": hp, "marg_w": np.asarray(wvals),
            "dw_shape": np.shape(dw[0]), "sliced": float(sw[0])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    r = run(ap.parse_args().device)
    print(f"wasser:        W1 = {r['w1']:.8f}   W2^2 = {r['w2']:.8f}")
    print(f"wasserNumInt:  W1 = {r['w1_numint']:.8f}   W2^2 = {r['w2_numint']:.8f}")
    print(f"Wasser_LinProg:              W2^2 = {r['w2_linprog']:.8f}")
    print(f"Monge 2-ptr:                 W2^2 = {r['w2_monge']:.8f}")
    print(f"Sinkhorn_MS:                 W2^2 = {r['w2_sinkhorn']:.8f} (entropic)")
    print("plan marginals OK")
    print(f"MargWasserstein: Wt = {r['marg_w'][0]:.6e}  Wu = {r['marg_w'][1]:.6e}  "
          f"dW/d(density) shape {r['dw_shape']}")
    print(f"SlicedWasserstein(8): {r['sliced']:.6e}")
    print("OK - reference calling code runs unchanged on the port")


if __name__ == "__main__":
    main()
