"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``) and
the seed give every unit of work its inputs.

A unit is what a user waits for before sending the next (the loop is
closed): a scan of a grid of source locations, a multi-start study, or one
call. Unit ``i`` of a run with seed ``s`` draws from its own stream,
``default_rng([s, 0, i])``, so no two units share inputs and a run's units
do not depend on how many came before; the warm-up unit draws from
``[s, 1, 0]``. Every seed gets the same sizes; only positions move.

Kinds and their keys (lengths in km, relative to the configuration's true
source):

  scan   x_km, y_km, z_km: [start, stop, count] axes; centre_jitter_km: the
         grid's (x, y) centre is the true epicentre plus uniform(+-jitter).
         Nodes are meshgrid(z, x, y, indexing="ij"): (count_z*count_x*count_y, 3).
  study  starts: how many; start_spread_km: each start is the true source
         plus uniform(+-spread) in x, y and z; max_iter and tol of the
         on-device batched L-BFGS (minimize_multi_start).
  calls  spread_km: the model is the true source plus uniform(+-spread).

Every mix also gives ``trace_seconds`` (the traced window of a ``--trace 1``
run) and ``check`` (how many units, and points of each, the reference
compares after the window).
"""

from __future__ import annotations

import numpy as np

WINDOW, WARM = 0, 1


def _axis(spec) -> np.ndarray:
    lo, hi, n = spec
    return np.linspace(lo, hi, int(n))


def unit(traffic: dict, config: dict, seed: int, index: int, stream: int = WINDOW) -> dict:
    """Inputs of unit ``index`` (host float64 arrays)."""
    rng = np.random.default_rng([seed % 2 ** 64, stream, index])
    loc = np.asarray(config["source_km"], dtype=np.float64)
    kind = traffic["kind"]
    if kind == "scan":
        j = traffic["centre_jitter_km"]
        cx, cy = loc[:2] + rng.uniform(-j, j, 2)
        x, y, z = cx + _axis(traffic["x_km"]), cy + _axis(traffic["y_km"]), _axis(traffic["z_km"])
        zz, xx, yy = np.meshgrid(z, x, y, indexing="ij")
        return {"x": x, "y": y, "z": z,
                "nodes": np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)}
    if kind == "study":
        s = traffic["start_spread_km"]
        return {"starts": loc + rng.uniform(-s, s, (int(traffic["starts"]), 3))}
    if kind == "calls":
        s = traffic["spread_km"]
        return {"m": loc + rng.uniform(-s, s, 3)}
    raise ValueError(f"unknown traffic kind {kind!r}")


def models_per_unit(traffic: dict) -> int:
    """Source models evaluated with their gradient by one unit."""
    if traffic["kind"] == "scan":
        return int(np.prod([traffic[k][2] for k in ("x_km", "y_km", "z_km")]))
    if traffic["kind"] == "calls":
        return 1
    raise ValueError(f"a {traffic['kind']} unit has no fixed count of models")
