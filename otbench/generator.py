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
         Location only: a configuration that inverts the moment tensor too
         has no scan.
  study  starts: how many; start_spread_km: each start is the true source
         plus uniform(+-spread) in x, y and z; solver: "device" (the
         default: the on-device batched L-BFGS, minimize_multi_start) or
         "host" (minimize_lbfgs_batched_host, which also takes ls_max);
         max_iter and tol of either.
  calls  spread_km: the model is the true source plus uniform(+-spread).

The configuration's ``invert`` gives the parameters of a model (``LAYOUTS``):
"loc" (the default), the location (x, y, z), or "loc_cmt", the location and
the six upper components (Mxx, Mxy, Mxz, Myy, Myz, Mzz) of the moment tensor.
For "loc_cmt" a study's starts and a call's model take, after the location
and from the same stream, each component of the true moment tensor (from
``strike_dip_rake_deg`` and ``m0``) times 1 + uniform(+-mt_spread), a key of
the mix. Where the configuration gives ``mscal``, the preconditioner of the
parameters, a model is handed over divided by it, as the solver sees it.

Every mix also gives ``trace_seconds`` (the traced window of a ``--trace 1``
run) and ``check`` (how many units, and points of each, the reference
compares after the window).
"""

from __future__ import annotations

import numpy as np

from otbench.reference import moment_tensor_from_sdr

WINDOW, WARM = 0, 1
LAYOUTS = {"loc": 3, "loc_cmt": 9}
SOLVERS = ("device", "host")


def _axis(spec) -> np.ndarray:
    lo, hi, n = spec
    return np.linspace(lo, hi, int(n))


def n_params(config: dict) -> int:
    """The number of parameters of one model under the configuration's
    ``invert``."""
    invert = config.get("invert", "loc")
    if invert not in LAYOUTS:
        raise ValueError(f"unknown invert {invert!r}: one of {sorted(LAYOUTS)}")
    return LAYOUTS[invert]


def solver(traffic: dict) -> str:
    """The study's solver: "device" (the default) or "host"."""
    name = traffic.get("solver", "device")
    if name not in SOLVERS:
        raise ValueError(f"unknown solver {name!r}: one of {list(SOLVERS)}")
    return name


def true_moment_upper(config: dict) -> np.ndarray:
    """The six upper components of the configuration's true moment tensor."""
    m = moment_tensor_from_sdr(*config["strike_dip_rake_deg"], m0=config["m0"],
                               device="cpu").numpy()
    return m[np.triu_indices(3)]


def _models(loc: np.ndarray, traffic: dict, config: dict, rng) -> np.ndarray:
    """Locations (k, 3) as models of the configuration's layout: for
    "loc_cmt" with their moment tensors drawn after them, and divided by
    ``mscal`` where the configuration gives one."""
    if n_params(config) == 9:
        s = traffic["mt_spread"]
        mt = true_moment_upper(config) * (1.0 + rng.uniform(-s, s, (loc.shape[0], 6)))
        loc = np.concatenate([loc, mt], 1)
    if config.get("mscal") is not None:
        loc = loc / np.asarray(config["mscal"], dtype=np.float64)
    return loc


def unit(traffic: dict, config: dict, seed: int, index: int, stream: int = WINDOW) -> dict:
    """Inputs of unit ``index`` (host float64 arrays)."""
    rng = np.random.default_rng([seed % 2 ** 64, stream, index])
    loc = np.asarray(config["source_km"], dtype=np.float64)
    kind = traffic["kind"]
    if kind == "scan":
        if n_params(config) != 3:
            raise ValueError(f"a scan evaluates location only; configuration "
                             f"{config.get('name')!r} inverts {config['invert']!r}")
        j = traffic["centre_jitter_km"]
        cx, cy = loc[:2] + rng.uniform(-j, j, 2)
        x, y, z = cx + _axis(traffic["x_km"]), cy + _axis(traffic["y_km"]), _axis(traffic["z_km"])
        zz, xx, yy = np.meshgrid(z, x, y, indexing="ij")
        return {"x": x, "y": y, "z": z,
                "nodes": np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)}
    if kind == "study":
        s = traffic["start_spread_km"]
        starts = loc + rng.uniform(-s, s, (int(traffic["starts"]), 3))
        return {"starts": _models(starts, traffic, config, rng)}
    if kind == "calls":
        s = traffic["spread_km"]
        return {"m": _models((loc + rng.uniform(-s, s, 3))[None], traffic, config, rng)[0]}
    raise ValueError(f"unknown traffic kind {kind!r}")


def models_per_unit(traffic: dict) -> int:
    """Source models evaluated with their gradient by one unit."""
    if traffic["kind"] == "scan":
        return int(np.prod([traffic[k][2] for k in ("x_km", "y_km", "z_km")]))
    if traffic["kind"] == "calls":
        return 1
    raise ValueError(f"a {traffic['kind']} unit has no fixed count of models")
