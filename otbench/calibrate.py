"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 -m otbench.calibrate --workload <cell> --seeds 1,2,3 [--control-seeds 4,5,6]
                                 [--units N]

For each seed, at the cell's own sizes: the program's compared numbers over
N units of the cell's traffic (the lower reading is their largest over the
seeds), and for each control seed the control's: the float64 reference put
in the program's place and computed in bfloat16, the nearest precision below
the configuration's float32 that the path would take (TF32 is no step here:
the port's one matrix product runs in float64). For a study the control is
the port's solver driving the bfloat16 reference. The upper reading is the
control's smallest. One JSON line per seed and side, then a summary line.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from otbench import generator, harness
from otbench.reference import Reference


def _outputs(system, cell, seed: int, units: int, device):
    us = [generator.unit(cell.traffic, cell.config, seed, i) for i in range(units)]
    outs = []
    for u in us:
        o = system.run(u)
        harness.sync(device)
        outs.append({k: v.detach().cpu() for k, v in o.items()})
    return us, outs


def readings(cell, seed: int, units: int, device, control: bool) -> dict:
    """The compared numbers of the program (or of the control) at one seed."""
    inputs = harness.make_inputs(cell.config, seed, device)
    from otbench.system import Counted, System, solve
    system = System(cell.config, cell.traffic, inputs, device)
    dtype = system.dtype
    cand = Reference(cell.config, inputs, torch.bfloat16) if control else None
    if cand is not None and cell.traffic["kind"] == "study":
        fun = Counted(lambda ms, ctl=cand: ctl.misfit(ms).to(dtype))
        system.run = lambda u: solve(cell.traffic, fun, system.tensor(u["starts"]))
        cand = None
    us, outs = _outputs(system, cell, seed, units, device)
    del system
    return harness.check(cell, inputs, us, outs, seed, dtype, device, candidate=cand)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--units", type=int, default=None)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    units = args.units or cell.traffic["check"]["units"]
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    rows = {"program": [], "control": []}
    for side, ss in (("program", seeds(args.seeds)), ("control", seeds(args.control_seeds))):
        for seed in ss:
            nums = readings(cell, seed, units, "cuda", side == "control")
            rows[side].append(nums)
            print(json.dumps({"cell": cell.name, "side": side, "seed": seed, **nums}), flush=True)
    keys = sorted({k for r in rows["program"] + rows["control"] for k in r})
    summary = {"cell": cell.name, "summary": True,
               "lower": {k: max((r[k] for r in rows["program"] if k in r), default=None)
                         for k in keys},
               "upper": {k: min((r[k] for r in rows["control"] if k in r), default=None)
                         for k in keys}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
