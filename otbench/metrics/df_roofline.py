"""df_roofline: the distance-field kernel's share of its least time on the
cell's shapes (otbench.roofline), from its summed device time in the
traced window over the window's scans, in %. One kernel launch per scan
evaluates every node's traces at once."""

from otbench.roofline import kernel_bound_s
from otbench.generator import models_per_unit

KERNEL = "distance_field_kernel"


def read(run):
    s = run.summary
    if s is None or not run.latencies_s:
        return None
    kernel_s = sum(v for k, v in s.device_s.items() if KERNEL in k)
    if kernel_s <= 0:
        return None
    c = run.cell.config
    traces = models_per_unit(run.cell.traffic) * c["stations"] * 3
    bound = kernel_bound_s(traces, c["nt"], c["nu"], c["ntg"], c["dtype"])
    return 100.0 * bound * len(run.latencies_s) / kernel_s
